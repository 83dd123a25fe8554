"""The port's parallel layer on gloo ranks on the CPU: the process-group
mesh and launcher (``parallel/{mesh,distributed}.py``), the sharded flat
engine (``parallel/sharded_ba.py``) and sharded pose refinement
(``parallel/sharded_pose.py``), against JAX's sharded solves and the
port's single-device ones.

The flat problem of tests/test_sharding.py (10 cameras, 400 points, seed
31, perturbed with seed 32, exact observations, f64), carried across from
JAX's packing.  "exact": JAX's config (25 LM iterations, to the noiseless
optimum), points and tvecs to atol 1e-6 and the reprojection RMSE below
1e-5 px, as JAX's test holds them; "noisy": 0.5 px noise, three LM steps
of 8 CG iterations, equal ``accepted``, ``iter_num`` and ``cg_iters`` and the loss to rtol
1e-8.  World 2 against JAX's ``ba_solve_sharded`` on a 2-device mesh,
world 4 against the single-device ``ba_solve``, world 1 bit-equal to it.
Pose: the tracking scene of tests/test_sharding.py (16 frames, seed 121),
worlds 2 and 4 against ``refine_poses`` to atol 1e-9 (JAX's test), world 2
against JAX's ``refine_poses_sharded``.  Every rank's outputs are
bit-equal (``_torch_shard_ref.run_ranks``); a divergent rank and a missed
deadline fail the launch instead of hanging it.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields, to_np
from _torch_shard_ref import FLAT, POSE, rank_mesh, run_ranks

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.parallel.mesh import make_mesh as j_make_mesh
from tpu3drecon.parallel.sharded_ba import ba_solve_sharded as j_sharded
from tpu3drecon.parallel.sharded_pose import refine_poses_sharded as j_pose_sharded
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.lm_core import LMConfig as JLMConfig

from tpu3drecon_torch.parallel import distributed
from tpu3drecon_torch.parallel.mesh import Mesh, shard_ba_problem
from tpu3drecon_torch.problems.convert import ba_problem_from_numpy, pose_problem_from_numpy
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig
from tpu3drecon_torch.solvers.bundle_adjust import ba_solve, reprojection_rmse
from tpu3drecon_torch.solvers.lm_core import LMConfig as TLMConfig
from tpu3drecon_torch.solvers.pose_refine import refine_poses

CONFIG = dict(maxiter=25, gtol=1e-12, cg_maxiter=100, cg_rtol=1e-8)
# The trajectory config of the port's tests (8 CG iterations at rtol
# 1e-4): at JAX's rtol 1e-8 the CG count of a step sits on its stopping
# threshold, where the all-reduce order moves it.
NOISY = dict(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
CASES = {"exact": ("exact", CONFIG), "noisy": ("noisy", NOISY)}
POSE_CONFIG = dict(maxiter=50, gtol=1e-12)


@pytest.fixture(scope="module")
def problems():
    scene = j_syn.make_scene(n_cameras=10, n_points=400, seed=31)
    out = {}
    for name, noise in (("exact", 0.0), ("noisy", 0.5)):
        noisy = j_syn.perturb_scene(scene, seed=32, point2d_noise=noise)
        flat, _ = j_syn.scene_to_ba_problem(
            noisy, observed=scene if noise == 0.0 else noisy, dtype=jnp.float64)
        out[name] = (flat, ba_problem_from_numpy(np_fields(flat), device="cpu"))
    scene = j_syn.make_scene(n_cameras=16, n_points=300, obs_per_camera=150, seed=121)
    noisy = j_syn.perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=0.0,
        point2d_noise=0.0, seed=122,
    )
    pose, _ = j_syn.scene_to_pose_problem(noisy, observed=scene, dtype=jnp.float64)
    out["pose"] = (pose, pose_problem_from_numpy(np_fields(pose), device="cpu"))
    return out


@pytest.fixture(scope="module")
def sharded(problems):
    """world -> id -> rank 0's result (flat cases, then "pose")."""
    out = {}
    for world in (2, 4):
        calls = [(FLAT, (problems[s][1], TConfig(**cfg)), {}) for s, cfg in CASES.values()]
        calls.append((POSE, (problems["pose"][1],), dict(config=TLMConfig(**POSE_CONFIG))))
        out[world] = dict(zip(list(CASES) + ["pose"], run_ranks(world, calls)))
    return out


def _close(port, ref, case, flat=None):
    cams, pts, state = port
    rcams, rpts, rstate = ref
    if case == "noisy":
        assert int(state.iter_num) == int(rstate.iter_num)
        assert int(state.accepted) == int(rstate.accepted)
        assert int(state.cg_iters) == int(rstate.cg_iters)
        np.testing.assert_allclose(float(state.loss), float(rstate.loss), rtol=1e-8)
        return
    np.testing.assert_allclose(to_np(pts), to_np(rpts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(cams.tvecs), to_np(rcams.tvecs), rtol=0, atol=1e-6)
    solved = torch.from_numpy(np.asarray(to_np(pts)))
    cams_t = type(flat.cameras)(**{n: torch.from_numpy(np.asarray(to_np(getattr(cams, n))))
                                   for n in ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")})
    assert float(reprojection_rmse(flat, cams_t, solved)) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_jax_sharded(problems, sharded, case):
    scene, cfg = CASES[case]
    ref = j_sharded(problems[scene][0], JConfig(**cfg), mesh=j_make_mesh(2))
    _close(sharded[2][case], ref, case, problems[scene][1])


@pytest.mark.parametrize("case", list(CASES))
def test_world4_matches_single_device(problems, sharded, case):
    scene, cfg = CASES[case]
    flat = problems[scene][1]
    _close(sharded[4][case], ba_solve(flat, TConfig(**cfg), device="cpu"), case, flat)


def test_world1_bit_exact(problems):
    flat = problems["noisy"][1]
    cfg = TConfig(**NOISY)
    (cams, pts, state), = run_ranks(1, [(FLAT, (flat, cfg), {})])
    cams1, pts1, state1 = ba_solve(flat, cfg, device="cpu")
    assert np.array_equal(pts, pts1.numpy())
    assert np.array_equal(cams.rmats, cams1.rmats.numpy())
    assert np.array_equal(cams.tvecs, cams1.tvecs.numpy())
    assert float(state.loss) == float(state1.loss)


@pytest.mark.parametrize("world", [2, 4])
def test_pose_batch_matches_single_device(problems, sharded, world):
    cams, state = sharded[world]["pose"]
    cams1, state1 = refine_poses(problems["pose"][1], config=TLMConfig(**POSE_CONFIG),
                                 device="cpu")
    np.testing.assert_allclose(cams.tvecs, cams1.tvecs.numpy(), atol=1e-9)
    np.testing.assert_array_equal(state.iter_num, state1.iter_num.numpy())
    np.testing.assert_array_equal(state.accepted, state1.accepted.numpy())
    assert cams.rmats.shape[0] == 16 and state.jac.shape[0] == 16


def test_pose_world2_matches_jax_sharded(problems, sharded):
    jcams, jstate = j_pose_sharded(problems["pose"][0], mesh=j_make_mesh(2),
                                   config=JLMConfig(**POSE_CONFIG))
    cams, state = sharded[2]["pose"]
    np.testing.assert_allclose(cams.tvecs, np.asarray(jcams.tvecs), atol=1e-9)
    np.testing.assert_array_equal(state.accepted, np.asarray(jstate.accepted))


def test_problem_placement(problems):
    """Each of 4 ranks holds a quarter of the observations; cameras, points
    and the width are whole."""
    flat = problems["exact"][1]
    placed = [shard_ba_problem(flat, rank_mesh(r, 4)) for r in range(4)]
    for name in ("cam_idx", "pt_idx", "uv", "mask"):
        parts = [getattr(p, name) for p in placed]
        assert parts[0].shape[0] * 4 == getattr(flat, name).shape[0]
        assert torch.equal(torch.cat(parts), getattr(flat, name))
    assert all(p.points3d is flat.points3d for p in placed)
    assert torch.equal(placed[3].cameras.rmats, flat.cameras.rmats)
    with pytest.raises(ValueError, match="not divisible"):
        rank_mesh(0, 3).block(1000)


def test_no_group_is_one_process():
    assert not distributed.initialize_distributed()
    assert distributed.process_local_obs_slice(10) == slice(0, 10)
    with pytest.raises(RuntimeError, match="no process group"):
        Mesh(device="cpu")


def test_divergent_rank_fails_instead_of_hanging():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        distributed.launch("_torch_shard_ref.one_rank_all_reduce", 2, backend="gloo",
                           device="cpu", timeout_s=5, deadline_s=60)
    assert time.monotonic() - t0 < 60


def test_missed_deadline_kills_the_ranks():
    with pytest.raises(RuntimeError, match="deadline"):
        distributed.launch("_torch_shard_ref.sleep", 2, args=(120,), backend="gloo",
                           device="cpu", timeout_s=5, deadline_s=8)
