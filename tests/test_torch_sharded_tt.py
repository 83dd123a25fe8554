"""The port's sharded track-table solve (``parallel/sharded_tt.py``) over
gloo ranks on the CPU, against JAX's sharded solve and the port's
single-device ``ba_solve_tt``.

The scenes of tests/test_sharded_tt.py (8 cameras, 400 points, seed 31,
pinhole and radial, perturbed with seed 32, exact observations), packed by
JAX's ``tt_from_flat(point_block=64)`` and carried across; f64, one
intra-op thread per rank.  The sharded solve runs JAX's sharded route,
``kernels=False``.

- World 2 against JAX's ``ba_solve_tt_sharded`` on a 2-device mesh: one LM
  step (JAX's ``TRAJ_CONFIG``), also with ``optimize_dist``, with the same
  ``accepted``, ``iter_num`` and ``cg_iters``, points and tvecs to atol
  1e-6 and dist to atol 1e-5 (JAX's tests); and the radial scene observed with 0.5 px
  noise, three LM steps, with the same step counts and the loss to rtol
  1e-8.  The loss after one step from the perturbed start differs by f64
  summation order at ~3e-8 relative, and after three steps the points
  drift along the gauge at ~1e-6, so each case holds the quantity it
  pins.
- World 1 equals the single-device solve bit for bit (3 LM iterations with
  ``optimize_dist``, JAX's ``test_single_device_mesh_bit_exact``).
- World 4 against the single-device solve, the same tolerances.
- The divisibility ``ValueError``.
Every rank's outputs are bit-equal (``_torch_shard_ref.run_ranks``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ref import np_fields
from _torch_shard_ref import TT, rank_mesh, run_ranks

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.parallel.mesh import make_mesh as j_make_mesh
from tpu3drecon.parallel.sharded_tt import ba_solve_tt_sharded as j_sharded
from tpu3drecon.problems.tt import tt_from_flat as j_tt
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.parallel.sharded_tt import shard_tt_problem
from tpu3drecon_torch.problems.convert import tt_problem_from_numpy
from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

DISTS = {"pinhole": (0.0, 0.0), "radial": (-0.08, 0.012)}
CONFIG = dict(maxiter=12, gtol=1e-14, cg_maxiter=40, cg_rtol=1e-10)
TRAJ = dict(CONFIG, maxiter=1)
CASES = {  # id -> (scene, config)
    "pinhole": ("pinhole-exact", TRAJ),
    "radial": ("radial-exact", TRAJ),
    "radial-dist": ("radial-exact", dict(TRAJ, optimize_dist=True)),
    "radial-noisy": ("radial-noisy", dict(CONFIG, maxiter=3, gtol=0.0, ftol=0.0)),
}


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, dist in DISTS.items():
        scene = j_syn.make_scene(n_cameras=8, n_points=400, seed=31, dist=dist)
        for noise in (0.0, 0.5):
            noisy = j_syn.perturb_scene(scene, seed=32, point2d_noise=noise)
            flat, _ = j_syn.scene_to_ba_problem(
                noisy, observed=scene if noise == 0.0 else noisy, dtype=jnp.float64)
            jax_problem = j_tt(flat, point_block=64)
            key = f"{name}-{'exact' if noise == 0.0 else 'noisy'}"
            out[key] = (jax_problem,
                        tt_problem_from_numpy(np_fields(jax_problem), device="cpu"))
    return out


@pytest.fixture(scope="module")
def sharded(problems):
    """world -> case id -> rank 0's (cameras, points, state)."""
    out = {}
    for world in (2, 4):
        calls = [(TT, (problems[s][1], TConfig(**cfg)), {}) for s, cfg in CASES.values()]
        out[world] = dict(zip(CASES, run_ranks(world, calls)))
    return out


def _close(port, ref, case):
    """Equal step counts; on the exact scenes (one step) points and tvecs
    to atol 1e-6 and dist to 1e-5, on the noisy one (three steps) the loss
    to rtol 1e-8."""
    cams, pts, state = port
    rcams, rpts, rstate = ref
    assert int(state.iter_num) == int(rstate.iter_num)
    assert int(state.accepted) == int(rstate.accepted)
    assert int(state.cg_iters) == int(rstate.cg_iters)
    if case.endswith("noisy"):
        np.testing.assert_allclose(float(state.loss), float(rstate.loss), rtol=1e-8)
        return
    np.testing.assert_allclose(np.asarray(pts), np.asarray(rpts), rtol=0, atol=1e-6)
    # dist to JAX's atol of its joint-distortion test (1e-5).
    for name, atol in (("tvecs", 1e-6), ("dist", 1e-5)):
        np.testing.assert_allclose(np.asarray(getattr(cams, name)),
                                   np.asarray(getattr(rcams, name)), rtol=0, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_jax_sharded(problems, sharded, case):
    scene, cfg = CASES[case]
    ref = j_sharded(problems[scene][0], JConfig(**cfg), mesh=j_make_mesh(2))
    _close(sharded[2][case], ref, case)


@pytest.mark.parametrize("case", list(CASES))
def test_world4_matches_single_device(problems, sharded, case):
    scene, cfg = CASES[case]
    _close(sharded[4][case], ba_solve_tt(problems[scene][1], TConfig(**cfg)), case)


def test_world1_bit_exact(problems):
    cfg = TConfig(**dict(CONFIG, maxiter=3, optimize_dist=True))
    port = problems["radial-exact"][1]
    (cams, pts, state), = run_ranks(1, [(TT, (port, cfg), {})])
    cams1, pts1, state1 = ba_solve_tt(port, cfg)
    assert np.array_equal(pts, pts1.numpy())
    for name in ("tvecs", "dist", "rmats", "fx_fy"):
        assert np.array_equal(getattr(cams, name), getattr(cams1, name).numpy()), name
    assert float(state.loss) == float(state1.loss)
    assert (int(state.accepted), int(state.cg_iters)) == (int(state1.accepted),
                                                          state1.cg_iters)


def test_divisibility_guard(problems):
    with pytest.raises(ValueError, match="not divisible"):
        shard_tt_problem(problems["radial-exact"][1], rank_mesh(0, 3))
