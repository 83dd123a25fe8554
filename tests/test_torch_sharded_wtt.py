"""The port's sharded windowed track-table solve (``parallel/sharded_wtt.py``)
over gloo ranks on the CPU, against JAX's sharded solve and the port's
single-device ``ba_solve_wtt``.

The scene of tests/test_sharded_wtt.py (24 cameras, 25 points each, track
span 3, seed 15, radial, perturbed with seed 16, exact observations),
packed by JAX's ``wtt_from_flat(point_chunk=32, chunk_multiple=8)`` and
carried across; f64, one intra-op thread per rank.

- World 2 against JAX's ``ba_solve_wtt_sharded`` on a 2-device mesh, one
  LM step (JAX's ``TRAJ_CONFIG``): the same ``accepted``, ``iter_num`` and
  ``cg_iters``, loss to rtol 1e-8, points and tvecs to atol 1e-6.
- World 1 equals the single-device solve bit for bit (3 LM iterations with
  ``optimize_dist``, JAX's ``test_single_device_mesh_bit_exact``).
- Worlds 2 and 4 against the single-device solve on the default route and
  on the fully indexed route (B1-B4 as plain versions), the split-window
  deferred packing of a 160-camera scene (seed 25, 0.5 px noise) and the hub
  packing of tests/test_torch_hub.py (700 cameras, two global tiles, 0.5 px
  noise: the optimum's loss stays far above float64 rounding): the same step
  counts, loss to rtol 1e-8, points and tvecs to atol 1e-6 (1e-4 on the
  split scene, the reference's tolerance for its sharded split solve).
- The divisibility ``ValueError``, and each rank's shards: 1/D of every
  bucket's chunks (the one-hot's too), rank blocks that concatenate to the
  whole.
Every rank's outputs are bit-equal (``_torch_shard_ref.run_ranks``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields
from _torch_shard_ref import WTT, rank_mesh, run_ranks

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.parallel.mesh import make_mesh as j_make_mesh
from tpu3drecon.parallel.sharded_wtt import ba_solve_wtt_sharded as j_sharded
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.parallel.sharded_wtt import shard_wtt_problem
from tpu3drecon_torch.problems.convert import wtt_problem_from_numpy
from tpu3drecon_torch.problems.wtt import wtt_from_flat as t_wtt
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

CONFIG = dict(maxiter=12, gtol=1e-14, cg_maxiter=40, cg_rtol=1e-10)
TRAJ = dict(CONFIG, maxiter=1)
INDEX = dict(matvec_kernel="index", linearize_kernel="index")
HUB = dict(n_cameras=700, points_per_camera=3, track_span=3, hub_fraction=0.1,
           hub_obs=60, seed=23)


def _jax_problem():
    scene = j_syn.make_sequential_scene(n_cameras=24, points_per_camera=25, track_span=3,
                                        seed=15, dist=(-0.05, 0.008))
    noisy = j_syn.perturb_scene(scene, seed=16, point2d_noise=0.0)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return j_wtt(flat, point_chunk=32, chunk_multiple=8)


def _split_flat():
    scene = t_syn.make_sequential_scene(n_cameras=160, points_per_camera=10, track_span=5,
                                        seed=25)
    noisy = t_syn.perturb_scene(scene, seed=26, point2d_noise=0.5)
    return t_syn.scene_to_ba_problem(noisy, dtype=torch.float64, device="cpu")[0]


def _hub_problem():
    scene = t_syn.make_hub_scene(**HUB)
    noisy = t_syn.perturb_scene(scene, seed=8, point2d_noise=0.5)
    flat, _ = t_syn.scene_to_ba_problem(noisy, dtype=torch.float64, device="cpu")
    return t_wtt(flat, point_chunk=64, chunk_multiple=2, defer_onehot=True,
                 reorder_cameras="hub")


@pytest.fixture(scope="module")
def problems():
    jax_problem = _jax_problem()
    return dict(jax=jax_problem,
                port=wtt_problem_from_numpy(np_fields(jax_problem), device="cpu"),
                split=t_wtt(_split_flat(), point_chunk=32, chunk_multiple=8,
                            split_windows=True, defer_onehot=True),
                hub=_hub_problem())


# id -> (problem, config) of the solves each world runs.
CASES = {
    "traj": ("port", TRAJ),
    "index": ("port", dict(TRAJ, **INDEX)),
    "split": ("split", dict(TRAJ, maxiter=2, **INDEX)),
    "hub": ("hub", dict(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4, **INDEX)),
}
WORLD_CASES = {2: ("traj", "index", "split", "hub"), 4: ("traj", "index")}


@pytest.fixture(scope="module")
def sharded(problems):
    """world -> case id -> rank 0's (cameras, points, state)."""
    out = {}
    for world, ids in WORLD_CASES.items():
        calls = [(WTT, (problems[CASES[i][0]], TConfig(**CASES[i][1])), {}) for i in ids]
        out[world] = dict(zip(ids, run_ranks(world, calls)))
    return out


def _close(port, ref, atol=1e-6):
    cams, pts, state = port
    rcams, rpts, rstate = ref
    assert int(state.iter_num) == int(rstate.iter_num)
    assert int(state.accepted) == int(rstate.accepted)
    assert int(state.cg_iters) == int(rstate.cg_iters)
    np.testing.assert_allclose(float(state.loss), float(rstate.loss), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(pts), np.asarray(rpts), rtol=0, atol=atol)
    np.testing.assert_allclose(np.asarray(cams.tvecs), np.asarray(rcams.tvecs), rtol=0,
                               atol=atol)


def test_world2_matches_jax_sharded(problems, sharded):
    ref = j_sharded(problems["jax"], JConfig(**TRAJ), mesh=j_make_mesh(2))
    _close(sharded[2]["traj"], ref)
    assert int(ref[2].accepted) == 1


@pytest.mark.parametrize("world,case", [(w, c) for w, ids in WORLD_CASES.items() for c in ids])
def test_matches_single_device(problems, sharded, world, case):
    name, cfg = CASES[case]
    # The split scene's gauge-weak line of 160 cameras: the tolerance of
    # tests/test_sharded_wtt.py::test_split_indexed_deferred_sharded.
    _close(sharded[world][case], ba_solve_wtt(problems[name], TConfig(**cfg)),
           atol=1e-4 if case == "split" else 1e-6)


def test_cases_cover_split_and_two_global_tiles(problems):
    unsplit = t_wtt(_split_flat(), point_chunk=32, chunk_multiple=8)
    assert len(problems["split"].buckets) > len(unsplit.buckets)
    assert all(b.onehot is None for b in problems["split"].buckets)
    assert max(b.global_tiles for b in problems["hub"].buckets) >= 2


def test_world1_bit_exact(problems):
    cfg = TConfig(**dict(CONFIG, maxiter=3, optimize_dist=True))
    (cams, pts, state), = run_ranks(1, [(WTT, (problems["port"], cfg), {})])
    cams1, pts1, state1 = ba_solve_wtt(problems["port"], cfg)
    assert np.array_equal(pts, pts1.numpy())
    for name in ("tvecs", "dist", "rmats", "fx_fy"):
        assert np.array_equal(getattr(cams, name), getattr(cams1, name).numpy()), name
    assert float(state.loss) == float(state1.loss)
    assert (int(state.accepted), int(state.cg_iters)) == (int(state1.accepted),
                                                          state1.cg_iters)


def test_divisibility_guard(problems):
    with pytest.raises(ValueError, match="not divisible"):
        shard_wtt_problem(problems["port"], rank_mesh(0, 3))


def test_rank_shards(problems):
    """Each of 4 ranks holds 1/4 of every bucket's chunks (the one-hot's
    too); the rank blocks concatenate to the whole."""
    port = problems["port"]
    per_rank = [shard_wtt_problem(port, rank_mesh(r, 4)) for r in range(4)]
    for i, b in enumerate(port.buckets):
        for field in ("uv", "mask", "cam_base", "wcam", "onehot"):
            blocks = [getattr(r[0][i], field) for r in per_rank]
            assert blocks[0].shape[0] * 4 == getattr(b, field).shape[0]
            assert torch.equal(torch.cat(blocks), getattr(b, field))
        assert per_rank[0][0][i].window == b.window
        pts = torch.cat([r[1][i] for r in per_rank], dim=1)
        g, _, _, pc = b.uv.shape
        off = port.bucket_offsets[i]
        assert torch.equal(pts, port.points3d[off : off + g * pc].reshape(g, pc, 3)
                           .permute(2, 0, 1))
