"""The port's sharded bucketed-grid solve (``parallel/sharded_grid.py``)
over gloo ranks on the CPU, against JAX's sharded solve and the port's
single-device fused-grid engine (``ba_solve_pallas``).

The scene of tests/test_sharded_grid.py (8 cameras, 400 points, seed 91,
perturbed with seed 92), packed by JAX's ``grid_bucketed_from_flat
(point_block=128)`` and carried across; f64, one intra-op thread per rank.
"exact": JAX's exact observations and config (15 LM iterations, to the
noiseless optimum), held as JAX's test holds them: ``accepted`` within
one (the all-reduce order can split the accept test near convergence),
points and tvecs to atol 1e-6.  "noisy": 0.5 px noise, three LM steps:
equal ``accepted``, ``iter_num`` and ``cg_iters``, loss to rtol 1e-8.

- World 2 (the plane-math route, JAX's pick on the CPU) against JAX's
  ``ba_solve_grid_sharded`` on a 2-device mesh.
- World 4 against ``ba_solve_pallas``; the kernel route (B9 and B11 in
  their plane forms, the plain versions here) against the plane route.
- A 10-camera scene (0.5 px noise, three LM steps) at world 4 pads to 12
  cameras: it matches the single-device solve as "noisy" does, and the
  padding cameras come back as they went in.
- ``pad_cameras_for_mesh``: zero masks, valid rotations.
Every rank's outputs are bit-equal (``_torch_shard_ref.run_ranks``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ref import np_fields
from _torch_shard_ref import GRID, run_ranks

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.parallel.mesh import make_mesh as j_make_mesh
from tpu3drecon.parallel.sharded_grid import ba_solve_grid_sharded as j_sharded
from tpu3drecon.problems.grid import grid_bucketed_from_flat as j_grid
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.parallel.sharded_grid import pad_cameras_for_mesh
from tpu3drecon_torch.problems.convert import grid_bucketed_problem_from_numpy
from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

CONFIG = dict(maxiter=15, gtol=1e-14, cg_maxiter=40, cg_rtol=1e-10)
EXACT = CONFIG
NOISY = dict(CONFIG, maxiter=3, gtol=0.0, ftol=0.0)
CASES = {  # id -> (scene, config, kernels)
    "exact": ("exact", EXACT, "auto"),
    "noisy": ("noisy", NOISY, "auto"),
    "kernels": ("exact", EXACT, "pallas"),
    "padded": ("ten", NOISY, "auto"),
}
WORLD_CASES = {2: ("exact", "noisy"), 4: ("exact", "noisy", "kernels", "padded")}


def _jax_grid(n_cameras, noise):
    scene = j_syn.make_scene(n_cameras=n_cameras, n_points=400, seed=91)
    noisy = j_syn.perturb_scene(scene, seed=92, point2d_noise=noise)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene if noise == 0.0 else noisy,
                                        dtype=jnp.float64)
    return j_grid(flat, point_block=128)


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, (n, noise) in {"exact": (8, 0.0), "noisy": (8, 0.5), "ten": (10, 0.5)}.items():
        jg = _jax_grid(n, noise)
        out[name] = (jg, grid_bucketed_problem_from_numpy(np_fields(jg), device="cpu"))
    return out


@pytest.fixture(scope="module")
def sharded(problems):
    """world -> case id -> rank 0's (cameras, points, state)."""
    out = {}
    for world, ids in WORLD_CASES.items():
        calls = [(GRID, (problems[CASES[i][0]][1], TConfig(**CASES[i][1])),
                  dict(kernels=CASES[i][2])) for i in ids]
        out[world] = dict(zip(ids, run_ranks(world, calls)))
    return out


def _close(port, ref, case, n_cameras=8):
    cams, pts, state = port
    rcams, rpts, rstate = ref
    if CASES[case][1] is NOISY:
        assert int(state.iter_num) == int(rstate.iter_num)
        assert int(state.accepted) == int(rstate.accepted)
        assert int(state.cg_iters) == int(rstate.cg_iters)
        np.testing.assert_allclose(float(state.loss), float(rstate.loss), rtol=1e-8)
        return
    # Near the noiseless optimum the accept test can split by one step.
    assert abs(int(state.accepted) - int(rstate.accepted)) <= 1
    np.testing.assert_allclose(np.asarray(pts), np.asarray(rpts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(cams.tvecs)[:n_cameras],
                               np.asarray(rcams.tvecs)[:n_cameras], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", WORLD_CASES[2])
def test_world2_matches_jax_sharded(problems, sharded, case):
    scene, cfg, _ = CASES[case]
    ref = j_sharded(problems[scene][0], JConfig(**cfg), mesh=j_make_mesh(2))
    _close(sharded[2][case], ref, case)


@pytest.mark.parametrize("case", WORLD_CASES[4])
def test_world4_matches_single_device(problems, sharded, case):
    scene, cfg, _ = CASES[case]
    n = problems[scene][1].n_cameras
    _close(sharded[4][case], ba_solve_pallas(problems[scene][1], TConfig(**cfg)), case, n)


def test_kernel_route_matches_plane_route(sharded):
    _close(sharded[4]["kernels"], sharded[4]["exact"], "kernels")


def test_padding_cameras_come_back_unchanged(problems, sharded):
    cams = sharded[4]["padded"][0]
    assert cams.rmats.shape[0] == 12  # 10 cameras padded to the mesh
    np.testing.assert_array_equal(cams.rmats[10:], np.broadcast_to(np.eye(3), (2, 3, 3)))
    np.testing.assert_array_equal(cams.tvecs[10:], [[0.0, 0.0, 1.0]] * 2)
    np.testing.assert_array_equal(cams.fx_fy[10:], np.ones((2, 2)))


def test_camera_padding_inert(problems):
    grid = problems["exact"][1]
    padded = pad_cameras_for_mesh(grid, 16)  # 8 cameras -> 16
    assert padded.n_cameras == 16
    assert float(padded.mask[8:].sum()) == 0.0
    np.testing.assert_allclose(np.linalg.det(padded.cameras.rmats[8:].numpy()), 1.0,
                               atol=1e-12)
    assert pad_cameras_for_mesh(grid, 4) is grid
