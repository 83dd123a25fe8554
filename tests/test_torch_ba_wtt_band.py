"""The port's ``ba_solve_wtt`` under the band preconditioners
(``precond="ssor"``/``"tridiag"``) vs the JAX reference.

Two scenes, packed by JAX and carried across with ``problems.convert``:

- the 16-camera sequential scene of tests/test_tridiag.py (perturbed here,
  so the solve has work to do), c_pad 128, one segment; route
  "index"/"index" runs B1's pair rows, route False/"index" B8's (JAX's
  Pallas kernels in interpret mode);
- a 140-camera sequential scene, c_pad 256, so ``auto_segments`` splits the
  chain in two; route False/False, where JAX's side is its XLA one-hot path
  and the port's is B7 and B8.  Under ``ssor`` the trajectories are
  compared.  Under ``tridiag`` this scene's trajectory is chaotic: the
  guard leaves near-singular pivots, and a change of the points at the
  level of rounding moves the port's own 5-iteration loss far beyond rtol
  1e-8.  There the band factors of one linearization are compared instead,
  to rtol 1e-10.

5 LM iterations each, f64 on the CPU (plain kernel versions).  Tolerances:
``_torch_ref.assert_same_solve`` (equal ``iter_num``, ``accepted`` and
``cg_iters``, loss to rtol 1e-8, parameters to rtol 1e-7).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, assert_same_solve, np_fields

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers import ba_wtt as j_ba_wtt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.tridiag import auto_segments

from tpu3drecon_torch.problems.convert import wtt_problem_from_numpy
from tpu3drecon_torch.solvers import ba_wtt as t_ba_wtt
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

SOLVE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
SCENES = {  # id -> make_sequential_scene arguments
    "seq16": dict(n_cameras=16, points_per_camera=24, track_span=3, seed=11),
    "seq140": dict(n_cameras=140, points_per_camera=6, track_span=3, seed=13),
}
ROUTES = {  # id -> (linearize_kernel, matvec_kernel)
    "index": dict(linearize_kernel="index", matvec_kernel="index"),
    "unfused": dict(linearize_kernel=False, matvec_kernel="index"),
    "xla": dict(linearize_kernel=False, matvec_kernel=False),
}
CASES = {  # id -> (scene, route, preconditioner)
    "seq16-index-ssor": ("seq16", "index", "ssor"),
    "seq16-index-tridiag": ("seq16", "index", "tridiag"),
    "seq16-unfused-ssor": ("seq16", "unfused", "ssor"),
    "seq16-unfused-tridiag": ("seq16", "unfused", "tridiag"),
    "seq140-xla-ssor": ("seq140", "xla", "ssor"),
}


@functools.lru_cache(maxsize=None)
def _jax_packed(scene_id):
    scene = j_syn.make_sequential_scene(**SCENES[scene_id])
    noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return j_wtt(flat, point_chunk=64)


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    scene_id, route, precond = CASES[request.param]
    kw = dict(SOLVE, **ROUTES[route], precond=precond)
    packed = _jax_packed(scene_id)
    return packed, j_solve(packed, JConfig(**kw)), TConfig(**kw)


def test_band_solve_matches_jax(reference):
    packed, ref, tcfg = reference
    port = t_solve(wtt_problem_from_numpy(np_fields(packed), device="cpu"), tcfg)
    assert_same_solve(port, ref, SOLVE["maxiter"])


def _params(problem, pts_planes):
    c = problem.cameras
    pts = []
    for b, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, _, pc = b.uv.shape
        pts.append(pts_planes(problem.points3d[off : off + g * pc].reshape(g, pc, 3)))
    return (c.rmats, c.tvecs, c.fx_fy, c.dist, c.cx_cy_skew, pts)


@pytest.mark.parametrize("precond", ["tridiag", "ssor"])
def test_band_factor_matches_jax_on_the_segmented_scene(precond):
    """One linearization of the c_pad-256 scene on route False/False: the
    band factor over two segments, guarded steps included."""
    kw = dict(SOLVE, **ROUTES["xla"], precond=precond)
    packed = _jax_packed("seq140")
    port = wtt_problem_from_numpy(np_fields(packed), device="cpu")
    with jax.default_matmul_precision("highest"):
        want = j_ba_wtt._linearize(
            _params(packed, lambda x: jnp.moveaxis(x, 2, 0)), jnp.asarray(1e-3), packed,
            JConfig(**kw)).tridiag
    got = t_ba_wtt._linearize(
        _params(port, lambda x: x.permute(2, 0, 1).contiguous()),
        torch.tensor(1e-3, dtype=torch.float64), port, TConfig(**kw)).tridiag
    assert type(got).__name__ == type(want).__name__
    for name in want._fields:
        assert_close(getattr(got, name), getattr(want, name), 1e-10, 1e-12, err_msg=name)
    if precond == "tridiag":  # the guard dropped the same interfaces
        dropped = ~np.asarray(want.w_used).any(axis=(1, 2))
        assert np.array_equal(~got.w_used.numpy().any(axis=(1, 2)), dropped)
        assert dropped.sum() > 2


def test_scenes_cover_one_and_several_segments():
    assert [auto_segments(_jax_packed(s).c_pad) for s in SCENES] == [1, 2]


@pytest.mark.parametrize("precond", ["ssor", "tridiag"])
def test_band_preconditioner_refuses_hub_tiles(precond):
    """The JAX engine's ValueError for a packing with global (hub) tiles."""
    problem = wtt_problem_from_numpy(np_fields(_jax_packed("seq16")), device="cpu")
    hub = dataclasses.replace(
        problem, buckets=(dataclasses.replace(problem.buckets[0], global_tiles=1),
                          *problem.buckets[1:]))
    with pytest.raises(ValueError, match="hub/global camera tiles"):
        t_solve(hub, TConfig(**SOLVE, **ROUTES["index"], precond=precond))
