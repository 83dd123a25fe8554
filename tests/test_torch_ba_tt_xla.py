"""The port's dense track-table engine on JAX's other two routes vs the JAX
reference: ``kernels=False`` (the default, JAX's XLA one-hot route; the
port gathers and scatter-adds through ``cam_ids``) under Schur-Jacobi and
the band preconditioners, and ``kernels=True`` (kernels B12 and B13, the
matvecs and cost outside them).

The scene is the one of tests/test_torch_ba_tt.py (8 cameras, 300 points,
0.5 px noise), packed by the JAX package's ``tt_from_flat(point_block=64)``
and carried across with ``problems.convert``; a 256-camera sequential scene
(``auto_segments`` gives two band segments of 128) joins it under ssor.
JAX runs its Pallas kernels in interpret mode, the port its plain kernel
versions, both at f64 on the CPU.  5 LM iterations, ``gtol=ftol=0``, 8 CG
iterations.  Trajectories: ``_torch_ref.assert_same_solve`` (equal
``iter_num``, ``accepted`` and ``cg_iters``, loss to rtol 1e-8, parameters
to rtol 1e-7).  The band pair rows (JAX's ``e_cols``) agree at rtol 1e-10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, assert_same_solve, np_fields

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems.tt import tt_from_flat as j_tt_from_flat
from tpu3drecon.solvers import ba_tt as j_ba_tt
from tpu3drecon.solvers import tridiag as j_tridiag
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.tridiag import auto_segments

from tpu3drecon_torch.ops import tt_linearize as t_ops
from tpu3drecon_torch.problems.convert import tt_problem_from_numpy
from tpu3drecon_torch.solvers import ba_tt as t_ba_tt
from tpu3drecon_torch.solvers import tridiag as t_tridiag
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

SOLVE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
CASES = {  # id -> (scene, kernels, precond)
    "ring8-xla-sj": ("ring8", False, "schur_jacobi"),
    "ring8-xla-ssor": ("ring8", False, "ssor"),
    "ring8-xla-tridiag": ("ring8", False, "tridiag"),
    "ring8-xla-jacobi_u": ("ring8", False, "jacobi_u"),
    "seq256-xla-ssor": ("seq256", False, "ssor"),
    "ring8-kernels-sj": ("ring8", True, "schur_jacobi"),
}


@functools.lru_cache(maxsize=None)
def _jax_packed(scene_id):
    if scene_id == "ring8":
        scene = j_syn.make_scene(n_cameras=8, n_points=300, obs_per_camera=120, seed=71)
        noisy = j_syn.perturb_scene(scene, seed=72, point2d_noise=0.5)
        flat, _ = j_syn.scene_to_ba_problem(noisy, observed=noisy, dtype=jnp.float64)
    else:
        scene = j_syn.make_sequential_scene(n_cameras=256, points_per_camera=4,
                                            track_span=3, seed=13)
        noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
        flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return j_tt_from_flat(flat, point_block=64)


def _port(scene_id):
    return tt_problem_from_numpy(np_fields(_jax_packed(scene_id)), device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    scene_id, kernels, precond = CASES[request.param]
    cfg = JConfig(**SOLVE, precond=precond)
    ref = j_ba_tt.ba_solve_tt(_jax_packed(scene_id), cfg, kernels=kernels,
                              interpret=kernels)
    return scene_id, kernels, precond, ref


def test_route_matches_jax(reference):
    scene_id, kernels, precond, ref = reference
    counts = (t_ops.CAM_COUNTS, t_ops.COUPLING_COUNTS, t_ops.WT_COUNTS,
              t_ops.W_COUNTS, t_ops.COST_COUNTS)
    before = [c.plain for c in counts]
    port = t_ba_tt.ba_solve_tt(_port(scene_id), TConfig(**SOLVE, precond=precond),
                               kernels=kernels)
    assert_same_solve(port, ref, SOLVE["maxiter"])
    calls = [c.plain - b for c, b in zip(counts, before)]
    # kernels=True runs B12 (and B13 under Schur-Jacobi) only; False none.
    n = len(_port(scene_id).buckets) * SOLVE["maxiter"]
    assert calls == ([n, n if precond == "schur_jacobi" else 0, 0, 0, 0] if kernels
                     else [0] * 5)


def test_default_route_is_jax_default():
    """``ba_solve_tt(problem)`` and JAX's ``ba_solve_tt(problem)`` take the
    same route (kernels=False) and the same trajectory."""
    cfg = dict(SOLVE, precond="ssor")
    ref = j_ba_tt.ba_solve_tt(_jax_packed("ring8"), JConfig(**cfg))
    before = t_ops.CAM_COUNTS.plain
    port = t_ba_tt.ba_solve_tt(_port("ring8"), TConfig(**cfg))
    assert t_ops.CAM_COUNTS.plain == before
    assert_same_solve(port, ref, SOLVE["maxiter"])


def _params(problem, pts_planes):
    c = problem.cameras
    pts = [pts_planes(problem.points3d[off : off + b.mask.shape[1]])
           for b, off in zip(problem.buckets, problem.bucket_offsets)]
    return (c.rmats, c.tvecs, c.fx_fy, c.dist, c.cx_cy_skew, pts)


@pytest.mark.parametrize("scene_id", ["ring8", "seq256"])
def test_pair_rows_match_jax_e_cols(monkeypatch, scene_id):
    """One linearization under ssor: the E blocks both engines hand to their
    SSOR factor (JAX's -e_cols, before the segment ends are dropped)."""
    captured = {}

    def capture(key, make):
        def wrapped(d_blocks, e_blocks, segments=1):
            captured[key] = (e_blocks, segments)
            return make(d_blocks, e_blocks, segments=segments)
        return wrapped

    monkeypatch.setattr(j_tridiag, "ssor_factor", capture("jax", j_tridiag.ssor_factor))
    monkeypatch.setattr(t_tridiag, "ssor_factor", capture("port", t_tridiag.ssor_factor))
    packed, port = _jax_packed(scene_id), _port(scene_id)
    with jax.default_matmul_precision("highest"):
        j_ba_tt._linearize(_params(packed, lambda x: x.T), jnp.asarray(1e-3), packed,
                           JConfig(**SOLVE, precond="ssor"))
    slots = [t_ba_tt._slot_cams(b.cam_ids, b.mask, port.n_cameras) for b in port.buckets]
    t_ba_tt._linearize(_params(port, lambda x: x.T.contiguous()),
                       torch.tensor(1e-3, dtype=torch.float64), port,
                       TConfig(**SOLVE, precond="ssor"), False, slots)
    (want, j_seg), (got, t_seg) = captured["jax"], captured["port"]
    assert j_seg == t_seg == auto_segments(port.n_cameras)
    assert np.abs(np.asarray(want)).max() > 0
    assert_close(got, want, 1e-10, 1e-12)


@pytest.mark.parametrize("tb", [1, 2, 4])
def test_pair_rows_follow_jax_roll(tb):
    """Random slot cameras with padding, pairs (c, c + 1) placed on purpose,
    and the pair (C - 1, 0) that JAX's roll of the one-hot also forms: the
    port's pair rows against JAX's pair one-hot product
    (``ba_tt.py:607-611``).  Tb = 1 has no slot pair and gives zeros."""
    c, pb, k = 7, 50, 4
    rng = np.random.default_rng(tb)
    cam = rng.integers(0, c, size=(tb, pb))
    if tb > 1:
        cam[1, :20] = (cam[0, :20] + 1) % c
        cam[:2, 20:25] = [[c - 1], [0]]
    mask = (rng.random((tb, pb)) > 0.2).astype(np.float64)
    cam = np.where(mask > 0, cam, 0).astype(np.int32)
    od = rng.normal(size=(k, max(tb - 1, 0), pb))

    n = tb * pb
    oh = np.zeros((c, n))
    real = np.nonzero(mask.reshape(n) > 0)[0]
    oh[cam.reshape(n)[real], real] = 1.0
    oh = jnp.asarray(oh)
    pair_oh = oh[:, : n - pb] * jnp.roll(oh, -1, axis=0)[:, pb:]
    want = jnp.einsum("kn,cn->ck", jnp.asarray(od.reshape(k, -1)), pair_oh)

    idx = t_ba_tt._slot_cams(torch.as_tensor(cam), torch.as_tensor(mask), c)
    got = t_ba_tt._pair_rows(torch.as_tensor(od), idx, c)
    assert_close(got, want, 1e-10, 1e-12)
    if tb == 1:
        assert (got == 0).all()
    else:
        wrapped = (mask[0, 20:25] > 0) & (mask[1, 20:25] > 0)
        assert wrapped.any() and (got[c - 1] != 0).any()


def test_scenes_cover_one_and_two_segments():
    assert [auto_segments(_port(s).n_cameras) for s in ("ring8", "seq256")] == [1, 2]
