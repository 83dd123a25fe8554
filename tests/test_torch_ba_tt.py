"""The slice: the port's dense track-table engine ``ba_solve_tt`` (fully
fused, ``kernels="full"``: kernels B12-B16) vs the JAX reference.

One module-scoped scene (8 cameras, 300 points, 120 observations per
camera, 0.5 px observation noise; the fixture of
tests/test_torch_ba_pallas.py), packed by the JAX package's
``tt_from_flat(point_block=64)``.  The JAX ``ba_solve_tt(kernels="full")``
runs its kernels in interpret mode at f64; the port solves the same packed
problem, carried across with ``problems.convert``, at f64 on the CPU (plain
kernel versions).  Fixed work: 5 LM iterations, ``gtol=ftol=0``, 8 CG
iterations.  Trajectory: equal ``iter_num``, ``accepted`` and
``cg_iters``, loss to rtol 1e-8, cameras and points to rtol 1e-7 /
atol 1e-9 (the per-camera sums are taken in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, np_fields, to_np

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.problems.tt import tt_from_flat as j_tt_from_flat
from tpu3drecon.solvers.ba_tt import ba_solve_tt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.bundle_adjust import reprojection_rmse as j_rmse

from tpu3drecon_torch.benchmark import medium_config
from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.ops import tt_linearize as t_ops
from tpu3drecon_torch.problems.convert import ba_problem_from_numpy, tt_problem_from_numpy
from tpu3drecon_torch.problems.tt import tt_from_flat as t_tt_from_flat
from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt as t_solve
from tpu3drecon_torch.solvers.ba_tt import make_tt_ba_solver
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig
from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse as t_rmse

SOLVE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")
CASES = {  # id -> (loss, precond)
    "trivial-sj": ("trivial", "schur_jacobi"),
    "cauchy-sj": ("cauchy", "schur_jacobi"),
    "trivial-jacobi_u": ("trivial", "jacobi_u"),
}


@pytest.fixture(scope="module")
def flat():
    scene = j_syn.make_scene(n_cameras=8, n_points=300, obs_per_camera=120, seed=71)
    noisy = j_syn.perturb_scene(scene, seed=72, point2d_noise=0.5)
    problem, _ = j_syn.scene_to_ba_problem(noisy, observed=noisy, dtype=jnp.float64)
    return problem


@pytest.fixture(scope="module")
def packed(flat):
    """(JAX tt problem, the port's copy of it on the CPU)."""
    jt = j_tt_from_flat(flat, point_block=64)
    return jt, tt_problem_from_numpy(np_fields(jt), device="cpu")


@pytest.fixture(scope="module")
def jax_solves(packed):
    """JAX solves, each computed once: id -> (cams, pts, state)."""
    jt, _ = packed
    cache = {}

    def get(case, kernels="full"):
        key = (case, kernels)
        if key not in cache:
            loss, precond = CASES[case]
            cfg = JConfig(**SOLVE, loss=JLoss(loss), precond=precond)
            cache[key] = j_solve(jt, cfg, kernels=kernels, interpret=bool(kernels))
        return cache[key]

    return get


def _assert_trajectory(port_out, jax_out):
    cams, pts, state = port_out
    jcams, jpts, jstate = jax_out
    assert state.iter_num == int(jstate.iter_num) == 5
    assert int(state.accepted) == int(jstate.accepted)
    assert state.cg_iters == int(jstate.cg_iters)
    np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-8)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(to_np(getattr(cams, name)), to_np(getattr(jcams, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(pts.numpy(), to_np(jpts), rtol=1e-7, atol=1e-9)


def test_tt_from_flat_bit_equal(flat, packed):
    """The port's packer gives the JAX packer's arrays bit for bit, and the
    converter carries them across unchanged."""
    jt, converted = packed
    own = t_tt_from_flat(ba_problem_from_numpy(np_fields(flat), device="cpu"),
                         point_block=64)
    for tt in (own, converted):
        for name in ("points3d", "point_rows", "avg_cam_width"):
            a, b = to_np(getattr(tt, name)), to_np(getattr(jt, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for name in CAM_FIELDS:
            np.testing.assert_array_equal(to_np(getattr(tt.cameras, name)),
                                          to_np(getattr(jt.cameras, name)), err_msg=name)
        assert tt.bucket_offsets == jt.bucket_offsets
        assert tt.n_real_points == jt.n_real_points
        assert len(tt.buckets) == len(jt.buckets) >= 3
        for i, (tb, jb) in enumerate(zip(tt.buckets, jt.buckets)):
            assert [f.name for f in dataclasses.fields(tb)] == ["uv", "mask", "cam_ids"]
            for name in ("uv", "mask", "cam_ids"):
                a, b = to_np(getattr(tb, name)), to_np(getattr(jb, name))
                assert a.dtype == b.dtype, f"bucket {i} {name}"
                np.testing.assert_array_equal(a, b, err_msg=f"bucket {i} {name}")


def test_unsupported_packing_raises(flat):
    t_flat = ba_problem_from_numpy(np_fields(flat), device="cpu")
    with pytest.raises(ValueError, match="one-hot"):
        t_tt_from_flat(t_flat, point_block=64, max_onehot_bytes=16)
    with pytest.raises(ValueError, match="one-hot"):
        j_tt_from_flat(flat, point_block=64, max_onehot_bytes=16)
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        t_tt_from_flat(t_flat, point_block=64, onehot_dtype="bits")


@pytest.mark.parametrize("case", list(CASES))
def test_slice_matches_jax(flat, packed, jax_solves, case):
    _, port = packed
    loss, precond = CASES[case]
    counts = (t_ops.CAM_COUNTS, t_ops.COUPLING_COUNTS, t_ops.WT_COUNTS,
              t_ops.W_COUNTS, t_ops.COST_COUNTS)
    before = [c.plain for c in counts]
    out = t_solve(port, TConfig(**SOLVE, loss=TLoss(loss), precond=precond), kernels="full")
    calls = [c.plain - b for c, b in zip(counts, before)]
    n_buckets = len(port.buckets)
    # Per LM iteration: B12 (and B13 under schur_jacobi) once per bucket,
    # B16 once per bucket for the candidate and once more at the start.
    assert calls[0] == 5 * n_buckets
    assert calls[1] == (5 * n_buckets if precond == "schur_jacobi" else 0)
    assert calls[4] == 6 * n_buckets
    cg = out[2].cg_iters
    assert calls[2] >= n_buckets * (5 + cg) and calls[3] >= n_buckets * (5 + cg)

    jax_out = jax_solves(case)
    _assert_trajectory(out, jax_out)
    cams, pts, state = out
    assert pts.shape == (flat.n_points, 3)
    np.testing.assert_allclose(state.points3d.numpy(), pts.numpy())
    assert_close(t_rmse(ba_problem_from_numpy(np_fields(flat), device="cpu"), cams, pts),
                 j_rmse(flat, jax_out[0], jax_out[1]), 1e-6)


def test_slice_matches_jax_xla_path(packed, jax_solves):
    """The default solver follows JAX's default, the XLA one-hot path
    (kernels=False)."""
    _, port = packed
    solver = make_tt_ba_solver(TConfig(**SOLVE))
    _assert_trajectory(solver(port), jax_solves("trivial-sj", kernels=False))


@pytest.mark.parametrize("kernels,change,error", [
    (True, {"precond": "ssor"}, ValueError),
    (True, {"matvec_bf16": True}, ValueError),
    ("full", {"precond": "tridiag"}, ValueError),
    ("full", {"precond": "ssor"}, ValueError),
    ("full", {"matvec_bf16": True}, ValueError),
    (False, {"matvec_bf16": True}, NotImplementedError),
])
def test_unsupported_options_raise(packed, kernels, change, error):
    """JAX's own ValueErrors, which JAX raises too; matvec_bf16 on the XLA
    route, a measured negative on the TPU, is not ported (ROADMAP A.8)."""
    jt, port = packed
    cfg = TConfig(**{**SOLVE, **change})
    with pytest.raises(error):
        t_solve(port, cfg, kernels=kernels)
    with pytest.raises(error):
        make_tt_ba_solver(cfg, kernels=kernels)
    if error is ValueError:
        with pytest.raises(ValueError):
            j_solve(jt, JConfig(**{**SOLVE, **change}), kernels=kernels)


def test_build_tt_problem_needs_cuda(monkeypatch, flat):
    """Called without ``device``, ``build_tt_problem`` and the converter
    target the CUDA card and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        medium_config.build_tt_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt_problem_from_numpy(np_fields(j_tt_from_flat(flat, point_block=64)))
