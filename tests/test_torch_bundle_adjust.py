"""The port's flat ``ba_solve`` (``solvers/bundle_adjust.py``) against JAX's.

The small scene of tests/test_bundle_adjust.py (8 cameras, 300 points,
seed 7) perturbed with seed 8 and observed with 0.5 px noise (a nonzero
optimum), built once from a seed with numpy by the JAX package (f64) and
carried across with ``problems.convert``.  Each solve runs 5 LM iterations
of 8 CG iterations (4 LM iterations pose-only, which converges faster),
before the loss reaches float64 rounding, and must give the same
``iter_num``, ``accepted`` and ``cg_iters``, loss to rtol 1e-8 and
parameters to rtol 1e-7 (``_torch_ref.assert_same_solve``).

Pose-only BA on the wtt engine (``optimize_points=False``, fully indexed)
is held the same way against JAX's wtt solve, on the sequential scene of
tests/test_ba_wtt.py; JAX's flat and wtt solves of that problem agree with
each other too, and the port's flat solve with JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import SEQ_DISTS, assert_close, assert_same_solve, np_fields, seq_scene_kwargs

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.bundle_adjust import ba_solve as j_solve
from tpu3drecon.solvers.bundle_adjust import reprojection_rmse as j_rmse
from tpu3drecon.solvers import schur as j_schur

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.problems.convert import ba_problem_from_numpy, wtt_problem_from_numpy
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve_wtt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig
from tpu3drecon_torch.solvers.bundle_adjust import ba_solve as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import make_ba_solver
from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse as t_rmse
from tpu3drecon_torch.solvers import schur as t_schur

BASE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
CASES = {
    "schur_jacobi": dict(BASE),
    "jacobi_u": dict(BASE, precond="jacobi_u"),
    "fixed_focal": dict(BASE, optimize_focal=False),
    "pose_only": dict(BASE, maxiter=4, optimize_points=False),
    "cauchy": dict(BASE, loss="CAUCHY"),
}


def _configs(kw):
    kw = dict(kw)
    loss = kw.pop("loss", "TRIVIAL")
    return JConfig(loss=JLoss[loss], **kw), TConfig(loss=TLoss[loss], **kw)


@pytest.fixture(scope="module")
def small():
    scene = j_syn.make_scene(n_cameras=8, n_points=300, seed=7)
    noisy = j_syn.perturb_scene(scene, point3d_noise=3e-2, camera_rotation_noise=2e-2,
                                camera_translation_noise=5e-2, camera_intrinsics_noise=10.0,
                                point2d_noise=0.5, seed=8)
    flat, _ = j_syn.scene_to_ba_problem(noisy, dtype=jnp.float64)
    return flat, ba_problem_from_numpy(np_fields(flat), device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_flat_solve_matches_jax(small, name):
    jflat, tflat = small
    jcfg, tcfg = _configs(CASES[name])
    ref = j_solve(jflat, jcfg)
    port = t_solve(tflat, tcfg, device="cpu")
    assert_same_solve(port, ref, tcfg.maxiter)
    cams, pts, state = port
    assert int(state.accepted) > 0
    if name == "pose_only":
        assert torch.equal(pts, tflat.points3d)
    if name == "fixed_focal":
        assert torch.equal(cams.fx_fy, tflat.cameras.fx_fy)
    assert_close(t_rmse(tflat, cams, pts), j_rmse(jflat, ref[0], ref[1]), 1e-7)


def _blocks(seed=0, n_obs=240, n_cams=8, n_pts=60):
    """Random per-observation blocks: r (N, 2), jc (N, 2, 8), jp (N, 2, 3),
    each camera and point observed several times."""
    rng = np.random.default_rng(seed)
    cam_idx = rng.permutation(np.arange(n_obs) % n_cams).astype(np.int32)
    pt_idx = rng.permutation(np.arange(n_obs) % n_pts).astype(np.int32)
    return (rng.normal(size=(n_obs, 2)), rng.normal(size=(n_obs, 2, 8)),
            rng.normal(size=(n_obs, 2, 3)), cam_idx, pt_idx, n_cams, n_pts)


@pytest.mark.parametrize("precond", ["schur_jacobi", "jacobi_u"])
@pytest.mark.parametrize("lam", [1e-3, -0.6])
def test_schur_core_matches_jax(precond, lam):
    """``build_normal_blocks`` and the Schur products against JAX's.  A
    negative lambda makes some damped blocks indefinite: their factors are
    NaN in both packages (JAX's Cholesky; the port's ``cholesky_ex`` with
    ``info != 0``, also on the Schur-Jacobi fallback)."""
    r, jc, jp, ci, pi, nc, npt = _blocks()
    jnb = j_schur.build_normal_blocks(jnp.asarray(r), jnp.asarray(jc), jnp.asarray(jp),
                                      jnp.asarray(ci), jnp.asarray(pi), nc, npt,
                                      jnp.asarray(lam), precond=precond)
    tnb = t_schur.build_normal_blocks(torch.tensor(r), torch.tensor(jc), torch.tensor(jp),
                                      torch.tensor(ci), torch.tensor(pi), nc, npt,
                                      torch.tensor(lam, dtype=torch.float64), precond=precond)
    for name in t_schur.NormalBlocks._fields:
        got, want = getattr(tnb, name).numpy(), np.asarray(getattr(jnb, name))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12, err_msg=name)
    bad = np.isnan(tnb.u_chol.numpy()).any(axis=(1, 2))
    assert bad.any() == (lam < 0), bad
    if lam < 0:
        return
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(nc, 8)), rng.normal(size=(npt, 3))
    tci, tpi = torch.tensor(ci), torch.tensor(pi)
    jci, jpi = jnp.asarray(ci), jnp.asarray(pi)
    pairs = [
        (t_schur.w_times(tnb, torch.tensor(y), tci, tpi, nc),
         j_schur.w_times(jnb, jnp.asarray(y), jci, jpi, nc)),
        (t_schur.wt_times(tnb, torch.tensor(x), tci, tpi, npt),
         j_schur.wt_times(jnb, jnp.asarray(x), jci, jpi, npt)),
        (t_schur.schur_matvec(tnb, torch.tensor(x), tci, tpi),
         j_schur.schur_matvec(jnb, jnp.asarray(x), jci, jpi)),
        (t_schur.precond_apply(tnb, torch.tensor(x)), j_schur.precond_apply(jnb, jnp.asarray(x))),
        (t_schur.back_substitute_points(tnb, torch.tensor(x), tci, tpi),
         j_schur.back_substitute_points(jnb, jnp.asarray(x), jci, jpi)),
    ]
    for got, want in pairs:
        assert_close(got, want, 1e-10, atol_rel=1e-12)
    tp = t_schur.schur_pcg(tnb, torch.tensor(x), tci, tpi, maxiter=6, rtol=1e-6)
    jp_ = j_schur.schur_pcg(jnb, jnp.asarray(x), jci, jpi, maxiter=6, rtol=1e-6)
    assert tp.iters == int(jp_.iters)
    assert_close(tp.x, jp_.x, 1e-8, atol_rel=1e-10)
    assert_close(tp.rel_residual, jp_.rel_residual, 1e-6)


def test_make_ba_solver_is_cached(small):
    _, tflat = small
    cfg = TConfig(**dict(BASE, maxiter=2))
    solver = make_ba_solver(cfg)
    assert make_ba_solver(cfg) is solver
    a = solver(tflat, device="cpu")
    b = t_solve(tflat, cfg, device="cpu")
    assert a[2].iter_num == b[2].iter_num == 2
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("kw,match", [
    (dict(optimize_pp=True), "optimize_pp"),
    (dict(precond="tridiag"), "tridiag"),
    (dict(precond="ssor"), "ssor"),
])
def test_flat_refuses_what_jax_refuses(small, kw, match):
    jflat, tflat = small
    with pytest.raises(ValueError, match=match):
        j_solve(jflat, JConfig(**kw))
    with pytest.raises(ValueError, match=match):
        t_solve(tflat, TConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match=match):
        make_ba_solver(TConfig(**kw))


def test_wtt_pose_only_matches_jax():
    """Pose-only BA on the wtt engine's main path (fully indexed) against
    JAX's wtt solve, and the flat solves of the same problem: all four
    trajectories agree for the 4 LM iterations before the loss reaches
    float64 rounding."""
    scene = j_syn.make_sequential_scene(**seq_scene_kwargs(SEQ_DISTS["radial"]))
    noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.5)
    jflat, _ = j_syn.scene_to_ba_problem(noisy, dtype=jnp.float64)
    packed = j_wtt(jflat, point_chunk=64, defer_onehot=True)
    kw = dict(BASE, maxiter=4, optimize_points=False)
    route = dict(matvec_kernel="index", linearize_kernel="index")
    jwtt = j_solve_wtt(packed, JConfig(**kw, **route))
    port_wtt = t_solve_wtt(wtt_problem_from_numpy(np_fields(packed), device="cpu"),
                           TConfig(**kw, **route))
    assert_same_solve(port_wtt, jwtt, 4)
    np.testing.assert_array_equal(port_wtt[1].numpy(), np.asarray(jflat.points3d))
    jflat_res = j_solve(jflat, JConfig(**kw))
    assert_same_solve(jflat_res, jwtt, 4)  # JAX's flat and wtt engines agree
    port_flat = t_solve(ba_problem_from_numpy(np_fields(jflat), device="cpu"), TConfig(**kw),
                        device="cpu")
    assert_same_solve(port_flat, jflat_res, 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA default")
def test_ba_solve_defaults_to_the_card(small):
    _, tflat = small
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_solve(tflat, TConfig(maxiter=1))
