"""The port's grid engine (``solvers/ba_grid.py``) against JAX's.

The scene of tests/test_ba_grid.py (8 cameras, 300 points, seed 7, pinhole
and radial) perturbed with seed 8 and observed with 0.5 px noise (a nonzero
optimum), packed by the JAX package (f64) and carried across with
``problems.convert``.  Blocks, the normal equations and the Schur products
must equal JAX's to rtol 1e-10; each solve runs 4 LM iterations of 8 CG
iterations (3 pose-only), before the loss reaches float64 rounding, and
must give the same ``iter_num``, ``accepted`` and ``cg_iters``, loss to
rtol 1e-8 and parameters to rtol 1e-7 (``_torch_ref.assert_same_solve``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, assert_same_solve, np_fields

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.problems.grid import grid_from_flat as j_grid_from_flat
from tpu3drecon.solvers import ba_grid as j_grid
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.problems.convert import grid_problem_from_numpy
from tpu3drecon_torch.problems.grid import grid_from_flat as t_grid_from_flat
from tpu3drecon_torch.solvers import ba_grid as t_grid
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig
from tpu3drecon_torch.solvers.bundle_adjust import ba_solve, reprojection_rmse

DISTS = {"pinhole": (0.0, 0.0), "radial": (-0.08, 0.012)}
BASE = dict(maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
CASES = {
    "schur_jacobi": ("radial", dict(BASE)),
    "pinhole": ("pinhole", dict(BASE)),
    "jacobi_u": ("radial", dict(BASE, precond="jacobi_u")),
    "fixed_focal": ("radial", dict(BASE, optimize_focal=False)),
    "pose_only": ("radial", dict(BASE, maxiter=3, optimize_points=False)),
    "cauchy": ("radial", dict(BASE, loss="CAUCHY")),
}


def _configs(kw):
    kw = dict(kw)
    loss = kw.pop("loss", "TRIVIAL")
    return JConfig(loss=JLoss[loss], **kw), TConfig(loss=TLoss[loss], **kw)


def _grids(dist, seed=8, noise=0.5):
    scene = j_syn.make_scene(n_cameras=8, n_points=300, seed=7, dist=dist)
    noisy = j_syn.perturb_scene(scene, seed=seed, point2d_noise=noise)
    flat, _ = j_syn.scene_to_ba_problem(noisy, dtype=jnp.float64)
    jg = j_grid_from_flat(flat)
    return jg, grid_problem_from_numpy(np_fields(jg), device="cpu")


@pytest.fixture(scope="module")
def grids():
    return {name: _grids(dist) for name, dist in DISTS.items()}


def _params(g):
    c = g.cameras
    return c.rmats, c.tvecs, c.fx_fy, c.cx_cy_skew, c.dist, g.points3d


@pytest.mark.parametrize("dist", list(DISTS))
@pytest.mark.parametrize("loss", ["TRIVIAL", "CAUCHY", "HUBER"])
def test_grid_blocks_match_jax(grids, dist, loss):
    jg, tg = grids[dist]
    want = j_grid.grid_blocks(*_params(jg), jg, JLoss[loss])
    got = t_grid.grid_blocks(*_params(tg), tg, TLoss[loss])
    for name in ("r", "jc", "jp"):
        assert_close(getattr(got, name), getattr(want, name), 1e-10, 1e-13, err_msg=name)


def _normals(jg, tg, lam, precond):
    jb = j_grid.grid_blocks(*_params(jg), jg, JLoss.TRIVIAL)
    tb = t_grid.grid_blocks(*_params(tg), tg, TLoss.TRIVIAL)
    jnb = j_grid.build_grid_normal(jb, jg, jnp.asarray(lam), precond=precond)
    tnb = t_grid.build_grid_normal(tb, tg, torch.tensor(lam, dtype=torch.float64),
                                   precond=precond)
    return jnb, tnb


@pytest.mark.parametrize("precond", ["schur_jacobi", "jacobi_u"])
def test_grid_normal_matches_jax(grids, precond):
    jg, tg = grids["radial"]
    jnb, tnb = _normals(jg, tg, 1e-3, precond)
    for name in t_grid.GridNormal._fields:
        assert_close(getattr(tnb, name), getattr(jnb, name), 1e-10, 1e-13, err_msg=name)


@pytest.mark.parametrize("precond", ["schur_jacobi", "jacobi_u"])
def test_grid_normal_poisoned_camera(grids, precond):
    """A NaN camera: JAX's Cholesky gives NaN factors, the port's
    ``cholesky_ex`` the same NaN blocks, and neither raises."""
    jg, tg = grids["radial"]
    rm = np.array(jg.cameras.rmats)
    rm[3] = np.nan
    jg = dataclasses.replace(jg, cameras=dataclasses.replace(jg.cameras, rmats=jnp.asarray(rm)))
    tg = dataclasses.replace(tg, cameras=dataclasses.replace(
        tg.cameras, rmats=torch.from_numpy(rm)))
    jnb, tnb = _normals(jg, tg, 1e-3, precond)
    for name in t_grid.GridNormal._fields:
        got = getattr(tnb, name).numpy()
        want = np.asarray(getattr(jnb, name))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13, err_msg=name)
    chol = tnb.u_chol.numpy()
    assert np.isnan(chol[3]).any() and not np.isnan(np.delete(chol, 3, axis=0)).any()


def test_grid_products_match_jax(grids):
    jg, tg = grids["radial"]
    jnb, tnb = _normals(jg, tg, 1e-3, "schur_jacobi")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(tg.n_cameras, 8))
    y = rng.normal(size=(tg.n_points, 3))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    pairs = {
        "w_times": (t_grid.w_times(tnb, ty, tg), j_grid.w_times(jnb, jy, jg)),
        "wt_times": (t_grid.wt_times(tnb, tx, tg), j_grid.wt_times(jnb, jx, jg)),
        "schur_matvec": (t_grid.schur_matvec(tnb, tx, tg), j_grid.schur_matvec(jnb, jx, jg)),
        "precond_apply": (t_grid.precond_apply(tnb, tx), j_grid.precond_apply(jnb, jx)),
    }
    for name, (got, want) in pairs.items():
        assert_close(got, want, 1e-10, 1e-13, err_msg=name)
    tdc, titers = t_grid.schur_pcg(tnb, tx, tg, 8, 1e-4)
    jdc, jiters = j_grid.schur_pcg(jnb, jx, jg, 8, 1e-4)
    assert titers == int(jiters)
    assert_close(tdc, jdc, 1e-9, 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_grid_solve_matches_jax(grids, name):
    dist, kw = CASES[name]
    jg, tg = grids[dist]
    jcfg, tcfg = _configs(kw)
    ref = j_grid.ba_solve_grid(jg, jcfg)
    port = t_grid.ba_solve_grid(tg, tcfg)
    assert_same_solve(port, ref, tcfg.maxiter)
    cams, pts, state = port
    assert int(state.accepted) > 0
    if name == "pose_only":
        assert torch.equal(pts, tg.points3d)
    if name == "fixed_focal":
        assert torch.equal(cams.fx_fy, tg.cameras.fx_fy)


def test_grid_solve_equals_flat_solve():
    """The port's grid and flat engines agree, as tests/test_ba_grid.py:85
    holds JAX's (exact observations, 30 LM iterations)."""
    scene = t_syn.make_scene(n_cameras=8, n_points=300, seed=7)
    noisy = t_syn.perturb_scene(scene, seed=8, point2d_noise=0.0)
    flat, _ = t_syn.scene_to_ba_problem(noisy, observed=scene, dtype=torch.float64,
                                        device="cpu")
    config = TConfig(maxiter=30, gtol=1e-12, cg_maxiter=100, cg_rtol=1e-8)
    cams_f, pts_f, state_f = ba_solve(flat, config, device="cpu")
    cams_g, pts_g, state_g = t_grid.ba_solve_grid(t_grid_from_flat(flat), config)
    assert int(state_g.accepted) == int(state_f.accepted)
    np.testing.assert_allclose(pts_g.numpy(), pts_f.numpy(), atol=1e-7)
    np.testing.assert_allclose(cams_g.tvecs.numpy(), cams_f.tvecs.numpy(), atol=1e-7)
    np.testing.assert_allclose(float(state_g.loss), float(state_f.loss), rtol=1e-6, atol=1e-18)
    assert float(reprojection_rmse(flat, cams_g, pts_g)) < 1e-5


def test_float32_solve_converges():
    scene = t_syn.make_scene(n_cameras=8, n_points=300, seed=7)
    noisy = t_syn.perturb_scene(scene, seed=8, point2d_noise=0.0)
    flat, _ = t_syn.scene_to_ba_problem(noisy, observed=scene, dtype=torch.float32,
                                        device="cpu")
    solver = t_grid.make_grid_ba_solver(TConfig(maxiter=50, gtol=1e-6, cg_rtol=1e-4))
    cams, pts, state = solver(t_grid_from_flat(flat))
    assert pts.dtype == torch.float32 and int(state.accepted) > 0
    assert float(reprojection_rmse(flat, cams, pts)) < 0.05


@pytest.mark.parametrize("kw", [dict(optimize_pp=True), dict(precond="ssor"),
                                dict(precond="tridiag")])
def test_config_errors_raise(grids, kw):
    _, tg = grids["pinhole"]
    with pytest.raises(ValueError, match="optimize_pp|tt/wtt engines only"):
        t_grid.ba_solve_grid(tg, TConfig(**kw))
    with pytest.raises(ValueError):
        t_grid.make_grid_ba_solver(TConfig(**kw))
    with pytest.raises(ValueError):
        j_grid.ba_solve_grid(grids["pinhole"][0], JConfig(**kw))


def test_optimize_dist_raises(grids):
    """The port's grid engine refuses ``optimize_dist`` (JAX's holds k1, k2
    fixed), so one config never gives it a different answer than the flat
    and track-table engines, which optimize k1, k2."""
    _, tg = grids["pinhole"]
    with pytest.raises(ValueError, match="optimize_dist"):
        t_grid.ba_solve_grid(tg, TConfig(optimize_dist=True))
    with pytest.raises(ValueError, match="optimize_dist"):
        t_grid.make_grid_ba_solver(TConfig(optimize_dist=True))


def test_solver_cache_is_keyed_by_config():
    a = t_grid.make_grid_ba_solver(TConfig(maxiter=3))
    assert t_grid.make_grid_ba_solver(TConfig(maxiter=3)) is a
    assert t_grid.make_grid_ba_solver(TConfig(maxiter=4)) is not a
