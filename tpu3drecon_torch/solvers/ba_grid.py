"""Grid-layout bundle adjustment: the scatter-free engine in plain PyTorch.

Counterpart of ``tpu3drecon/solvers/ba_grid.py`` (the JAX CLI's ``--engine
grid`` and its fallback where the wtt layout cannot be built).  Same LM /
implicit-Schur algorithm as the flat ``ba_solve``, over the (C, K)
observation grid and (P, T) track table of ``problems/grid.py``:

  - per-observation blocks are scalar planes over (C, K) (``grid_blocks``);
  - U, g_c and the camera half of every W product contract over the K axis
    as batched matmuls;
  - V, g_p and the point half of the W^T products gather through the track
    table and reduce densely over T: no scatter anywhere in the solve.

The JAX engine reaches no Pallas kernel, so neither does this one: every
step is a PyTorch operation.  Its accept/reject is JAX's inline loop, whose
decisions are those of the shared ``solvers/trust_region.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from tpu3drecon_torch.geometry.losses import RobustLoss, robust_weight
from tpu3drecon_torch.ops.jacobians import apply_se3_retraction
from tpu3drecon_torch.ops.point_normal import inv3x3
from tpu3drecon_torch.problems.grid import BAGridProblem
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState
from tpu3drecon_torch.solvers.pcg import (
    cho_block_precond,
    cholesky_or_nan,
    guarded_block_cholesky,
    pcg,
)
from tpu3drecon_torch.solvers.trust_region import trust_region_solve


class GridBlocks(NamedTuple):
    r: torch.Tensor  # (C, K, 2) whitened residual planes
    jc: torch.Tensor  # (C, K, 2, 8)
    jp: torch.Tensor  # (C, K, 2, 3)


def _project(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, problem, loss):
    """Camera-frame point, its normalized and distorted coordinates and the
    whitened residual over the grid: the part of ``grid_blocks`` that the
    cost needs too."""
    dtype = points3d.dtype
    x_w = points3d[problem.pt_idx]  # (C, K, 3)
    xc = (
        rmats[:, None, :, 0] * x_w[..., 0:1]
        + rmats[:, None, :, 1] * x_w[..., 1:2]
        + rmats[:, None, :, 2] * x_w[..., 2:3]
    ) + tvecs[:, None, :]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.ones((), dtype=dtype, device=z.device), z)
    iz = 1.0 / z_safe
    fx = fx_fy[:, 0:1]
    fy = fx_fy[:, 1:2]
    cx = cx_cy_skew[:, 0:1]
    cy = cx_cy_skew[:, 1:2]
    sk = cx_cy_skew[:, 2:3]
    k1 = dist[:, 0:1]
    k2 = dist[:, 1:2]

    mx = x * iz
    my = y * iz
    r2 = mx * mx + my * my
    s_rad = 1.0 + k1 * r2 + k2 * r2 * r2
    mdx = s_rad * mx
    mdy = s_rad * my

    u = fx * mdx + sk * mdy + cx
    v = fy * mdy + cy
    r = torch.stack([u, v], dim=-1) - problem.uv
    s = torch.sum(r * r, dim=-1)
    w = robust_weight(loss, s)
    scale = torch.sqrt(w) * problem.mask * (1.0 / problem.avg_cam_width)
    geo = (x, y, z, iz, fx, fy, sk, k1, k2, mx, my, r2, s_rad, mdx, mdy)
    return r * scale[..., None], scale, geo


def grid_blocks(
    rmats: torch.Tensor,
    tvecs: torch.Tensor,
    fx_fy: torch.Tensor,
    cx_cy_skew: torch.Tensor,
    dist: torch.Tensor,
    points3d: torch.Tensor,
    problem: BAGridProblem,
    loss: RobustLoss,
) -> GridBlocks:
    """Residual and Jacobian planes over the (C, K) grid: the formulas of
    ``ops/jacobians.obs_blocks`` (radial chain factor A = s I + g m m^T)
    written as scalar planes, as the JAX engine writes them."""
    r, scale, geo = _project(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, problem, loss)
    x, y, z, iz, fx, fy, sk, k1, k2, mx, my, r2, s_rad, mdx, mdy = geo
    g_rad = 2.0 * k1 + 4.0 * k2 * r2

    # dm'/dX_c = A @ dm/dX_c as planes (A = s I + g m m^T).
    axx = s_rad + g_rad * mx * mx
    axy = g_rad * mx * my
    ayy = s_rad + g_rad * my * my
    b00 = axx * iz
    b01 = axy * iz
    b02 = -(axx * mx + axy * my) * iz
    b10 = axy * iz
    b11 = ayy * iz
    b12 = -(axy * mx + ayy * my) * iz

    # dpi/dX_c = K2 @ dm'/dX_c.
    a11 = fx * b00 + sk * b10
    a12 = fx * b01 + sk * b11
    a13 = fx * b02 + sk * b12
    a21 = fy * b10
    a22 = fy * b11
    a23 = fy * b12

    # J_rot = dpi @ (-[X_c]_x).
    jr00 = -a12 * z + a13 * y
    jr01 = a11 * z - a13 * x
    jr02 = -a11 * y + a12 * x
    jr10 = -a22 * z + a23 * y
    jr11 = a21 * z - a23 * x
    jr12 = -a21 * y + a22 * x

    zero = torch.zeros_like(a11)
    jc = torch.stack(
        [
            torch.stack([jr00, jr01, jr02, a11, a12, a13, mdx, zero], dim=-1),
            torch.stack([jr10, jr11, jr12, a21, a22, a23, zero, mdy], dim=-1),
        ],
        dim=-2,
    )  # (C, K, 2, 8)

    # J_pt = dpi @ R (3 terms per entry).
    dpi = torch.stack(
        [torch.stack([a11, a12, a13], dim=-1), torch.stack([a21, a22, a23], dim=-1)],
        dim=-2,
    )  # (C, K, 2, 3)
    jp = (
        dpi[..., 0:1] * rmats[:, None, None, 0, :]
        + dpi[..., 1:2] * rmats[:, None, None, 1, :]
        + dpi[..., 2:3] * rmats[:, None, None, 2, :]
    )
    sc = scale[..., None, None]
    return GridBlocks(r=r, jc=jc * sc, jp=jp * sc)


class GridNormal(NamedTuple):
    u: torch.Tensor  # (C, 8, 8) damped
    v_inv: torch.Tensor  # (P, 3, 3)
    u_chol: torch.Tensor  # (C, 8, 8)
    g_cam: torch.Tensor  # (C, 8)
    g_pt: torch.Tensor  # (P, 3)
    damp_cam: torch.Tensor  # (C, 8)
    damp_pt: torch.Tensor  # (P, 3)
    jc: torch.Tensor  # (C, K, 2, 8) kept for the products
    jp: torch.Tensor  # (C, K, 2, 3)
    jp_g: torch.Tensor  # (P, T, 2, 3) track-gathered jp
    jc_g: torch.Tensor  # (P, T, 2, 8) track-gathered jc


def build_grid_normal(
    blocks: GridBlocks, problem: BAGridProblem, lam: torch.Tensor,
    diag_floor: float = 1e-8, precond: str = "schur_jacobi",
) -> GridNormal:
    c, k = problem.uv.shape[:2]
    p, t = problem.track_idx.shape
    dtype = blocks.r.dtype
    dev = blocks.r.device

    jc2 = blocks.jc.reshape(c, k * 2, 8)
    r2 = blocks.r.reshape(c, k * 2)
    u = torch.einsum("cni,cnj->cij", jc2, jc2)
    g_cam = torch.einsum("cni,cn->ci", jc2, r2)

    # One gather of [jp | r] per (obs, row), one of jc.
    packed = torch.cat([blocks.jp, blocks.r[..., None]], dim=-1).reshape(c * k, 2, 4)
    tm = problem.track_mask[..., None, None]
    packed_g = packed[problem.track_idx] * tm  # (P, T, 2, 4)
    jp_g = packed_g[..., :3]
    r_g = packed_g[..., 3]
    jc_g = blocks.jc.reshape(c * k, 2, 8)[problem.track_idx] * tm
    jp_g2 = jp_g.reshape(p, t * 2, 3)
    v = torch.sum(jp_g2[..., :, None] * jp_g2[..., None, :], dim=1)
    g_pt = torch.sum(jp_g2 * r_g.reshape(p, t * 2)[..., None], dim=1)

    eye8 = torch.eye(8, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    du = torch.clamp(torch.diagonal(u, dim1=-2, dim2=-1), min=diag_floor)
    dv = torch.clamp(torch.diagonal(v, dim1=-2, dim2=-1), min=diag_floor)
    damp_cam = lam * du
    damp_pt = lam * dv
    u_d = u + damp_cam[..., None] * eye8
    v_d = v + damp_pt[..., None] * eye3
    v_inv = inv3x3(v_d)

    if precond == "schur_jacobi":
        # Exact diagonal blocks of S: per-cell W = jc^T jp, then W V^-1 W^T
        # reduced over the K axis.
        w_cell = (
            blocks.jc[..., 0, :, None] * blocks.jp[..., 0, None, :]
            + blocks.jc[..., 1, :, None] * blocks.jp[..., 1, None, :]
        )  # (C, K, 8, 3)
        vinv_g = v_inv[problem.pt_idx]  # (C, K, 3, 3)
        wv = (
            w_cell[..., 0, None] * vinv_g[..., None, 0, :]
            + w_cell[..., 1, None] * vinv_g[..., None, 1, :]
            + w_cell[..., 2, None] * vinv_g[..., None, 2, :]
        )
        coupling = torch.einsum("ckil,ckml->cim", wv, w_cell)
        u_chol = guarded_block_cholesky(u_d - coupling, u_d)
    else:
        u_chol = cholesky_or_nan(u_d)

    return GridNormal(
        u=u_d, v_inv=v_inv, u_chol=u_chol, g_cam=g_cam, g_pt=g_pt,
        damp_cam=damp_cam, damp_pt=damp_pt, jc=blocks.jc, jp=blocks.jp,
        jp_g=jp_g, jc_g=jc_g,
    )


def w_times(nb: GridNormal, y_pt: torch.Tensor, problem: BAGridProblem) -> torch.Tensor:
    """(W y)_c: y gathered onto the grid, two small contractions."""
    tmp = torch.sum(nb.jp * y_pt[problem.pt_idx][:, :, None, :], dim=-1)
    return torch.einsum("ckri,ckr->ci", nb.jc, tmp)


def wt_times(nb: GridNormal, x_cam: torch.Tensor, problem: BAGridProblem) -> torch.Tensor:
    """(W^T x)_p: x gathered by each track entry's camera, reduced over the
    track axis."""
    x_g = x_cam[problem.track_cam]  # (P, T, 8)
    s_g = torch.sum(nb.jc_g * x_g[:, :, None, :], dim=-1)
    return torch.sum(nb.jp_g * s_g[..., None], dim=(1, 2))


def schur_matvec(nb: GridNormal, x_cam: torch.Tensor, problem: BAGridProblem) -> torch.Tensor:
    ux = torch.sum(nb.u * x_cam[:, None, :], dim=-1)
    wtx = wt_times(nb, x_cam, problem)
    vinv_wtx = torch.sum(nb.v_inv * wtx[:, None, :], dim=-1)
    return ux - w_times(nb, vinv_wtx, problem)


def precond_apply(nb: GridNormal, r_cam: torch.Tensor) -> torch.Tensor:
    return cho_block_precond(nb.u_chol)(r_cam)


def schur_pcg(
    nb: GridNormal, b_cam: torch.Tensor, problem: BAGridProblem, maxiter: int, rtol: float,
):
    out = pcg(
        lambda x: schur_matvec(nb, x, problem),
        lambda r: precond_apply(nb, r),
        b_cam, maxiter, rtol,
    )
    return out.x, out.iters


def _check_config(config: BAConfig) -> None:
    if config.optimize_pp:
        raise ValueError(
            "optimize_pp is supported by the track-table engines "
            "(ba_solve_tt / ba_solve_wtt) only"
        )
    if config.optimize_dist:
        raise ValueError(
            "optimize_dist (k1, k2 as camera columns) is supported by the flat and "
            "track-table engines (ba_solve / ba_solve_tt / ba_solve_wtt) only"
        )
    if config.precond in ("tridiag", "ssor"):
        raise ValueError(
            f"precond={config.precond!r} is supported by the tt/wtt engines "
            "only (band preconditioners need the track-table pair one-hots)"
        )


def ba_solve_grid(
    problem: BAGridProblem, config: BAConfig = BAConfig()
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Grid-layout BA solve where the problem lives; returns the same
    (cameras, points, BAState) triple and trust-region trajectory as the
    JAX ``ba_solve_grid``."""
    _check_config(config)
    torch.set_float32_matmul_precision("highest")
    cams = problem.cameras
    dtype = problem.points3d.dtype

    def blocks_for(params) -> GridBlocks:
        rmats, tvecs, fx_fy, points3d = params
        b = grid_blocks(rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, points3d,
                        problem, config.loss)
        jc, jp = b.jc, b.jp
        if not config.optimize_focal:
            jc = torch.cat([jc[..., :6], torch.zeros_like(jc[..., 6:8])], dim=-1)
        if not config.optimize_points:
            jp = jp * 0.0
        return GridBlocks(r=b.r, jc=jc, jp=jp)

    def cost(params) -> torch.Tensor:
        rmats, tvecs, fx_fy, points3d = params
        r, _, _ = _project(rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, points3d,
                           problem, config.loss)
        return 0.5 * torch.sum(r * r)

    def propose(params, lam):
        nb = build_grid_normal(blocks_for(params), problem, lam, precond=config.precond)
        grad_norm = torch.max(torch.abs(nb.g_cam))
        if config.optimize_points:
            grad_norm = torch.maximum(grad_norm, torch.max(torch.abs(nb.g_pt)))
        else:
            grad_norm = torch.clamp(grad_norm, min=0.0)
        vinv_gp = torch.sum(nb.v_inv * nb.g_pt[:, None, :], dim=-1)
        b = -nb.g_cam + w_times(nb, vinv_gp, problem)
        dc, cg_iters = schur_pcg(nb, b, problem, config.cg_maxiter, config.cg_rtol)
        dp = torch.sum(nb.v_inv * (-nb.g_pt - wt_times(nb, dc, problem))[:, None, :], dim=-1)
        if not config.optimize_points:
            dp = dp * 0.0
        pred = 0.5 * (
            torch.sum(dc * (nb.damp_cam * dc))
            + torch.sum(dp * (nb.damp_pt * dp))
            - torch.sum(dc * nb.g_cam)
            - torch.sum(dp * nb.g_pt)
        )
        return (dc, dp), grad_norm, pred, cg_iters

    def apply_step(params, delta):
        rmats, tvecs, fx_fy, points3d = params
        dc, dp = delta
        new_r, new_t, new_f = apply_se3_retraction(rmats, tvecs, fx_fy, dc)
        return (new_r, new_t, new_f, points3d + dp)

    params0 = (cams.rmats, cams.tvecs, cams.fx_fy, problem.points3d)
    final = trust_region_solve(propose, apply_step, cost, params0, config, dtype,
                               problem.points3d.device)
    rmats, tvecs, fx_fy, points3d = final.params
    cameras_out = CameraParams(rmats=rmats, tvecs=tvecs, fx_fy=fx_fy,
                               cx_cy_skew=cams.cx_cy_skew, dist=cams.dist)
    state = BAState(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, points3d=points3d, loss=final.loss,
        lam=final.lam, nu=final.nu, iter_num=final.iter_num, accepted=final.accepted,
        grad_norm=final.grad_norm, converged=final.converged,
        cg_iters=final.cg_iters, gain=final.gain,
    )
    return cameras_out, points3d, state


_GRID_SOLVER_CACHE: dict = {}


def make_grid_ba_solver(config: BAConfig = BAConfig()):
    """``problem -> ba_solve_grid(problem, config)``, one closure per config
    (cached).  JAX's jit and its dynamic-operand split have no counterpart
    (ROADMAP A.8)."""
    _check_config(config)
    if config not in _GRID_SOLVER_CACHE:
        _GRID_SOLVER_CACHE[config] = functools.partial(ba_solve_grid, config=config)
    return _GRID_SOLVER_CACHE[config]
