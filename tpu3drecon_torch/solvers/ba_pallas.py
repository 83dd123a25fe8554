"""Fused-kernel grid bundle adjustment: plane-layout linearization by three
kernels, plane-layout matvecs, the shared trust-region loop.

Counterpart of ``tpu3drecon/solvers/ba_pallas.py`` (the JAX package's
"pallas" engine).  Per LM iteration:

  1. kernel B9 (ops/cam_normal.py ``cam_normal_idx``) computes the r/jp/jc
     planes, U and g_cam per camera row of the (C, K) grid, reading each
     lane's point through ``pt_idx``;
  2. one index gather moves the jp/r rows to the point side, per track
     bucket;
  3. kernel B10 (ops/point_normal.py) forms each point's damped V^-1, g_pt
     and damping, in one launch over all the track buckets;
  4. kernel B11 (ops/coupling.py ``coupling_idx``) forms the Schur-Jacobi
     blocks sum W V^-1 W^T, reading V^-1 through ``pt_idx``, and the
     preconditioner gets a guarded Cholesky;
  5. the Schur-CG matvecs, the back-substitution and the cost run in plain
     PyTorch over the (C, comp, K) plane layout (index gathers and
     contractions, as the JAX engine leaves them to XLA), and the shared
     trust-region controller accepts or rejects.

Takes a ``BAGridProblem`` or a ``BAGridBucketedProblem``; bucketed outputs
are un-permuted back to the original point order.  ``packed_gathers``
(ops/packed_gather.py, a measured negative on the TPU) is not ported and
raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from tpu3drecon_torch.geometry.losses import robust_weight
from tpu3drecon_torch.ops.cam_normal import cam_normal_idx
from tpu3drecon_torch.ops.coupling import coupling_idx
from tpu3drecon_torch.ops.jacobians import apply_se3_retraction
from tpu3drecon_torch.ops.point_normal import point_normal_buckets
from tpu3drecon_torch.problems.grid import (
    BAGridBucketedProblem,
    TrackBucket,
    unpermute_points,
)
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState
from tpu3drecon_torch.solvers.pcg import (
    cho_block_precond,
    cholesky_or_nan,
    guarded_block_cholesky,
    pcg,
)
from tpu3drecon_torch.solvers.trust_region import trust_region_solve

_FOCAL_ROWS = (6, 7, 14, 15)  # jc planes of fx (row 0) and fy (row 1)


def _track_buckets(problem) -> tuple:
    """Normalize: bucketed problems expose their buckets; a plain grid
    problem acts as a single bucket covering all points."""
    if isinstance(problem, BAGridBucketedProblem):
        return problem.buckets
    return (
        TrackBucket(
            track_idx=problem.track_idx,
            track_cam=problem.track_cam,
            track_mask=problem.track_mask,
        ),
    )


class PlaneNormal(NamedTuple):
    """One linearization in plane layout."""

    u_chol: torch.Tensor  # (C, 8, 8) cholesky of the preconditioner blocks
    u: torch.Tensor  # (C, 8, 8) damped
    g_cam: torch.Tensor  # (C, 8)
    g_pt: torch.Tensor  # (P, 3)
    v_inv: torch.Tensor  # (P, 3, 3)
    damp_cam: torch.Tensor  # (C, 8)
    damp_pt: torch.Tensor  # (P, 3)
    jc: torch.Tensor  # (C, 16, K) planes
    jp: torch.Tensor  # (C, 6, K) planes
    jp_g: tuple  # per-bucket (Pb, 2Tb, 3) track-gathered


def _grid_planes(rows: torch.Tensor, pt_idx: torch.Tensor) -> torch.Tensor:
    """(C, d, K) planes of the per-point rows (P, d) gathered onto the grid."""
    return rows[pt_idx].permute(0, 2, 1).contiguous()


def _uv_planes(problem) -> torch.Tensor:
    return problem.uv.permute(0, 2, 1).contiguous()  # (C, 2, K)


def _inv_w(problem, dtype) -> torch.Tensor:
    return (1.0 / problem.avg_cam_width).to(dtype)


def _track_gather(jp: torch.Tensor, r: torch.Tensor, problem) -> list:
    """Per track bucket, (jp_g (Pb, 2Tb, 3), r_g (Pb, 2Tb)): the whitened
    point-Jacobian and residual rows of each point's observations, zero on
    padded track entries.  One 8-wide row per observation carries
    [jp row 0 | jp row 1 | r]."""
    c, _, k = jp.shape
    jpr = torch.cat([jp, r], dim=1).permute(0, 2, 1).reshape(c * k, 8)
    out = []
    for bucket in _track_buckets(problem):
        pb, tb = bucket.track_idx.shape
        g = jpr[bucket.track_idx] * bucket.track_mask[..., None]
        out.append((
            g[..., :6].reshape(pb, tb * 2, 3).contiguous(),
            g[..., 6:].reshape(pb, tb * 2).contiguous(),
        ))
    return out


def _vinv6(v_inv: torch.Tensor) -> torch.Tensor:
    """(P, 6) unique entries (00 01 02 11 12 22) of the symmetric V^-1 (the
    plane form of B11's input, for the checks of ``coupling_fused``)."""
    return torch.stack(
        [v_inv[:, 0, 0], v_inv[:, 0, 1], v_inv[:, 0, 2],
         v_inv[:, 1, 1], v_inv[:, 1, 2], v_inv[:, 2, 2]],
        dim=1,
    )


def _linearize(params, lam, problem, config: BAConfig) -> PlaneNormal:
    rmats, tvecs, fx_fy, points3d = params
    p_num = points3d.shape[0]
    dtype = points3d.dtype
    cams = problem.cameras

    r, jp, jc, u0, g_cam = cam_normal_idx(
        rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, points3d, problem.pt_idx,
        _uv_planes(problem), problem.mask, _inv_w(problem, dtype), loss=config.loss,
    )
    if not config.optimize_focal:
        # Zero the focal planes and the matching U/g rows.
        jc = jc.index_fill(1, torch.tensor(_FOCAL_ROWS, device=jc.device), 0.0)
        keep = torch.ones(8, dtype=dtype, device=jc.device)
        keep[6:8] = 0.0
        u0 = u0 * keep[None, :, None] * keep[None, None, :]
        g_cam = g_cam * keep[None, :]
    if not config.optimize_points:
        # Pose-only BA: a zero point Jacobian makes W, and with it the Schur
        # coupling in every matvec, vanish.
        jp = jp * 0.0

    gathered = _track_gather(jp, r, problem)
    jp_g_buckets = [jp_gb for jp_gb, _ in gathered]
    v_inv, g_pt, damp_pt = point_normal_buckets(jp_g_buckets, [r_gb for _, r_gb in gathered],
                                                lam)
    v_inv, g_pt, damp_pt = v_inv[:p_num], g_pt[:p_num], damp_pt[:p_num]
    if not config.optimize_points:
        g_pt = g_pt * 0.0

    eye8 = torch.eye(8, dtype=dtype, device=u0.device)
    du = torch.clamp(torch.diagonal(u0, dim1=-2, dim2=-1), min=1e-8)
    damp_cam = lam * du
    u_d = u0 + damp_cam[..., None] * eye8

    if config.precond == "schur_jacobi":
        coupling = coupling_idx(jc, jp, v_inv, problem.pt_idx)
        u_chol = guarded_block_cholesky(u_d - coupling, u_d)
    else:
        u_chol = cholesky_or_nan(u_d)

    return PlaneNormal(
        u_chol=u_chol, u=u_d, g_cam=g_cam, g_pt=g_pt, v_inv=v_inv,
        damp_cam=damp_cam, damp_pt=damp_pt, jc=jc, jp=jp,
        jp_g=tuple(jp_g_buckets),
    )


def _w_times(nb: PlaneNormal, y_pt: torch.Tensor, problem) -> torch.Tensor:
    """(W y)_c in plane layout: all (C, comp, K) contractions."""
    y_g = _grid_planes(y_pt, problem.pt_idx)  # (C, 3, K)
    tmp0 = torch.sum(nb.jp[:, 0:3] * y_g, dim=1)  # (C, K) row-0 product
    tmp1 = torch.sum(nb.jp[:, 3:6] * y_g, dim=1)
    out0 = torch.einsum("cik,ck->ci", nb.jc[:, :8], tmp0)
    out1 = torch.einsum("cik,ck->ci", nb.jc[:, 8:], tmp1)
    return out0 + out1


def _wt_times(nb: PlaneNormal, x_cam: torch.Tensor, problem) -> torch.Tensor:
    """(W^T x)_p: camera half on planes, point half via the track buckets."""
    c, k = problem.uv.shape[:2]
    p_num = problem.points3d.shape[0]
    s0 = torch.einsum("cik,ci->ck", nb.jc[:, :8], x_cam)
    s1 = torch.einsum("cik,ci->ck", nb.jc[:, 8:], x_cam)
    s = torch.stack([s0, s1], dim=-1).reshape(c * k, 2)
    parts = []
    for bucket, jp_gb in zip(_track_buckets(problem), nb.jp_g):
        pb, tb = bucket.track_idx.shape
        s_g = (s[bucket.track_idx] * bucket.track_mask[..., None]).reshape(pb, tb * 2)
        parts.append(torch.einsum("pni,pn->pi", jp_gb, s_g))
    return torch.cat(parts)[:p_num]


def _schur_matvec(nb: PlaneNormal, x: torch.Tensor, problem) -> torch.Tensor:
    ux = torch.einsum("cij,cj->ci", nb.u, x)
    wtx = _wt_times(nb, x, problem)
    vinv_wtx = torch.einsum("pij,pj->pi", nb.v_inv, wtx)
    return ux - _w_times(nb, vinv_wtx, problem)


def _pcg(nb: PlaneNormal, b: torch.Tensor, problem, maxiter: int, rtol: float):
    out = pcg(
        lambda p: _schur_matvec(nb, p, problem),
        cho_block_precond(nb.u_chol),
        b, maxiter, rtol,
    )
    return out.x, out.iters


def _cost(params, problem, config: BAConfig) -> torch.Tensor:
    """0.5 * ||whitened r||^2 on the grid (plain plane math)."""
    rmats, tvecs, fx_fy, points3d = params
    dtype = points3d.dtype
    x_w = points3d[problem.pt_idx]  # (C, K, 3)
    xc = torch.einsum("cij,ckj->cki", rmats, x_w) + tvecs[:, None, :]
    z = xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
    fx = fx_fy[:, 0:1]
    fy = fx_fy[:, 1:2]
    ccs = problem.cameras.cx_cy_skew
    dist = problem.cameras.dist
    mx = xc[..., 0] * iz
    my = xc[..., 1] * iz
    rr2 = mx * mx + my * my
    s_rad = 1.0 + dist[:, 0:1] * rr2 + dist[:, 1:2] * rr2 * rr2
    mdx = s_rad * mx
    mdy = s_rad * my
    u = fx * mdx + ccs[:, 2:3] * mdy + ccs[:, 0:1]
    v = fy * mdy + ccs[:, 1:2]
    r = torch.stack([u, v], dim=-1) - problem.uv
    s = torch.sum(r * r, dim=-1)
    w = robust_weight(config.loss, s)
    scale2 = w * (problem.mask / problem.avg_cam_width) ** 2
    return 0.5 * torch.sum(s * scale2 * (problem.mask > 0).to(dtype))


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
    if config.packed_gathers:
        raise NotImplementedError(
            "packed_gathers (ops/packed_gather.py, a measured negative on the "
            "TPU) is not ported; use packed_gathers=False"
        )


def ba_solve_pallas(
    problem, config: BAConfig = BAConfig()
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Fused-kernel grid BA solve where the problem lives; same outputs and
    trust-region trajectory as the JAX ``ba_solve_pallas``.  Accepts a
    ``BAGridProblem`` or a ``BAGridBucketedProblem`` (outputs un-permuted
    to the original point order)."""
    _check_config(config)
    torch.set_float32_matmul_precision("highest")
    cams, pts, state = _ba_solve_pallas_impl(problem, config)
    if isinstance(problem, BAGridBucketedProblem):
        pts = unpermute_points(pts, problem)
        state = state._replace(points3d=pts)
    return cams, pts, state


def _ba_solve_pallas_impl(problem, config: BAConfig):
    cams = problem.cameras
    dtype = problem.points3d.dtype
    dev = problem.points3d.device
    params0 = (cams.rmats, cams.tvecs, cams.fx_fy, problem.points3d)

    def propose(params, lam):
        nb = _linearize(params, lam, problem, config)
        grad_norm = torch.max(torch.abs(nb.g_cam))
        if config.optimize_points:
            grad_norm = torch.maximum(grad_norm, torch.max(torch.abs(nb.g_pt)))
        else:
            grad_norm = torch.clamp(grad_norm, min=0.0)
        vinv_gp = torch.einsum("pij,pj->pi", nb.v_inv, nb.g_pt)
        b = -nb.g_cam + _w_times(nb, vinv_gp, problem)
        dc, cg_iters = _pcg(nb, b, problem, config.cg_maxiter, config.cg_rtol)
        dp = torch.einsum(
            "pij,pj->pi", nb.v_inv, -nb.g_pt - _wt_times(nb, dc, problem)
        )
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

    final = trust_region_solve(
        propose, apply_step, functools.partial(_cost, problem=problem, config=config),
        params0, config, dtype, dev,
    )
    rmats, tvecs, fx_fy, points3d = final.params
    cameras_out = CameraParams(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, cx_cy_skew=cams.cx_cy_skew,
        dist=cams.dist,
    )
    state = BAState(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, points3d=points3d,
        loss=final.loss, lam=final.lam, nu=final.nu, iter_num=final.iter_num,
        accepted=final.accepted, grad_norm=final.grad_norm,
        converged=final.converged, cg_iters=final.cg_iters, gain=final.gain,
    )
    return cameras_out, points3d, state


def make_pallas_ba_solver(config: BAConfig = BAConfig()):
    """``problem -> ba_solve_pallas(problem, config)``; the JAX package's
    jit and solver caches have no counterpart (PyTorch runs eagerly)."""
    _check_config(config)
    return functools.partial(ba_solve_pallas, config=config)
