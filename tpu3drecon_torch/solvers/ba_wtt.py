"""Windowed track-table bundle adjustment.

Counterpart of ``tpu3drecon/solvers/ba_wtt.py``: the same LM /
implicit-Schur algorithm and trust-region control, with every per-slot
camera interaction in the wtt kernels (ops/wtt_linearize.py,
ops/wtt_matvec.py, ops/wtt_cost.py).  One LM iteration:

  1. linearize: with ``linearize_kernel="index"`` kernel B1 per bucket
     (it also reduces the Schur rhs W V^-1 g_pt; ``"index2"`` rounds its
     u | g | coupling | od columns through two bfloat16 split pieces in
     float32, as the TPU kernel's 2-term reduce does); otherwise the unfused
     route: B7 selects the slot camera planes, the Jacobian planes and the
     point normal run in PyTorch, B8 reduces the contribution rows.  Under
     the band preconditioners (``precond="tridiag"``/``"ssor"``) B1 or B8
     also emits the S_{c,c+1} pair rows (``want_od``).  The window rows
     tile-scatter to the camera axis, and the 8x8 blocks get a guarded
     Cholesky factorization, or with a band preconditioner the
     ``solvers/tridiag.py`` factor over 128-camera segments;
  2. PCG on U x - sum W V^-1 W^T x, the coupling from kernel B2
     (``matvec_kernel="index"``; ``"index1"``/``"index2"`` round x and z
     through 1 or 2 bfloat16 split pieces in float32), B6 from the dense one-hot
     (``True``/``"fused"``) or PyTorch gathers and scatters (False),
     preconditioned by the block Cholesky solve or the band sweeps;
  3. rhs (unfused linearize only) W V^-1 g_pt: B5 with any index matvec,
     else PyTorch; back-substitution W^T dc: B3 with any index matvec,
     else PyTorch; dp = V^-1 (-g_pt - W^T dc) (B3 and B5 always exact, as
     the JAX engine's ``idx_terms = 3``);
  4. cost of the candidate: kernel B4 (fused linearize) or B7 and the
     projection in PyTorch;
  5. SE(3) retraction and trust-region accept/reject.

The PyTorch forms of the JAX engine's XLA products (``_w_times_plane``,
``_wt_times_plane``) gather and scatter through ``wcam``; no route here
multiplies by the dense one-hot, which only B6 reads.  Window gathers and
scatters move whole 128-row camera tiles (``_window_rows`` /
``_scatter_rows``, a tile gather and an ``index_add_``; a window class of
a split packing may have no local tile, only global ones).  Only the CG
operator and B1's contribution columns run at reduced fidelity; the rhs,
back-substitution and cost stay exact.  ``matvec_bf16`` is not ported and
raises; the band preconditioners refuse hub/global camera tiles with the
JAX engine's ``ValueError``.  The band factor and sweeps run as
``torch.profiler`` spans ``band_precond_factor`` / ``band_precond_apply``
(``benchmark/profile_solve.py`` reads their host time and launches).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from tpu3drecon_torch.geometry.losses import robust_weight
from tpu3drecon_torch.ops._wtt_common import reduce_rows
from tpu3drecon_torch.ops.jacobians import apply_se3_retraction
from tpu3drecon_torch.ops.wtt_cost import wtt_cost_cols_idx
from tpu3drecon_torch.ops.wtt_linearize import (
    point_normal,
    wtt_cam_planes_idx,
    wtt_contrib_rows_idx,
    wtt_linearize_fused_idx,
)
from tpu3drecon_torch.ops.wtt_matvec import (
    _w_z,
    _wt_x,
    wtt_coupling_rows_fused,
    wtt_coupling_rows_idx,
    wtt_w_rows_idx,
    wtt_wt_planes_idx,
)
from tpu3drecon_torch.problems.grid import unpermute_points
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.problems.wtt import BAWTTProblem, CAM_TILE, WTTBucket, unpermute_cameras
from tpu3drecon_torch.solvers.ba_tt import (
    _cam_table,
    _sym3_matvec,
    _triu_pairs,
    _tt_blocks,
    _tt_state,
    _unpack_sym,
)
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState, n_cam_params
from tpu3drecon_torch.solvers.pcg import cho_block_precond, guarded_block_cholesky, pcg
from tpu3drecon_torch.solvers.tridiag import band_factor, band_preconditioner
from tpu3drecon_torch.solvers.trust_region import trust_region_solve

_BAND = ("tridiag", "ssor")


def _window_idx(bucket: WTTBucket) -> torch.Tensor:
    """(G, W/128) camera-TILE indices of each group's window; with global
    tiles the last ones are the shared global region."""
    base = bucket.cam_base.long()
    wb = (bucket.window - CAM_TILE * bucket.global_tiles) // CAM_TILE
    idx = base[:, None] // CAM_TILE + torch.arange(wb, device=base.device)[None, :]
    if bucket.global_tiles:
        gt = bucket.global_tile0 + torch.arange(bucket.global_tiles, device=base.device)
        idx = torch.cat([idx, gt[None, :].expand(idx.shape[0], -1)], dim=1)
    return idx


def _window_rows(x: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """Gather camera windows: (c_pad, d) -> (G, W, d) by tile gather."""
    d = x.shape[-1]
    g, wb = widx.shape
    return x.reshape(-1, CAM_TILE, d)[widx].reshape(g, wb * CAM_TILE, d)


def _scatter_rows(rows: torch.Tensor, widx: torch.Tensor, c_pad: int) -> torch.Tensor:
    """Scatter-add camera windows: (G, W, d) -> (c_pad, d) by tile index_add_."""
    g, w, d = rows.shape
    out = rows.new_zeros(c_pad // CAM_TILE, CAM_TILE, d)
    out.index_add_(0, widx.reshape(-1), rows.reshape(g * (w // CAM_TILE), CAM_TILE, d))
    return out.reshape(c_pad, d)


class WTTBucketNormal(NamedTuple):
    jc: torch.Tensor  # (2*np, G, Tb, Pc)
    jp: torch.Tensor  # (6, G, Tb, Pc)
    v_inv: torch.Tensor  # (6, G, Pc) sym planes
    g_pt: torch.Tensor  # (3, G, Pc)
    damp_pt: torch.Tensor  # (3, G, Pc)


class WTTNormal(NamedTuple):
    u: torch.Tensor  # (c_pad, np, np) damped
    u_chol: torch.Tensor  # (c_pad, np, np)
    g_cam: torch.Tensor  # (c_pad, np)
    damp_cam: torch.Tensor  # (c_pad, np)
    buckets: Tuple[WTTBucketNormal, ...]
    # TridiagFactor / SSORFactor under precond "tridiag" / "ssor", else None.
    tridiag: object = None
    # (c_pad, np) Schur rhs product W V^-1 g_pt from B1's rhs columns; None
    # on the unfused route, where propose forms it with w_times.
    b_cam: torch.Tensor = None


def _padded_table(params, c_pad: int) -> torch.Tensor:
    rmats, tvecs, fx_fy, dist, ccs, _ = params
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    table_pad = table.new_zeros(c_pad, table.shape[1])
    table_pad[: table.shape[0]] = table
    return table_pad


def _inv_w(problem: BAWTTProblem, dtype) -> torch.Tensor:
    return (1.0 / problem.avg_cam_width).to(dtype)


def _linearize(params, lam, problem: BAWTTProblem, config: BAConfig) -> WTTNormal:
    pts_list = params[5]
    c_pad = problem.c_pad
    table_pad = _padded_table(params, c_pad)
    dtype = table_pad.dtype
    inv_w = _inv_w(problem, dtype)
    np_cam = n_cam_params(config)
    n_triu = len(_triu_pairs(np_cam))
    want_od = config.precond in _BAND
    use_sj = config.precond == "schur_jacobi" or want_od
    fused = config.linearize_kernel in ("index", "index2")
    terms = 2 if config.linearize_kernel == "index2" else 3
    u_cols = table_pad.new_zeros(c_pad, n_triu)
    g_cols = table_pad.new_zeros(c_pad, np_cam)
    coup_cols = table_pad.new_zeros(c_pad, n_triu)
    e_cols = table_pad.new_zeros(c_pad, np_cam * np_cam)
    b_cols = table_pad.new_zeros(c_pad, np_cam)
    bucket_normals = []
    for bucket, pts in zip(problem.buckets, pts_list):
        widx = _window_idx(bucket)
        tw = _window_rows(table_pad, widx)
        if fused:
            rows, jc, jp, v_inv, g_pt, damp_pt = wtt_linearize_fused_idx(
                bucket.wcam, tw, pts, bucket.uv, bucket.mask, lam, inv_w, config,
                np_cam, use_sj, want_od, terms,
            )
        else:
            tb = bucket.uv.shape[2]
            cp = wtt_cam_planes_idx(bucket.wcam, tw, tb)  # (G, 19, Tb, Pc)
            r, jc, jp = _tt_blocks(
                cp.transpose(0, 1), pts[:, :, None, :], bucket.uv.transpose(0, 1),
                bucket.mask, inv_w, config,
            )
            v_inv, g_pt, damp_pt = point_normal(jp, r, lam)
            rows = wtt_contrib_rows_idx(
                bucket.wcam, jc, jp, r, v_inv, np_cam, bucket.window, use_sj, want_od,
            )
        reduced = _scatter_rows(rows, widx, c_pad)
        u_cols = u_cols + reduced[:, :n_triu]
        g_cols = g_cols + reduced[:, n_triu : n_triu + np_cam]
        off = n_triu + np_cam + (n_triu if use_sj else 0)
        if use_sj:
            coup_cols = coup_cols + reduced[:, n_triu + np_cam : off]
        if fused:
            # rhs block (W V^-1 g_pt) after the coupling, before the od rows.
            b_cols = b_cols + reduced[:, off : off + np_cam]
            off += np_cam
        if want_od:
            e_cols = e_cols + reduced[:, off:]
        bucket_normals.append(WTTBucketNormal(jc, jp, v_inv, g_pt, damp_pt))

    u0 = _unpack_sym(u_cols, np_cam)
    eye = torch.eye(np_cam, dtype=dtype, device=u0.device)
    du = torch.clamp(torch.diagonal(u0, dim1=-2, dim2=-1), min=1e-8)
    damp_cam = lam * du
    u_d = u0 + damp_cam[..., None] * eye
    if use_sj:
        precond_mat = u_d - _unpack_sym(coup_cols, np_cam)
        u_chol = guarded_block_cholesky(precond_mat, u_d)
    else:
        # Padding cameras have u0 = 0 and damp = lam*1e-8: SPD, inert.
        u_chol = torch.linalg.cholesky_ex(u_d).L
    band = None
    if want_od:
        band = band_factor(config.precond, precond_mat,
                           -e_cols.reshape(c_pad, np_cam, np_cam))
    return WTTNormal(
        u=u_d, u_chol=u_chol, g_cam=g_cols, damp_cam=damp_cam,
        buckets=tuple(bucket_normals), tridiag=band, b_cam=b_cols if fused else None,
    )


def _preconditioner(nb: WTTNormal):
    """The PCG preconditioner: the band sweeps of ``nb.tridiag``, else the
    block Cholesky solve."""
    if nb.tridiag is None:
        return cho_block_precond(nb.u_chol)
    return band_preconditioner(nb.tridiag)


def _xw_t(x_pad: torch.Tensor, bucket: WTTBucket) -> torch.Tensor:
    """(G, np, W) transposed window rows of x, contiguous for the kernels."""
    return _window_rows(x_pad, _window_idx(bucket)).transpose(1, 2).contiguous()


def _wt_times_plane(bn: WTTBucketNormal, x_pad: torch.Tensor, bucket: WTTBucket):
    """(W^T x) point planes (3, G, Pc) in PyTorch: the JAX engine's
    ``_wt_times_bucket_w`` with the one-hot selection as a ``wcam`` gather."""
    return torch.stack(_wt_x(_xw_t(x_pad, bucket), bucket.wcam, bn.jc, bn.jp))


def _w_times_plane(bn: WTTBucketNormal, y_pt: torch.Tensor, bucket: WTTBucket,
                   c_pad: int) -> torch.Tensor:
    """(W y) camera rows (c_pad, np) in PyTorch: the JAX engine's
    ``_w_times_bucket_w`` with the one-hot reduction as a ``wcam``
    scatter-add; y_pt is (3, G, Pc)."""
    rows = reduce_rows(_w_z(y_pt, bn.jc, bn.jp), bucket.wcam, bucket.window)
    return _scatter_rows(rows, _window_idx(bucket), c_pad)


def _schur_matvec(nb: WTTNormal, x_pad: torch.Tensor, problem: BAWTTProblem,
                  use_kernel=False):
    coup = torch.zeros_like(x_pad)
    for bn, bucket in zip(nb.buckets, problem.buckets):
        if use_kernel in _INDEX_TERMS:
            rows = wtt_coupling_rows_idx(
                _xw_t(x_pad, bucket), bucket.wcam, bn.jc, bn.jp, bn.v_inv,
                _INDEX_TERMS[use_kernel],
            )
        elif use_kernel:
            rows = wtt_coupling_rows_fused(
                _xw_t(x_pad, bucket), bucket.onehot, bn.jc, bn.jp, bn.v_inv
            )
        else:
            vw = _sym3_matvec(bn.v_inv, _wt_times_plane(bn, x_pad, bucket))
            coup = coup + _w_times_plane(bn, vw, bucket, problem.c_pad)
            continue
        coup = coup + _scatter_rows(
            rows.transpose(1, 2), _window_idx(bucket), problem.c_pad
        )
    return torch.matmul(nb.u, x_pad[..., None])[..., 0] - coup


def _cost(params, problem: BAWTTProblem, config: BAConfig) -> torch.Tensor:
    pts_list = params[5]
    table_pad = _padded_table(params, problem.c_pad)
    inv_w = _inv_w(problem, table_pad.dtype)
    total = table_pad.new_zeros(())
    for bucket, pts in zip(problem.buckets, pts_list):
        tw = _window_rows(table_pad, _window_idx(bucket))
        if config.linearize_kernel in ("index", "index2"):
            cols = wtt_cost_cols_idx(bucket.wcam, tw, pts, bucket.uv, bucket.mask,
                                     config.loss)
            total = total + 0.5 * (inv_w * inv_w) * torch.sum(cols)
            continue
        cpm = wtt_cam_planes_idx(bucket.wcam, tw, bucket.uv.shape[2])
        cpm = cpm.transpose(0, 1)  # (19, G, Tb, Pc)
        pb = pts[:, :, None, :]  # (3, G, 1, Pc)
        x = cpm[0] * pb[0] + cpm[1] * pb[1] + cpm[2] * pb[2] + cpm[9]
        y = cpm[3] * pb[0] + cpm[4] * pb[1] + cpm[5] * pb[2] + cpm[10]
        z = cpm[6] * pb[0] + cpm[7] * pb[1] + cpm[8] * pb[2] + cpm[11]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
        mx = x * iz
        my = y * iz
        r2 = mx * mx + my * my
        s_rad = 1.0 + cpm[17] * r2 + cpm[18] * r2 * r2
        u = cpm[12] * s_rad * mx + cpm[16] * s_rad * my + cpm[14]
        v = cpm[13] * s_rad * my + cpm[15]
        r0 = u - bucket.uv[:, 0]
        r1 = v - bucket.uv[:, 1]
        s = r0 * r0 + r1 * r1
        w = robust_weight(config.loss, s)
        total = total + 0.5 * torch.sum(s * w * (bucket.mask * inv_w) ** 2)
    return total


_MATVEC_KERNELS = (False, True, "fused", "index", "index1", "index2")
# The bfloat16 split terms of B2 per index matvec mode (3: exact).
_INDEX_TERMS = {"index": 3, "index1": 1, "index2": 2}
_LINEARIZE_KERNELS = (False, "index", "index2")


def _check_config(config: BAConfig, problem: BAWTTProblem = None) -> None:
    """The JAX engine's errors (``ValueError``) in its order, the problem's
    only when one is given; then ``matvec_bf16``, which the port does not
    take (``NotImplementedError``)."""
    indexed_mv = config.matvec_kernel in _INDEX_TERMS
    indexed_lin = config.linearize_kernel in ("index", "index2")
    if problem is not None and not (indexed_mv and indexed_lin) and any(
        b.onehot is None for b in problem.buckets
    ):
        raise ValueError(
            "problem has deferred one-hots (wtt_from_flat(defer_onehot=True));"
            " materialize them on the target device first (problems.wtt."
            "expand_onehots(problem)) — or run fully indexed"
            " (matvec_kernel + linearize_kernel 'index'*), which never"
            " reads the dense one-hot"
        )
    if config.matvec_kernel and config.matvec_bf16:
        raise ValueError(
            "matvec_bf16 applies to the XLA matvec path; disable matvec_kernel"
        )
    if config.matvec_kernel not in _MATVEC_KERNELS:
        raise ValueError(
            f"matvec_kernel must be False, True/'fused', 'index', "
            f"'index1'/'index2'; got {config.matvec_kernel!r}"
        )
    if config.linearize_kernel not in _LINEARIZE_KERNELS:
        raise ValueError(
            f"linearize_kernel must be False, 'index' or 'index2'; got "
            f"{config.linearize_kernel!r}"
        )
    if problem is not None and (indexed_mv or indexed_lin) and any(
        b.wcam is None for b in problem.buckets
    ):
        raise ValueError(
            "the index kernels need the compact window indices "
            "(WTTBucket.wcam); repack with wtt_from_flat"
        )
    if problem is not None and config.precond in _BAND and any(
        b.global_tiles for b in problem.buckets
    ):
        # The pair rows take window-row adjacency for camera adjacency, which
        # breaks at the local/global boundary of a hub split.
        raise ValueError(
            "band preconditioners (ssor/tridiag) are not supported with "
            "hub/global camera tiles; use precond='schur_jacobi'"
        )
    if config.matvec_bf16:
        raise NotImplementedError(
            "matvec_bf16 (bf16 jc/jp on the XLA matvec path, a measured "
            "negative on the TPU) is not ported (ROADMAP A.9)"
        )


def ba_solve_wtt(
    problem: BAWTTProblem, config: BAConfig = BAConfig(), device=None
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Windowed track-table BA solve on ``device`` (default: where the
    problem lives); same outputs and trust-region trajectory as the JAX
    ``ba_solve_wtt`` with the same ``matvec_kernel`` and
    ``linearize_kernel``.  Returns (cameras in original order, points in
    original order, final state)."""
    _check_config(config, problem)
    torch.set_float32_matmul_precision("highest")
    if device is not None:
        problem = problem.to(device)
    dev = problem.points3d.device
    pts_list = []
    for bucket, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, _, pc = bucket.uv.shape
        block = problem.points3d[off : off + g * pc]
        pts_list.append(block.reshape(g, pc, 3).permute(2, 0, 1).contiguous())
    cams, pts_out, final = _ba_solve_wtt_core(problem, tuple(pts_list), config, dev)
    points3d = torch.cat([p.permute(1, 2, 0).reshape(-1, 3) for p in pts_out], dim=0)
    pts = unpermute_points(points3d, problem)
    cams = unpermute_cameras(cams, problem.cam_rows)
    return cams, pts, _tt_state(cams, pts, final)


def _ba_solve_wtt_core(problem: BAWTTProblem, pts_list, config: BAConfig, dev):
    cams = problem.cameras
    dtype = pts_list[0].dtype
    n_cams = cams.rmats.shape[0]
    params0 = (
        cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew,
        pts_list,
    )

    index_mv = config.matvec_kernel in _INDEX_TERMS

    def w_times(bn, vw, bucket):
        if not index_mv:
            return _w_times_plane(bn, vw, bucket, problem.c_pad)
        rows = wtt_w_rows_idx(vw, bucket.wcam, bn.jc, bn.jp, bucket.window)
        return _scatter_rows(rows.transpose(1, 2), _window_idx(bucket), problem.c_pad)

    def wt_times(bn, dc, bucket):
        if not index_mv:
            return _wt_times_plane(bn, dc, bucket)
        return wtt_wt_planes_idx(_xw_t(dc, bucket), bucket.wcam, bn.jc, bn.jp)

    def propose(params, lam):
        nb = _linearize(params, lam, problem, config)
        gp_max = torch.zeros((), dtype=dtype, device=dev)
        for bn in nb.buckets:
            gp_max = torch.maximum(gp_max, torch.max(torch.abs(bn.g_pt)))
        grad_norm = torch.max(torch.abs(nb.g_cam))
        if config.optimize_points:
            grad_norm = torch.maximum(grad_norm, gp_max)
        else:
            grad_norm = torch.clamp(grad_norm, min=0.0)

        if nb.b_cam is not None:
            b = nb.b_cam - nb.g_cam
        else:
            b = torch.zeros_like(nb.g_cam)
            for bn, bucket in zip(nb.buckets, problem.buckets):
                vw = _sym3_matvec(bn.v_inv, bn.g_pt)
                b = b + w_times(bn, vw, bucket)
            b = b - nb.g_cam
        out = pcg(
            lambda p: _schur_matvec(nb, p, problem, config.matvec_kernel),
            _preconditioner(nb),
            b, config.cg_maxiter, config.cg_rtol,
        )
        dc = out.x

        dps = []
        pred_pt = torch.zeros((), dtype=dtype, device=dev)
        for bn, bucket in zip(nb.buckets, problem.buckets):
            wtx = wt_times(bn, dc, bucket)
            dp = _sym3_matvec(bn.v_inv, -bn.g_pt - wtx)  # (3, G, Pc)
            if not config.optimize_points:
                dp = dp * 0.0
            pred_pt = pred_pt + 0.5 * (
                torch.sum(dp * (bn.damp_pt * dp)) - torch.sum(dp * bn.g_pt)
            )
            dps.append(dp)
        pred = (
            0.5 * (torch.sum(dc * (nb.damp_cam * dc)) - torch.sum(dc * nb.g_cam))
            + pred_pt
        )
        return (dc, tuple(dps)), grad_norm, pred, out.iters

    def apply_step(params, delta):
        rmats, tvecs, fx_fy, dist, ccs, pts = params
        dc_pad, dps = delta
        dc = dc_pad[:n_cams]
        new_r, new_t, new_f = apply_se3_retraction(rmats, tvecs, fx_fy, dc[:, :8])
        off = 8
        new_d = dist
        if config.optimize_dist:
            new_d = dist + dc[:, off : off + 2]
            off += 2
        new_c = ccs
        if config.optimize_pp:
            new_c = torch.cat([ccs[:, :2] + dc[:, off : off + 2], ccs[:, 2:]], dim=1)
        new_pts = tuple(p + dp for p, dp in zip(pts, dps))
        return (new_r, new_t, new_f, new_d, new_c, new_pts)

    final = trust_region_solve(
        propose, apply_step, lambda p: _cost(p, problem, config), params0,
        config, dtype, dev,
    )
    rmats, tvecs, fx_fy, dist, ccs, pts_out = final.params
    cameras_out = CameraParams(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, cx_cy_skew=ccs, dist=dist,
    )
    return cameras_out, pts_out, final


_SOLVER_CACHE: dict = {}


def make_wtt_ba_solver(config: BAConfig = BAConfig(), aot: bool = False):
    """``problem -> ba_solve_wtt(problem, config)``, one closure per config
    (cached).  The JAX package's jit and its ``aot=True`` executable cache
    have no counterpart: PyTorch runs eagerly, and the AOT cache works
    around a TPU plugin's compile cache."""
    if aot:
        raise NotImplementedError(
            "aot=True (the persistent executable cache) is TPU-specific and "
            "not ported (ROADMAP A.9)"
        )
    _check_config(config)
    if config not in _SOLVER_CACHE:
        _SOLVER_CACHE[config] = functools.partial(ba_solve_wtt, config=config)
    return _SOLVER_CACHE[config]
