"""Dense track-table bundle adjustment.

Counterpart of ``tpu3drecon/solvers/ba_tt.py`` on its three routes, with
the same LM / implicit-Schur algorithm and trust-region control as the
other engines.  One LM iteration, per track-length bucket:

  1. linearize: with ``kernels=True`` or ``"full"``, kernel B12 gives the
     Jacobian planes, the point sums V and g_pt, and the camera columns
     U | g, and B13 the Schur-Jacobi columns (``schur_jacobi`` only); with
     ``kernels=False`` (the default, JAX's XLA route) PyTorch selects each
     slot's camera row through ``cam_ids``, forms the same planes and sums,
     and reduces the columns U | g [| Schur-Jacobi] [| S_{c,c+1} band pair
     rows] into cameras with ``index_add_``.  V is damped and inverted in
     closed form; the 8x8 blocks get a guarded Cholesky factorization, or
     under ``precond="ssor"``/``"tridiag"`` (``kernels=False`` only) the
     ``solvers/tridiag.py`` band factor;
  2. PCG on U x - sum W V^-1 W^T x: W^T x from kernel B14 and W y from B15
     (``"full"``), else a ``cam_ids`` gather and an ``index_add_``;
  3. Schur rhs and back-substitution by the same products;
  4. cost of the candidate: kernel B16 (``"full"``) or PyTorch;
  5. SE(3) retraction and trust-region accept/reject.

The JAX engine selects and reduces by products with the dense (C, Tb*Pb)
one-hot; the port keeps ``cam_ids`` and builds no one-hot (ROADMAP A.8), so
its XLA route gathers and scatter-adds where JAX multiplies.

Also the helpers the windowed engine (solvers/ba_wtt.py) and the kernels'
plain versions share: the packed camera table, the per-slot
residual/Jacobian planes, the closed-form symmetric 3x3 inverse, the
diagonal-major upper-triangle order and its unpacking, and the per-slot
camera row select and camera reduce through ``cam_ids``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from tpu3drecon_torch.geometry.losses import robust_weight
from tpu3drecon_torch.ops.jacobians import apply_se3_retraction
from tpu3drecon_torch.parallel.mesh import pmax, psum
from tpu3drecon_torch.problems.grid import unpermute_points
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState, n_cam_params
from tpu3drecon_torch.solvers.pcg import (
    cho_block_precond,
    cholesky_or_nan,
    guarded_block_cholesky,
    pcg,
)
from tpu3drecon_torch.solvers.tridiag import band_factor, band_preconditioner
from tpu3drecon_torch.solvers.trust_region import trust_region_solve
from tpu3drecon_torch.utils.timing import host_wait

# Column layout of the packed per-camera parameter table:
# rmat row-major (9) | tvec (3) | fx fy | cx cy skew | k1 k2.
CAM_TABLE_DIM = 19


def _cam_table(rmats, tvecs, fx_fy, cx_cy_skew, dist) -> torch.Tensor:
    C = rmats.shape[0]
    return torch.cat(
        [rmats.reshape(C, 9), tvecs, fx_fy, cx_cy_skew, dist], dim=1
    )


class TTBlocks(NamedTuple):
    r: torch.Tensor  # (2, *slot) whitened residual planes
    jc: torch.Tensor  # (2*np, *slot) camera-Jacobian planes (row0 | row1)
    jp: torch.Tensor  # (6, *slot) point-Jacobian planes (row0 0..2, row1 3..5)


def _tt_blocks(
    cam_planes: torch.Tensor,  # (19, *slot)
    pts_planes: torch.Tensor,  # (3, *slot-broadcastable)
    uv: torch.Tensor,  # (2, *slot)
    mask: torch.Tensor,  # (*slot)
    inv_w,
    config: BAConfig,
) -> TTBlocks:
    """Residual/Jacobian planes per slot (the formulas of
    ``ops.jacobians.obs_blocks`` with camera scalars as per-slot planes,
    including the radial chain A = s I + g m m^T).  Purely elementwise."""
    cp = cam_planes
    X, Y, Z = pts_planes[0], pts_planes[1], pts_planes[2]

    x = cp[0] * X + cp[1] * Y + cp[2] * Z + cp[9]
    y = cp[3] * X + cp[4] * Y + cp[5] * Z + cp[10]
    z = cp[6] * X + cp[7] * Y + cp[8] * Z + cp[11]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
    iz = 1.0 / z_safe
    fx, fy = cp[12], cp[13]
    cx, cy, sk = cp[14], cp[15], cp[16]
    k1, k2 = cp[17], cp[18]

    mx = x * iz
    my = y * iz
    r2 = mx * mx + my * my
    s_rad = 1.0 + k1 * r2 + k2 * r2 * r2
    g_rad = 2.0 * k1 + 4.0 * k2 * r2
    mdx = s_rad * mx
    mdy = s_rad * my

    u = fx * mdx + sk * mdy + cx
    v = fy * mdy + cy
    r0 = u - uv[0]
    r1 = v - uv[1]
    s = r0 * r0 + r1 * r1
    w = robust_weight(config.loss, s)
    scale = torch.sqrt(w) * mask * inv_w

    axx = s_rad + g_rad * mx * mx
    axy = g_rad * mx * my
    ayy = s_rad + g_rad * my * my
    b00 = axx * iz
    b01 = axy * iz
    b02 = -(axx * mx + axy * my) * iz
    b10 = axy * iz
    b11 = ayy * iz
    b12 = -(axy * mx + ayy * my) * iz

    a11 = fx * b00 + sk * b10
    a12 = fx * b01 + sk * b11
    a13 = fx * b02 + sk * b12
    a21 = fy * b10
    a22 = fy * b11
    a23 = fy * b12

    jr00 = -a12 * z + a13 * y
    jr01 = a11 * z - a13 * x
    jr02 = -a11 * y + a12 * x
    jr10 = -a22 * z + a23 * y
    jr11 = a21 * z - a23 * x
    jr12 = -a21 * y + a22 * x

    zero = torch.zeros_like(a11)
    jc_row0 = [jr00, jr01, jr02, a11, a12, a13, mdx, zero]
    jc_row1 = [jr10, jr11, jr12, a21, a22, a23, zero, mdy]
    if config.optimize_dist:
        du_ds = fx * mx + sk * my
        dv_ds = fy * my
        jc_row0 += [du_ds * r2, du_ds * r2 * r2]
        jc_row1 += [dv_ds * r2, dv_ds * r2 * r2]
    if config.optimize_pp:
        one = torch.ones_like(a11)
        jc_row0 += [one, zero]
        jc_row1 += [zero, one]
    jc_rows = jc_row0 + jc_row1
    jp_rows = [
        a11 * cp[0] + a12 * cp[3] + a13 * cp[6],
        a11 * cp[1] + a12 * cp[4] + a13 * cp[7],
        a11 * cp[2] + a12 * cp[5] + a13 * cp[8],
        a21 * cp[0] + a22 * cp[3] + a23 * cp[6],
        a21 * cp[1] + a22 * cp[4] + a23 * cp[7],
        a21 * cp[2] + a22 * cp[5] + a23 * cp[8],
    ]
    if not config.optimize_focal:
        np_cam = len(jc_row0)
        for k in (6, 7, np_cam + 6, np_cam + 7):
            jc_rows[k] = zero
    jc = torch.stack(jc_rows) * scale[None]
    jp = torch.stack(jp_rows) * scale[None]
    r = torch.stack([r0, r1]) * scale[None]
    if not config.optimize_points:
        jp = jp * 0.0
    return TTBlocks(r=r, jc=jc, jp=jp)


def _sym3_inv_planes(v: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of symmetric 3x3s in plane form: ``v`` holds the
    components (00, 01, 02, 11, 12, 22) on its leading axis."""
    a, b, c, d, e, f = v[0], v[1], v[2], v[3], v[4], v[5]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    det_safe = torch.where(torch.abs(det) < 1e-32, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    return torch.stack(
        [
            co_a * inv_det,
            co_b * inv_det,
            co_c * inv_det,
            (a * f - c * c) * inv_det,
            (b * c - a * e) * inv_det,
            (a * d - b * b) * inv_det,
        ]
    )


def _sym3_matvec(m6: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(3, ...) = sym3(m6) @ x with both in plane form."""
    return torch.stack(
        [
            m6[0] * x[0] + m6[1] * x[1] + m6[2] * x[2],
            m6[1] * x[0] + m6[3] * x[1] + m6[4] * x[2],
            m6[2] * x[0] + m6[4] * x[1] + m6[5] * x[2],
        ]
    )


def _triu_pairs(np_cam: int):
    """Upper-triangle (i, j) pairs in DIAGONAL-major order: all (i, i) first,
    then (i, i+1), ...  Every producer and consumer of packed upper-triangle
    columns (plain versions, CUDA kernels, ``_unpack_sym``) uses this order."""
    return [(i, i + d) for d in range(np_cam) for i in range(np_cam - d)]


def _u_g_contribs(jc, r, np_cam: int, triu) -> list:
    """Per-slot U upper-triangle and gradient planes (the plain version of
    kernel B12 uses them in this order)."""
    contribs = [jc[i] * jc[j] + jc[np_cam + i] * jc[np_cam + j] for (i, j) in triu]
    contribs += [jc[i] * r[0] + jc[np_cam + i] * r[1] for i in range(np_cam)]
    return contribs


def _coupling_contribs(jc, jp, vi_rows, np_cam: int, triu) -> list:
    """Per-slot W v_inv W^T upper-triangle planes (the exact S-diagonal
    contribution; ``vi_rows`` is the symmetric 3x3 of v_inv planes,
    broadcastable against the slot shape)."""
    w_slot = [
        [jc[i] * jp[l] + jc[np_cam + i] * jp[3 + l] for l in range(3)]
        for i in range(np_cam)
    ]
    wv = [
        [sum(w_slot[i][j] * vi_rows[j][l] for j in range(3)) for l in range(3)]
        for i in range(np_cam)
    ]
    return [sum(wv[i][l] * w_slot[j][l] for l in range(3)) for (i, j) in triu]


_SYM3 = ((0, 1, 2), (1, 3, 4), (2, 4, 5))  # sym3 rows of the 6-plane packing
_BAND = ("tridiag", "ssor")


def _u_g_contribs_batched(jc, r, np_cam: int) -> torch.Tensor:
    """Stacked (n_triu + np, *slot) U upper-triangle | gradient planes, in
    the diagonal-major ``_triu_pairs`` order: the values and order of
    ``_u_g_contribs`` built from slices (JAX ``ba_tt.py:323-352``)."""
    jc0, jc1 = jc[:np_cam], jc[np_cam:]
    u = [jc0[: np_cam - d] * jc0[d:] + jc1[: np_cam - d] * jc1[d:] for d in range(np_cam)]
    return torch.cat(u + [jc0 * r[0][None] + jc1 * r[1][None]], dim=0)


def _coupling_offdiag_batched(jc, jp, v_inv, np_cam: int, want_od: bool):
    """(coup (n_triu, *slot), od): the Schur-Jacobi planes W V^-1 W^T in the
    diagonal-major order and, with ``want_od``, the band pair planes
    od[i, j] = sum_l wv[i, l] (slot t) w[j, l] (slot t + 1), (np, np,
    Tb - 1, Pb) (JAX ``ba_tt.py:360-408``); ``v_inv`` (6, Pb) broadcasts
    over the track axis."""
    slot = jc.shape[1:]
    jc2 = jc.reshape((2, np_cam) + slot)
    jp2 = jp.reshape((2, 3) + slot)
    # w[i, l] = sum_a jc2[a, i] jp2[a, l], (np, 3, *slot)
    w = jc2[0][:, None] * jp2[0][None, :] + jc2[1][:, None] * jp2[1][None, :]
    with host_wait("sym3_index"):  # a copy from pageable host memory
        sym3 = torch.tensor(_SYM3, device=v_inv.device)
    vi = v_inv[sym3]  # (3, 3, Pb)
    while vi.ndim - 2 < len(slot):
        vi = vi[:, :, None]
    # wv[i, l] = sum_j w[i, j] vi[j, l]
    wv = w[:, 0:1] * vi[0][None] + w[:, 1:2] * vi[1][None] + w[:, 2:3] * vi[2][None]
    coup = torch.cat([
        wv[: np_cam - d, 0] * w[d:, 0] + wv[: np_cam - d, 1] * w[d:, 1]
        + wv[: np_cam - d, 2] * w[d:, 2]
        for d in range(np_cam)
    ], dim=0)
    od = None
    if want_od:
        wva, wb = wv[..., :-1, :], w[..., 1:, :]
        od = wva[:, None, 0] * wb[None, :, 0]
        od = od + wva[:, None, 1] * wb[None, :, 1]
        od = od + wva[:, None, 2] * wb[None, :, 2]
    return coup, od


def _slot_cams(cam_ids, mask, n_cams: int) -> torch.Tensor:
    """(Tb, Pb) int64 camera row per slot; padded slots get ``n_cams``, the
    index of the all-zero row (JAX's masked one-hot column)."""
    return torch.where(mask > 0, cam_ids.long(), torch.full_like(cam_ids, n_cams).long())


def _select(rows, idx) -> torch.Tensor:
    """(D, Tb, Pb) per-slot rows of ``rows`` (C, D); index C is all zero:
    JAX's ``_cam_planes`` one-hot product as a gather."""
    padded = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    return padded[idx].permute(2, 0, 1)


def _reduce(planes, idx, n_cams: int) -> torch.Tensor:
    """Sum slot planes (K, Tb, Pb) into camera rows (C, K); index C
    (padding) is dropped: JAX's ``_reduce_to_cams`` as an ``index_add_``."""
    k = planes.shape[0]
    out = planes.new_zeros(n_cams + 1, k)
    out.index_add_(0, idx.reshape(-1), planes.reshape(k, -1).T)
    return out[:n_cams]


def _pair_rows(od, idx, n_cams: int) -> torch.Tensor:
    """Band pair rows (C, np^2) of one bucket from the od planes (np^2,
    Tb - 1, Pb): slot pair (t, t + 1) adds into camera c where slot t is
    real on camera c and slot t + 1 real on camera (c + 1) mod C.  JAX
    masks with the one-hot times its roll by one camera
    (``ba_tt.py:602-611``), and the roll pairs camera C - 1 with camera 0,
    so the modulo keeps that pair too.  Tb = 1 gives zeros."""
    prev, cur = idx[:-1], idx[1:]
    pair = (prev < n_cams) & (cur < n_cams) & (cur == (prev + 1) % n_cams)
    return _reduce(od, torch.where(pair, prev, torch.full_like(prev, n_cams)), n_cams)


def _unpack_sym(cols: torch.Tensor, np_cam: int) -> torch.Tensor:
    """(C, np(np+1)/2) upper-triangle columns -> (C, np, np) symmetric."""
    pairs = _triu_pairs(np_cam)
    # Copies from pageable host memory: each waits for the card's stream.
    with host_wait("unpack_sym"):
        i_idx = torch.tensor([i for i, _ in pairs], device=cols.device)
    with host_wait("unpack_sym"):
        j_idx = torch.tensor([j for _, j in pairs], device=cols.device)
    out = torch.zeros(
        (cols.shape[0], np_cam, np_cam), dtype=cols.dtype, device=cols.device
    )
    out[:, i_idx, j_idx] = cols
    out[:, j_idx, i_idx] = cols
    return out


def _tt_state(cams: CameraParams, points3d: torch.Tensor, final) -> BAState:
    return BAState(
        rmats=cams.rmats, tvecs=cams.tvecs, fx_fy=cams.fx_fy,
        points3d=points3d, loss=final.loss, lam=final.lam, nu=final.nu,
        iter_num=final.iter_num, accepted=final.accepted,
        grad_norm=final.grad_norm, converged=final.converged,
        cg_iters=final.cg_iters, gain=final.gain,
    )


class TTBucketNormal(NamedTuple):
    jc: torch.Tensor  # (2*np, Tb, Pb)
    jp: torch.Tensor  # (6, Tb, Pb)
    v_inv: torch.Tensor  # (6, Pb) sym planes
    g_pt: torch.Tensor  # (3, Pb)
    damp_pt: torch.Tensor  # (3, Pb)


class TTNormal(NamedTuple):
    u: torch.Tensor  # (C, np, np) damped
    u_chol: torch.Tensor  # (C, np, np) cholesky of the preconditioner
    g_cam: torch.Tensor  # (C, np)
    damp_cam: torch.Tensor  # (C, np)
    buckets: Tuple[TTBucketNormal, ...]
    # TridiagFactor / SSORFactor under precond "tridiag" / "ssor", else None.
    tridiag: object = None


# The engine below imports ops/tt_linearize inside its functions, as the
# JAX engine does: that module imports this one's slot formulas.


def _inv_w(problem, dtype) -> torch.Tensor:
    return (1.0 / problem.avg_cam_width).to(dtype)


def _damped_inverse(v6, lam):
    """(v_inv, damp_pt): V damped by lam * max(V_ii, 1e-8) and inverted."""
    damp_pt = torch.stack([lam * torch.clamp(v6[k], min=1e-8) for k in (0, 3, 5)])
    v6_d = torch.stack(
        [v6[0] + damp_pt[0], v6[1], v6[2], v6[3] + damp_pt[1], v6[4], v6[5] + damp_pt[2]]
    )
    return _sym3_inv_planes(v6_d), damp_pt


def _linearize(params, lam, problem, config: BAConfig, kernels, slots, comm=None) -> TTNormal:
    """The damped normal of one LM iteration; ``slots`` are the buckets'
    ``_slot_cams``; the camera columns are summed over ``comm``'s ranks."""
    from tpu3drecon_torch.ops.tt_linearize import tt_cam_normal_fused, tt_coupling_fused

    rmats, tvecs, fx_fy, dist, ccs, pts_list = params
    dtype = pts_list[0].dtype
    n_cams = rmats.shape[0]
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    inv_w = _inv_w(problem, dtype)
    np_cam = n_cam_params(config)
    n_triu = np_cam * (np_cam + 1) // 2
    want_od = config.precond in _BAND
    use_sj = config.precond == "schur_jacobi" or (not kernels and want_od)
    u_cols = table.new_zeros(n_cams, n_triu)
    g_cols = table.new_zeros(n_cams, np_cam)
    coup_cols = table.new_zeros(n_cams, n_triu)
    e_cols = table.new_zeros(n_cams, np_cam * np_cam)
    bucket_normals = []
    for bucket, pts, idx in zip(problem.buckets, pts_list, slots):
        if kernels:
            jc, jp, v6, g_pt, ug = tt_cam_normal_fused(
                table, bucket.cam_ids, pts, bucket.uv, bucket.mask, inv_w, config, np_cam
            )
            v_inv, damp_pt = _damped_inverse(v6, lam)
            u_cols = u_cols + ug[:, :n_triu]
            g_cols = g_cols + ug[:, n_triu:]
            if use_sj:
                coup_cols = coup_cols + tt_coupling_fused(
                    bucket.cam_ids, bucket.mask, jc, jp, v_inv, n_cams
                )
            bucket_normals.append(TTBucketNormal(jc, jp, v_inv, g_pt, damp_pt))
            continue
        # JAX's XLA route: the one-hot products as a cam_ids gather and
        # index_add_ (ba_tt.py:565-618).
        r, jc, jp = _tt_blocks(_select(table, idx), pts[:, None, :], bucket.uv,
                               bucket.mask, inv_w, config)
        v6 = torch.stack([torch.sum(jp[i] * jp[j] + jp[3 + i] * jp[3 + j], dim=0)
                          for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))])
        g_pt = torch.stack([torch.sum(jp[i] * r[0] + jp[3 + i] * r[1], dim=0)
                            for i in range(3)])
        v_inv, damp_pt = _damped_inverse(v6, lam)
        contribs = _u_g_contribs_batched(jc, r, np_cam)
        if use_sj:
            coup, od = _coupling_offdiag_batched(jc, jp, v_inv, np_cam, want_od)
            contribs = torch.cat([contribs, coup], dim=0)
        reduced = _reduce(contribs, idx, n_cams)
        u_cols = u_cols + reduced[:, :n_triu]
        g_cols = g_cols + reduced[:, n_triu : n_triu + np_cam]
        if use_sj:
            coup_cols = coup_cols + reduced[:, n_triu + np_cam :]
        if want_od:
            e_cols = e_cols + _pair_rows(od.reshape(np_cam * np_cam, *od.shape[2:]), idx,
                                         n_cams)
        bucket_normals.append(TTBucketNormal(jc, jp, v_inv, g_pt, damp_pt))

    u_cols = psum(u_cols, comm)
    g_cols = psum(g_cols, comm)
    if use_sj:
        coup_cols = psum(coup_cols, comm)
    u0 = _unpack_sym(u_cols, np_cam)
    eye = torch.eye(np_cam, dtype=dtype, device=u0.device)
    du = torch.clamp(torch.diagonal(u0, dim1=-2, dim2=-1), min=1e-8)
    damp_cam = lam * du
    u_d = u0 + damp_cam[..., None] * eye
    if use_sj:
        precond_mat = u_d - _unpack_sym(coup_cols, np_cam)
        u_chol = guarded_block_cholesky(precond_mat, u_d)
    else:
        u_chol = cholesky_or_nan(u_d)
    band = None
    if want_od:
        band = band_factor(config.precond, precond_mat,
                           -psum(e_cols, comm).reshape(n_cams, np_cam, np_cam))
    return TTNormal(u=u_d, u_chol=u_chol, g_cam=g_cols, damp_cam=damp_cam,
                    buckets=tuple(bucket_normals), tridiag=band)


def _wt_times(bn: TTBucketNormal, x, bucket, idx, full: bool) -> torch.Tensor:
    """(W^T x) point planes (3, Pb) of one bucket: kernel B14, or JAX's
    ``_wt_times_bucket`` with the one-hot product as a gather."""
    if full:
        from tpu3drecon_torch.ops.tt_linearize import tt_wt_times_fused

        return tt_wt_times_fused(x, bucket.cam_ids, bucket.mask, bn.jc, bn.jp)
    np_cam = bn.jc.shape[0] // 2
    xg = _select(x, idx)  # (np, Tb, Pb)
    s0 = sum(bn.jc[i] * xg[i] for i in range(np_cam))
    s1 = sum(bn.jc[np_cam + i] * xg[i] for i in range(np_cam))
    return torch.stack([torch.sum(bn.jp[l] * s0 + bn.jp[3 + l] * s1, dim=0)
                        for l in range(3)])


def _w_times(bn: TTBucketNormal, y, bucket, idx, n_cams: int, full: bool) -> torch.Tensor:
    """(W y) camera rows (C, np) of one bucket's point planes ``y`` (3, Pb):
    kernel B15, or JAX's ``_w_times_bucket`` with the one-hot reduction as
    an ``index_add_``."""
    if full:
        from tpu3drecon_torch.ops.tt_linearize import tt_w_times_fused

        return tt_w_times_fused(y, bucket.cam_ids, bucket.mask, bn.jc, bn.jp, n_cams)
    np_cam = bn.jc.shape[0] // 2
    s0 = bn.jp[0] * y[0][None] + bn.jp[1] * y[1][None] + bn.jp[2] * y[2][None]
    s1 = bn.jp[3] * y[0][None] + bn.jp[4] * y[1][None] + bn.jp[5] * y[2][None]
    z = torch.stack([bn.jc[i] * s0 + bn.jc[np_cam + i] * s1 for i in range(np_cam)])
    return _reduce(z, idx, n_cams)


def _schur_matvec(nb: TTNormal, x: torch.Tensor, problem, slots, full: bool,
                  comm=None) -> torch.Tensor:
    coup = torch.zeros_like(x)
    for bn, bucket, idx in zip(nb.buckets, problem.buckets, slots):
        y = _sym3_matvec(bn.v_inv, _wt_times(bn, x, bucket, idx, full))
        coup = coup + _w_times(bn, y, bucket, idx, problem.n_cameras, full)
    return torch.einsum("cij,cj->ci", nb.u, x) - psum(coup, comm)


def _cost(params, problem, config: BAConfig, slots, full: bool, comm=None) -> torch.Tensor:
    from tpu3drecon_torch.ops.tt_linearize import tt_cost_fused

    rmats, tvecs, fx_fy, dist, ccs, pts_list = params
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    inv_w = _inv_w(problem, table.dtype)
    total = table.new_zeros(())
    for bucket, pts, idx in zip(problem.buckets, pts_list, slots):
        if full:
            total = total + tt_cost_fused(
                table, bucket.cam_ids, pts, bucket.uv, bucket.mask, inv_w, config
            )
            continue
        cp = _select(table, idx)  # JAX ba_tt.py:718-734
        x = cp[0] * pts[0][None] + cp[1] * pts[1][None] + cp[2] * pts[2][None] + cp[9]
        y = cp[3] * pts[0][None] + cp[4] * pts[1][None] + cp[5] * pts[2][None] + cp[10]
        z = cp[6] * pts[0][None] + cp[7] * pts[1][None] + cp[8] * pts[2][None] + cp[11]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
        mx = x * iz
        my = y * iz
        r2 = mx * mx + my * my
        s_rad = 1.0 + cp[17] * r2 + cp[18] * r2 * r2
        u = cp[12] * s_rad * mx + cp[16] * s_rad * my + cp[14]
        v = cp[13] * s_rad * my + cp[15]
        r0 = u - bucket.uv[0]
        r1 = v - bucket.uv[1]
        s = r0 * r0 + r1 * r1
        w = robust_weight(config.loss, s)
        total = total + 0.5 * torch.sum(s * w * (bucket.mask * inv_w) ** 2)
    return psum(total, comm)


def _check_config(config: BAConfig, kernels) -> None:
    """The JAX engine's errors (``ValueError``) in its order, then the
    option the port does not take (``NotImplementedError``)."""
    if kernels and config.precond in _BAND:
        raise ValueError(
            f"precond={config.precond!r} is not fused yet; use kernels=False"
        )
    if kernels and config.matvec_bf16:
        raise ValueError("matvec_bf16 applies to the XLA matvec path; use kernels=False")
    if config.matvec_bf16:
        raise NotImplementedError(
            "matvec_bf16 (bf16 jc/jp on the XLA matvec path, a measured "
            "negative on the TPU) is not ported (ROADMAP A.8)"
        )


def ba_solve_tt(
    problem, config: BAConfig = BAConfig(), kernels=False
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Track-table BA solve where the problem lives; same outputs and
    trust-region trajectory as the JAX ``ba_solve_tt`` with the same
    ``kernels``: False (the default; PyTorch products through ``cam_ids``),
    True (kernels B12 and B13, PyTorch matvecs and cost) or ``"full"``
    (kernels B12-B16).  Returns (cameras, points in original order, final
    state)."""
    _check_config(config, kernels)
    torch.set_float32_matmul_precision("highest")
    pts_list = tuple(
        problem.points3d[off : off + bucket.mask.shape[1]].T.contiguous()
        for bucket, off in zip(problem.buckets, problem.bucket_offsets)
    )
    cams, pts_out, final = _ba_solve_tt_core(problem, pts_list, config, kernels)
    points3d = torch.cat([p.T for p in pts_out], dim=0)
    pts = unpermute_points(points3d, problem)
    return cams, pts, _tt_state(cams, pts, final)


def _ba_solve_tt_core(problem, pts_list, config: BAConfig, kernels, comm=None):
    """The solve body: one device (``comm`` None), or one rank's point
    shard of every bucket (``parallel/sharded_tt.py``), the camera sums,
    the cost and the predicted reduction all-reduced over ``comm``."""
    cams = problem.cameras
    dtype = pts_list[0].dtype
    dev = pts_list[0].device
    n_cams = problem.n_cameras
    full = kernels == "full"
    slots = tuple(_slot_cams(b.cam_ids, b.mask, n_cams) for b in problem.buckets)
    params0 = (
        cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew, pts_list,
    )

    def propose(params, lam):
        nb = _linearize(params, lam, problem, config, kernels, slots, comm)
        gp_max = torch.zeros((), dtype=dtype, device=dev)
        for bn in nb.buckets:
            gp_max = torch.maximum(gp_max, torch.max(torch.abs(bn.g_pt)))
        grad_norm = torch.max(torch.abs(nb.g_cam))
        if config.optimize_points:
            grad_norm = torch.maximum(grad_norm, pmax(gp_max, comm))
        else:
            grad_norm = torch.clamp(grad_norm, min=0.0)

        b = torch.zeros_like(nb.g_cam)
        for bn, bucket, idx in zip(nb.buckets, problem.buckets, slots):
            b = b + _w_times(bn, _sym3_matvec(bn.v_inv, bn.g_pt), bucket, idx, n_cams, full)
        b = psum(b, comm) - nb.g_cam
        precond = (cho_block_precond(nb.u_chol) if nb.tridiag is None
                   else band_preconditioner(nb.tridiag))
        out = pcg(lambda p: _schur_matvec(nb, p, problem, slots, full, comm), precond,
                  b, config.cg_maxiter, config.cg_rtol)
        dc = out.x

        dps = []
        pred_pt = torch.zeros((), dtype=dtype, device=dev)
        for bn, bucket, idx in zip(nb.buckets, problem.buckets, slots):
            wtx = _wt_times(bn, dc, bucket, idx, full)
            dp = _sym3_matvec(bn.v_inv, -bn.g_pt - wtx)  # (3, Pb)
            if not config.optimize_points:
                dp = dp * 0.0
            pred_pt = pred_pt + 0.5 * (
                torch.sum(dp * (bn.damp_pt * dp)) - torch.sum(dp * bn.g_pt)
            )
            dps.append(dp)
        pred = (
            0.5 * (torch.sum(dc * (nb.damp_cam * dc)) - torch.sum(dc * nb.g_cam))
            + psum(pred_pt, comm)
        )
        return (dc, tuple(dps)), grad_norm, pred, out.iters

    def apply_step(params, delta):
        rmats, tvecs, fx_fy, dist, ccs, pts = params
        dc, dps = delta
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
        propose, apply_step, lambda p: _cost(p, problem, config, slots, full, comm), params0,
        config, dtype, dev,
    )
    rmats, tvecs, fx_fy, dist, ccs, pts_out = final.params
    cameras_out = CameraParams(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, cx_cy_skew=ccs, dist=dist,
    )
    return cameras_out, pts_out, final


def make_tt_ba_solver(config: BAConfig = BAConfig(), kernels=False):
    """``problem -> ba_solve_tt(problem, config, kernels)``; the JAX
    package's jit and solver caches have no counterpart (PyTorch runs
    eagerly)."""
    _check_config(config, kernels)
    return functools.partial(ba_solve_tt, config=config, kernels=kernels)
