"""Track-table helpers shared by the windowed track-table engine.

Counterpart of the helpers in ``tpu3drecon/solvers/ba_tt.py:47-55,
99-261, 411-419, 463-465, 771-778`` that ``solvers/ba_wtt.py`` imports:
the packed camera table, the per-slot residual/Jacobian planes, the
closed-form symmetric 3x3 inverse, the diagonal-major upper-triangle
order and its unpacking.  The dense track-table engine itself is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drecon_torch.geometry.losses import robust_weight
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState

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


def _unpack_sym(cols: torch.Tensor, np_cam: int) -> torch.Tensor:
    """(C, np(np+1)/2) upper-triangle columns -> (C, np, np) symmetric."""
    pairs = _triu_pairs(np_cam)
    i_idx = torch.tensor([i for i, _ in pairs], device=cols.device)
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
