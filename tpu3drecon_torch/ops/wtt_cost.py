"""Kernel B4: the fused wtt cost.

Replaces ``tpu3drecon/ops/pallas/wtt_cost.py:wtt_cost_cols_idx`` (body
``_cost_kernel``): selects each slot's camera row through ``wcam``,
projects with radial distortion, and sums the masked robust squared
residual s * rho'(s) * mask^2 over each point column's track, giving
(G, 1, Pc).  The caller scales the sum by 0.5 * inv_w^2.

CUDA kernel (``csrc/wtt_kernels.cu:cost_kernel``): slot-major on B2's grid
(``_wtt_common.slot_geometry("cost")``), B16's design on the wtt layout.
One lane per track slot reads its window row of ``tw`` from device memory
(any window width; zeros for padding), its uv and mask, and writes its
part to shared memory; one lane per point adds the parts from zero in slot
order and writes the column once.  Where the bucket's points alone fill
the card (``_wtt_common.walks_tracks``, the largest BAL buckets) each lane
walks its point's whole track instead, with no barrier.  No atomics: the
columns are deterministic and equal ``_cost_cols_ordered``, the plain
version summed in that order, bit for bit.  On the H100 its medium pass is
bound by its launches.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.geometry.losses import LOSS_CODES, RobustLoss, robust_weight
from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import (
    check_inputs,
    check_shape,
    is_cuda_call,
    select_rows,
    slot_geometry,
    walks_tracks,
)
from tpu3drecon_torch.solvers.ba_tt import CAM_TABLE_DIM

COUNTS = _build.LaunchCounter()


def _cost_parts(wcam, tw, pts, uv, mask, loss: RobustLoss):
    """Per-slot parts s * rho'(s) * mask^2 (G, Tb, Pc) of the cost."""
    tb, pc = uv.shape[2:]
    cp = select_rows(tw, wcam, tb, pc)  # (19, G, Tb, Pc)
    px, py, pz = (pts[i][:, None, :] for i in range(3))
    x = cp[0] * px + cp[1] * py + cp[2] * pz + cp[9]
    y = cp[3] * px + cp[4] * py + cp[5] * pz + cp[10]
    z = cp[6] * px + cp[7] * py + cp[8] * pz + cp[11]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
    mx = x * iz
    my = y * iz
    r2 = mx * mx + my * my
    s_rad = 1.0 + cp[17] * r2 + cp[18] * r2 * r2
    u = cp[12] * s_rad * mx + cp[16] * s_rad * my + cp[14]
    v = cp[13] * s_rad * my + cp[15]
    r0 = u - uv[:, 0]
    r1 = v - uv[:, 1]
    s = r0 * r0 + r1 * r1
    return s * robust_weight(loss, s) * (mask * mask)


def wtt_cost_cols_idx_plain(wcam, tw, pts, uv, mask, loss: RobustLoss):
    """Plain PyTorch version of ``wtt_cost_cols_idx``."""
    COUNTS.plain += 1
    return torch.sum(_cost_parts(wcam, tw, pts, uv, mask, loss), dim=1)[:, None, :]


def _cost_cols_ordered(wcam, tw, pts, uv, mask, loss: RobustLoss):
    """The plain version's columns (G, 1, Pc) with each track summed one
    slot at a time in slot order, the kernel's order: bit-equal to the
    kernel's under ``--fmad=false``.  Tests and ``chip_smoke.py`` hold B4
    to it."""
    part = _cost_parts(wcam, tw, pts, uv, mask, loss)
    acc = part[:, 0]
    for t in range(1, part.shape[1]):
        acc = acc + part[:, t]
    return acc[:, None, :]


def wtt_cost_cols_idx(wcam, tw, pts, uv, mask, loss: RobustLoss):
    """Masked robust squared-residual column sums (G, 1, Pc) for one bucket.

    ``wcam`` (G, Tb*Pc) int16, ``tw`` (G, W, 19), ``pts`` (3, G, Pc),
    ``uv`` (G, 2, Tb, Pc), ``mask`` (G, Tb, Pc).  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if not is_cuda_call(tw):
        return wtt_cost_cols_idx_plain(wcam, tw, pts, uv, mask, loss)
    name = "wtt_cost_cols_idx"
    g, _, tb, pc = uv.shape
    window = tw.shape[1]
    check_inputs(name, tw.device, tw.dtype, wcam=wcam, tw=tw, pts=pts, uv=uv,
                 mask=mask)
    check_shape(name, "wcam", wcam, (g, tb * pc))
    check_shape(name, "tw", tw, (g, window, CAM_TABLE_DIM))
    check_shape(name, "pts", pts, (3, g, pc))
    check_shape(name, "mask", mask, (g, tb, pc))
    geo = slot_geometry("cost", tb, pc, 8, tw.element_size(), walk=walks_tracks(g * pc))
    out = torch.empty((g, 1, pc), dtype=tw.dtype, device=tw.device)
    lib = _build.library()
    code = lib.wtt_cost(
        _build.dtype_code(tw.dtype), wcam.data_ptr(), tw.data_ptr(),
        pts.data_ptr(), uv.data_ptr(), mask.data_ptr(), out.data_ptr(),
        g, tb, pc, window, LOSS_CODES[loss], geo.warps, geo.groups, geo.smem,
        _build.stream_ptr(tw.device),
    )
    _build.check(lib, name, code)
    COUNTS.launched(_build.GLOBAL)
    return out
