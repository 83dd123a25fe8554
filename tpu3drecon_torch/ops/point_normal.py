"""Kernel B10: the point-side normal-equation reduction of the grid engine.

Replaces ``tpu3drecon/ops/pallas/point_normal.py:point_normal_fused``
(body ``_point_normal_kernel``).  From the residual and point-Jacobian rows
gathered through a track bucket it forms, per point,

  - V_p     = sum_t Jp_t^T Jp_t        (3x3)
  - damp_p  = lam * max(diag V_p, diag_floor)
  - v_inv_p = (V_p + diag damp_p)^-1   closed-form adjugate
  - g_p     = sum_t Jp_t^T r_t

CUDA kernel (``csrc/grid_kernels.cu:point_normal_kernel``): one thread per
point, its T2 rows read in order, every sum and the inverse in registers;
the ragged edge of P is masked, so P needs no padding.  On the H100 it is
bound by the bytes of jp_g/r_g (16 B per row in f32).  The TPU kernel's
split of jp_g into three column planes only avoided Mosaic's lane padding
and is not kept.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import check_inputs, check_shape, is_cuda_call

COUNTS = _build.LaunchCounter()


def point_normal_fused_plain(jp_g, r_g, lam, diag_floor: float = 1e-8):
    """Plain PyTorch version of ``point_normal_fused``; sums the track rows
    in order (the kernel's order) and inverts with the JAX kernel's
    cofactor layout."""
    COUNTS.plain += 1
    zero = jp_g.new_zeros(jp_g.shape[0])
    v00 = v01 = v02 = v11 = v12 = v22 = g0 = g1 = g2 = zero
    for t in range(jp_g.shape[1]):
        c0, c1, c2 = jp_g[:, t, 0], jp_g[:, t, 1], jp_g[:, t, 2]
        rt = r_g[:, t]
        v00 = v00 + c0 * c0
        v01 = v01 + c0 * c1
        v02 = v02 + c0 * c2
        v11 = v11 + c1 * c1
        v12 = v12 + c1 * c2
        v22 = v22 + c2 * c2
        g0 = g0 + c0 * rt
        g1 = g1 + c1 * rt
        g2 = g2 + c2 * rt
    d0 = lam * torch.clamp(v00, min=diag_floor)
    d1 = lam * torch.clamp(v11, min=diag_floor)
    d2 = lam * torch.clamp(v22, min=diag_floor)
    a, b, c = v00 + d0, v01, v02
    d, e, f = v01, v11 + d1, v12
    gg, h, i = v02, v12, v22 + d2
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + gg * co_c
    det_safe = torch.where(torch.abs(det) < 1e-32, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    v_inv = torch.stack([
        co_a, co_b, co_c,
        f * gg - d * i, a * i - c * gg, c * d - a * f,
        d * h - e * gg, b * gg - a * h, a * e - b * d,
    ], dim=-1) * inv_det[:, None]
    return (
        v_inv.reshape(-1, 3, 3),
        torch.stack([g0, g1, g2], dim=-1),
        torch.stack([d0, d1, d2], dim=-1),
    )


def point_normal_fused(jp_g, r_g, lam, diag_floor: float = 1e-8):
    """(v_inv (P,3,3), g_pt (P,3), damp_pt (P,3)).

    ``jp_g`` (P, T2, 3) track-gathered whitened point Jacobians, ``r_g``
    (P, T2) residuals, ``lam`` a 0-d tensor.  CPU tensors run the plain
    version, CUDA tensors the kernel."""
    if not is_cuda_call(jp_g):
        return point_normal_fused_plain(jp_g, r_g, lam, diag_floor)
    name = "point_normal_fused"
    p, t2, _ = jp_g.shape
    dtype, dev = jp_g.dtype, jp_g.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    check_inputs(name, dev, dtype, jp_g=jp_g, r_g=r_g, lam=lam)
    check_shape(name, "jp_g", jp_g, (p, t2, 3))
    check_shape(name, "r_g", r_g, (p, t2))
    check_shape(name, "lam", lam, ())
    v_inv = torch.empty((p, 3, 3), dtype=dtype, device=dev)
    g = torch.empty((p, 3), dtype=dtype, device=dev)
    damp = torch.empty((p, 3), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.grid_point_normal(
        _build.dtype_code(dtype), jp_g.data_ptr(), r_g.data_ptr(), lam.data_ptr(),
        v_inv.data_ptr(), g.data_ptr(), damp.data_ptr(), p, t2, float(diag_floor),
        _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    return v_inv, g, damp
