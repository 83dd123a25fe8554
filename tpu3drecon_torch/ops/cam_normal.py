"""Kernel B9: the fused camera-side linearization of the grid engine.

Replaces ``tpu3drecon/ops/pallas/cam_normal.py:cam_normal_fused`` (body
``_cam_normal_kernel``).  Per camera row of the (C, K) observation grid it
projects the grid-gathered world points (radial distortion, IRLS weight of
the robust loss) and returns the whitened planes r (C, 2, K), jp (C, 6, K)
and jc (C, 16, K) with the camera block U = sum_k jc^T jc (C, 8, 8) and
gradient g = sum_k jc^T r (C, 8).  Camera parameters ride as (C, 24) rows
(``pack_camera_params``).  Masked lanes give exact zeros.

CUDA kernel (``csrc/grid_kernels.cu:cam_normal_kernel``): one block per
camera row, threads striding over K; the Jacobian rows stay in registers
and U/g are 44 register partials per thread, reduced once per block.  On
the H100 it is bound by the bytes of its planes (6 read, 24 written); 100
camera rows fill under one wave of the 132 SMs.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.geometry.losses import LOSS_CODES, RobustLoss, robust_weight
from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import check_inputs, check_shape, is_cuda_call

COUNTS = _build.LaunchCounter()

# Camera parameter row layout:
# [R row-major 9 | t 3 | fx fy 2 | cx cy skew 3 | inv_width 1 | k1 k2 2 | pad].
PARAM_WIDTH = 24


def pack_camera_params(rmats, tvecs, fx_fy, cx_cy_skew, inv_width, dist) -> torch.Tensor:
    """(C, 24) parameter rows for the kernel; ``inv_width`` is a 0-d
    tensor (or a float), broadcast without a host sync."""
    c = rmats.shape[0]
    dtype = rmats.dtype
    inv = torch.as_tensor(inv_width, dtype=dtype, device=rmats.device)
    flat = torch.cat(
        [
            rmats.reshape(c, 9),
            tvecs,
            fx_fy,
            cx_cy_skew,
            inv.reshape(1, 1).expand(c, 1),
            dist.to(dtype),
        ],
        dim=1,
    )
    return torch.nn.functional.pad(flat, (0, PARAM_WIDTH - flat.shape[1]))


def cam_normal_fused_plain(
    rmats, tvecs, fx_fy, cx_cy_skew, dist, x_w, uv, mask, inv_width,
    loss: RobustLoss = RobustLoss.TRIVIAL,
):
    """Plain PyTorch version of ``cam_normal_fused``: the JAX kernel's
    plane arithmetic, operation for operation, on (C, K) planes."""
    COUNTS.plain += 1
    params = pack_camera_params(rmats, tvecs, fx_fy, cx_cy_skew, inv_width, dist)
    p = [params[:, i : i + 1] for i in range(20)]  # (C, 1) columns
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = p[:9]
    t0, t1, t2, fx, fy, cx, cy, sk, inv_w, k1, k2 = p[9:20]
    xw0, xw1, xw2 = x_w[:, 0], x_w[:, 1], x_w[:, 2]

    x = r00 * xw0 + r01 * xw1 + r02 * xw2 + t0
    y = r10 * xw0 + r11 * xw1 + r12 * xw2 + t1
    z = r20 * xw0 + r21 * xw1 + r22 * xw2 + t2
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
    iz = 1.0 / z_safe
    mx = x * iz
    my = y * iz
    rr2 = mx * mx + my * my
    s_rad = 1.0 + k1 * rr2 + k2 * rr2 * rr2
    g_rad = 2.0 * k1 + 4.0 * k2 * rr2
    mdx = s_rad * mx
    mdy = s_rad * my
    u_px = fx * mdx + sk * mdy + cx
    v_px = fy * mdy + cy
    r0 = u_px - uv[:, 0]
    r1 = v_px - uv[:, 1]
    s = r0 * r0 + r1 * r1
    scale = torch.sqrt(robust_weight(loss, s)) * mask * inv_w

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
    zero = torch.zeros_like(a11)

    jc0 = torch.stack([
        (-a12 * z + a13 * y) * scale, (a11 * z - a13 * x) * scale,
        (-a11 * y + a12 * x) * scale, a11 * scale, a12 * scale, a13 * scale,
        mdx * scale, zero,
    ], dim=1)
    jc1 = torch.stack([
        (-a22 * z + a23 * y) * scale, (a21 * z - a23 * x) * scale,
        (-a21 * y + a22 * x) * scale, a21 * scale, a22 * scale, a23 * scale,
        zero, mdy * scale,
    ], dim=1)
    jp = torch.stack([
        (a11 * r00 + a12 * r10 + a13 * r20) * scale,
        (a11 * r01 + a12 * r11 + a13 * r21) * scale,
        (a11 * r02 + a12 * r12 + a13 * r22) * scale,
        (a21 * r00 + a22 * r10 + a23 * r20) * scale,
        (a21 * r01 + a22 * r11 + a23 * r21) * scale,
        (a21 * r02 + a22 * r12 + a23 * r22) * scale,
    ], dim=1)
    rw0 = r0 * scale
    rw1 = r1 * scale

    # U[i][j] = sum_k jc0_i jc0_j + jc1_i jc1_j (symmetric bit for bit),
    # g[i] = sum_k jc0_i rw0 + jc1_i rw1.
    u = torch.sum(
        jc0[:, :, None] * jc0[:, None] + jc1[:, :, None] * jc1[:, None], dim=-1
    )
    g = torch.sum(jc0 * rw0[:, None] + jc1 * rw1[:, None], dim=-1)
    return torch.stack([rw0, rw1], dim=1), jp, torch.cat([jc0, jc1], dim=1), u, g


def cam_normal_fused(
    rmats, tvecs, fx_fy, cx_cy_skew, dist, x_w, uv, mask, inv_width,
    loss: RobustLoss = RobustLoss.TRIVIAL,
):
    """(r (C,2,K), jp (C,6,K), jc (C,16,K), U (C,8,8), g (C,8)).

    ``rmats`` (C,3,3), ``tvecs`` (C,3), ``fx_fy`` (C,2), ``cx_cy_skew``
    (C,3), ``dist`` (C,2) radial (k1, k2); ``x_w`` (C,3,K) grid-gathered
    world points, ``uv`` (C,2,K) observations, ``mask`` (C,K); ``inv_width``
    a 0-d tensor.  CPU tensors run the plain version, CUDA tensors the
    kernel."""
    if not is_cuda_call(x_w):
        return cam_normal_fused_plain(
            rmats, tvecs, fx_fy, cx_cy_skew, dist, x_w, uv, mask, inv_width, loss
        )
    name = "cam_normal_fused"
    c, _, k = x_w.shape
    dtype, dev = x_w.dtype, x_w.device
    params = pack_camera_params(rmats, tvecs, fx_fy, cx_cy_skew, inv_width, dist)
    check_inputs(name, dev, dtype, params=params, x_w=x_w, uv=uv, mask=mask)
    check_shape(name, "params", params, (c, PARAM_WIDTH))
    check_shape(name, "uv", uv, (c, 2, k))
    check_shape(name, "mask", mask, (c, k))
    r = torch.empty((c, 2, k), dtype=dtype, device=dev)
    jp = torch.empty((c, 6, k), dtype=dtype, device=dev)
    jc = torch.empty((c, 16, k), dtype=dtype, device=dev)
    u = torch.empty((c, 8, 8), dtype=dtype, device=dev)
    g = torch.empty((c, 8), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.grid_cam_normal(
        _build.dtype_code(dtype), params.data_ptr(), x_w.data_ptr(),
        uv.data_ptr(), mask.data_ptr(), r.data_ptr(), jp.data_ptr(),
        jc.data_ptr(), u.data_ptr(), g.data_ptr(), c, k, LOSS_CODES[loss],
        _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    return r, jp, jc, u, g
