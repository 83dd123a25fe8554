"""Kernel B9: the fused camera-side linearization of the grid engine.

Replaces ``tpu3drecon/ops/pallas/cam_normal.py:cam_normal_fused`` (body
``_cam_normal_kernel``).  Per camera row of the (C, K) observation grid it
projects the world points (radial distortion, IRLS weight of the robust
loss) and returns the whitened planes r (C, 2, K), jp (C, 6, K) and jc
(C, 16, K) with the camera block U = sum_k jc^T jc (C, 8, 8) and gradient
g = sum_k jc^T r (C, 8).  Masked lanes give exact zeros.

Two entry points, one kernel: ``cam_normal_fused`` keeps JAX's signature
(the points gathered onto the grid as x_w planes (C, 3, K)), and
``cam_normal_idx``, what the grid solve calls, reads each lane's point
``points3d[pt_idx[c, k]]`` itself, so no gathered planes are written.

CUDA kernel (``csrc/grid_kernels.cu:grid_cam_normal_kernel``): one block
per camera row, each thread taking ``grid_lanes``' LPT consecutive lanes
per step (one vector per plane where K and the addresses allow it); the
Jacobian rows stay in registers and U/g are 44 register partials per
thread, reduced per block by a halving reduce-scatter: no atomics, two
calls are bit-equal, and at LPT 1 the sums are the first port's bit for
bit.  The camera tensors are read where they live (20 values per block),
so the TPU kernel's packed parameter rows (``pack_camera_params``, a
scalar table for Mosaic) serve only the plain version.  On the H100 it is
bound by the bytes of its planes (6 read, 24 written).
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

THREADS = 256  # threads per block (csrc kBlock)
LANES = (1, 4)  # consecutive lanes per thread per step the C entries take; 4 in float32 only


def grid_lanes(k: int, itemsize: int) -> int:
    """LPT, the consecutive lanes each thread of B9 and B11 takes per step
    on camera rows of ``k`` lanes of ``itemsize``-byte values: 4 (one
    16-byte vector per plane) in float32 where each of a block's 256
    threads still takes two steps or more (K >= 2048), else 1, the first
    port's lanes x, x + 256, ..., whose sums it repeats bit for bit.
    From ``benchmark/wtt_bucket_times.py --grid`` on the H100: at the
    medium grid's K = 2048 four lanes ran both kernels' indexed forms (the
    grid solve's calls) faster than one; at tt_seq1024's K = 1024, one
    step of four lanes a thread, one lane was as fast or faster; a float64
    thread of four lanes spills."""
    return 4 if int(itemsize) == 4 and int(k) >= 2 * 4 * THREADS else 1


def launch_lanes(k: int, t: torch.Tensor, forced=None) -> int:
    """``grid_lanes`` for ``t``'s dtype, or the forced LPT (tests and timing
    only: the C entry checks it and refuses a value it does not take)."""
    return grid_lanes(k, t.element_size()) if forced is None else int(forced)


def pack_camera_params(rmats, tvecs, fx_fy, cx_cy_skew, inv_width, dist) -> torch.Tensor:
    """(C, 24) parameter rows of the JAX kernel's scalar table, whose
    columns the plain version reads; ``inv_width`` is a 0-d tensor (or a
    float), broadcast without a host sync."""
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


def cam_normal_idx_plain(
    rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, pt_idx, uv, mask, inv_width,
    loss: RobustLoss = RobustLoss.TRIVIAL,
):
    """Plain PyTorch version of ``cam_normal_idx``: the points gathered
    onto the grid, then ``cam_normal_fused_plain``."""
    x_w = points3d[pt_idx].permute(0, 2, 1).contiguous()
    return cam_normal_fused_plain(
        rmats, tvecs, fx_fy, cx_cy_skew, dist, x_w, uv, mask, inv_width, loss
    )


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(name, cams, inv_width, uv, mask, loss, lanes, x_w=None, points3d=None,
            pt_idx=None):
    """One launch of B9: on the x_w planes, or (``pt_idx`` given) indexed."""
    rmats, tvecs, fx_fy, cx_cy_skew, dist = cams
    c, k = mask.shape
    dtype, dev = mask.dtype, mask.device
    dist = dist.to(dtype)  # the only cast pack_camera_params makes besides inv_width
    inv_w = torch.as_tensor(inv_width, dtype=dtype, device=dev)
    check_inputs(name, dev, dtype, rmats=rmats, tvecs=tvecs, fx_fy=fx_fy,
                 cx_cy_skew=cx_cy_skew, dist=dist, inv_width=inv_w, uv=uv, mask=mask)
    for key, t, shape in (("rmats", rmats, (c, 3, 3)), ("tvecs", tvecs, (c, 3)),
                          ("fx_fy", fx_fy, (c, 2)), ("cx_cy_skew", cx_cy_skew, (c, 3)),
                          ("dist", dist, (c, 2)), ("inv_width", inv_w, ()),
                          ("uv", uv, (c, 2, k))):
        check_shape(name, key, t, shape)
    indexed = pt_idx is not None
    if indexed:
        check_inputs(name, dev, dtype, points3d=points3d)
        check_inputs(name, dev, torch.int32, pt_idx=pt_idx)
        check_shape(name, "points3d", points3d, (points3d.shape[0], 3))
        check_shape(name, "pt_idx", pt_idx, (c, k))
    else:
        check_inputs(name, dev, dtype, x_w=x_w)
        check_shape(name, "x_w", x_w, (c, 3, k))
    r = torch.empty((c, 2, k), dtype=dtype, device=dev)
    jp = torch.empty((c, 6, k), dtype=dtype, device=dev)
    jc = torch.empty((c, 16, k), dtype=dtype, device=dev)
    u = torch.empty((c, 8, 8), dtype=dtype, device=dev)
    g = torch.empty((c, 8), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.grid_cam_normal(
        _build.dtype_code(dtype), int(indexed), rmats.data_ptr(), tvecs.data_ptr(),
        fx_fy.data_ptr(), cx_cy_skew.data_ptr(), dist.data_ptr(), inv_w.data_ptr(),
        _ptr(x_w), _ptr(points3d), _ptr(pt_idx), uv.data_ptr(), mask.data_ptr(),
        r.data_ptr(), jp.data_ptr(), jc.data_ptr(), u.data_ptr(), g.data_ptr(), c, k,
        points3d.shape[0] if indexed else 0, LOSS_CODES[loss], launch_lanes(k, mask, lanes),
        _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    return r, jp, jc, u, g


def cam_normal_fused(
    rmats, tvecs, fx_fy, cx_cy_skew, dist, x_w, uv, mask, inv_width,
    loss: RobustLoss = RobustLoss.TRIVIAL, _lanes=None,
):
    """(r (C,2,K), jp (C,6,K), jc (C,16,K), U (C,8,8), g (C,8)).

    ``rmats`` (C,3,3), ``tvecs`` (C,3), ``fx_fy`` (C,2), ``cx_cy_skew``
    (C,3), ``dist`` (C,2) radial (k1, k2); ``x_w`` (C,3,K) grid-gathered
    world points, ``uv`` (C,2,K) observations, ``mask`` (C,K); ``inv_width``
    a 0-d tensor.  CPU tensors run the plain version, CUDA tensors the
    kernel.  ``_lanes`` forces LPT (tests and timing only)."""
    if not is_cuda_call(x_w):
        return cam_normal_fused_plain(
            rmats, tvecs, fx_fy, cx_cy_skew, dist, x_w, uv, mask, inv_width, loss
        )
    return _launch("cam_normal_fused", (rmats, tvecs, fx_fy, cx_cy_skew, dist), inv_width,
                   uv, mask, loss, _lanes, x_w=x_w)


def cam_normal_idx(
    rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, pt_idx, uv, mask, inv_width,
    loss: RobustLoss = RobustLoss.TRIVIAL, _lanes=None,
):
    """``cam_normal_fused`` with lane (c, k)'s world point read as
    ``points3d[pt_idx[c, k]]``: ``points3d`` (P, 3), ``pt_idx`` (C, K)
    int32 in [0, P) (the grid problem's; the kernel traps on another
    index, the plain version's gather raises on one past P).  The outputs
    equal ``cam_normal_fused`` on the gathered planes bit for bit.  CPU
    tensors run the plain version (the gather, then
    ``cam_normal_fused_plain``), CUDA tensors the kernel."""
    if not is_cuda_call(points3d):
        return cam_normal_idx_plain(
            rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, pt_idx, uv, mask, inv_width,
            loss,
        )
    return _launch("cam_normal_idx", (rmats, tvecs, fx_fy, cx_cy_skew, dist), inv_width,
                   uv, mask, loss, _lanes, points3d=points3d, pt_idx=pt_idx)
