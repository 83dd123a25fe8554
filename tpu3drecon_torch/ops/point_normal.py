"""Kernel B10: the point-side normal-equation reduction of the grid engine.

Replaces ``tpu3drecon/ops/pallas/point_normal.py:point_normal_fused``
(body ``_point_normal_kernel``).  From the residual and point-Jacobian rows
gathered through a track bucket it forms, per point,

  - V_p     = sum_t Jp_t^T Jp_t        (3x3)
  - damp_p  = lam * max(diag V_p, diag_floor)
  - v_inv_p = (V_p + diag damp_p)^-1   closed-form adjugate
  - g_p     = sum_t Jp_t^T r_t

CUDA kernel (``csrc/grid_kernels.cu:point_normal_rows_kernel``): one launch
over all the track buckets of a linearization (``point_normal_buckets``;
up to 8 buckets per launch, their pointers and sizes passed by value).  A
block owns a run of consecutive points of one bucket (``point_geometry``),
stages their contiguous jp_g/r_g spans into shared memory with 16-byte
copies, gives each track row a lane (two rows per lane) for its 9
products, and lets one lane
per point add them from zero in row order (this module's plain order, so
the sums are bit-equal) and form the damping and inverse; the block's
outputs leave as three contiguous spans of 16-byte stores.  On the H100
it is bound by the bytes of jp_g/r_g (16 B per row in f32) and the 60 B
per point it writes.  ``point_normal_fused`` keeps JAX's per-bucket
signature: the same kernel on a group of one.  The TPU kernel's split of
jp_g into three column planes only avoided Mosaic's lane padding and is
not kept.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import check_inputs, check_shape, is_cuda_call

COUNTS = _build.LaunchCounter()

THREADS = 256  # lanes per block (csrc kPnThreads)
CHUNK = 2 * THREADS  # track rows per chunk, two per lane (kPnChunk)
MAX_POINTS = 128  # points per block at most (kPnMaxPoints)
MAX_BUCKETS = 8  # buckets per launch (kPnBuckets)


class PointGeometry(NamedTuple):
    """Launch geometry of B10 on one bucket."""

    points: int  # points per block
    blocks: int  # ceil(P / points)
    smem: int  # shared bytes per block


def _vec_up(n: int, ve: int) -> int:
    return -(-n // ve) * ve


def point_smem(points: int, t2: int, itemsize: int) -> int:
    """Shared bytes of a block of ``points`` points of ``t2`` rows: a
    chunk's staged jp/r spans (later the 15 staged outputs per point), then
    the 9 products of each row at an odd per-point stride (t2 | 1), or of
    each chunk row where one point's rows come in chunks of ``CHUNK``.
    The C entry's count (``csrc/grid_kernels.cu pn_smem``)."""
    ve = 16 // itemsize
    rs = CHUNK if points * t2 > CHUNK else points * (t2 | 1)
    io = max(4 * CHUNK + 2 * ve,
             _vec_up(9 * points, ve) + 2 * _vec_up(3 * points, ve) + 3 * ve)
    return (io + 9 * rs) * itemsize


@functools.lru_cache(maxsize=256)
def point_geometry(p: int, t2: int, itemsize: int, sms: int) -> PointGeometry:
    """Points per block on a bucket of ``p`` points of ``t2`` rows, on a
    card of ``sms`` multiprocessors: as many as fill one chunk of ``CHUNK``
    rows (at most ``MAX_POINTS``), fewer where the bucket would otherwise
    run on under ``sms`` blocks (its long tracks, few points); a point of
    more than ``CHUNK`` rows is a block of its own.  The shared bytes stay
    under ``SMEM_PER_BLOCK`` (at most 62.5 KB, in f64)."""
    per = max(1, min(MAX_POINTS, CHUNK // max(int(t2), 1)))
    points = max(1, min(per, -(-int(p) // int(sms))))
    return PointGeometry(points, -(-int(p) // points), point_smem(points, int(t2), itemsize))


@functools.lru_cache(maxsize=None)
def card_sms(device: torch.device) -> int:
    """The multiprocessors of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of 3x3 SPD matrices (adjugate form,
    the JAX kernel's cofactor layout; a |det| below 1e-32 counts as 1)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + g * co_c
    det_safe = torch.where(torch.abs(det) < 1e-32, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    adj = torch.stack(
        [
            torch.stack([co_a, co_b, co_c], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


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
    v_d = torch.stack([
        torch.stack([v00 + d0, v01, v02], dim=-1),
        torch.stack([v01, v11 + d1, v12], dim=-1),
        torch.stack([v02, v12, v22 + d2], dim=-1),
    ], dim=-2)
    return (
        inv3x3(v_d),
        torch.stack([g0, g1, g2], dim=-1),
        torch.stack([d0, d1, d2], dim=-1),
    )


def point_normal_buckets_plain(jp_gs, r_gs, lam, diag_floor: float = 1e-8):
    """Plain PyTorch version of ``point_normal_buckets``: each bucket's
    ``point_normal_fused_plain``, concatenated."""
    parts = [point_normal_fused_plain(jp_g, r_g, lam, diag_floor)
             for jp_g, r_g in zip(jp_gs, r_gs)]
    return tuple(torch.cat(out) for out in zip(*parts))


def point_normal_buckets(jp_gs, r_gs, lam, diag_floor: float = 1e-8):
    """(v_inv (sum P, 3, 3), g_pt (sum P, 3), damp_pt (sum P, 3)) of a list
    of track buckets, the buckets' points in order.

    ``jp_gs[b]`` (P_b, T2_b, 3) track-gathered whitened point Jacobians,
    ``r_gs[b]`` (P_b, T2_b) residuals, ``lam`` a 0-d tensor.  CPU tensors
    run the plain version, CUDA tensors one kernel launch per
    ``MAX_BUCKETS`` buckets."""
    if len(jp_gs) != len(r_gs) or not jp_gs:
        raise ValueError("point_normal_buckets: one r_g per jp_g, at least one bucket")
    if not is_cuda_call(jp_gs[0]):
        return point_normal_buckets_plain(jp_gs, r_gs, lam, diag_floor)
    name = "point_normal_buckets"
    dtype, dev = jp_gs[0].dtype, jp_gs[0].device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    check_inputs(name, dev, dtype, lam=lam)
    check_shape(name, "lam", lam, ())
    n = len(jp_gs)
    sms = card_sms(dev)
    sizes, geoms = [], []
    for jp_g, r_g in zip(jp_gs, r_gs):
        check_inputs(name, dev, dtype, jp_g=jp_g, r_g=r_g)
        if jp_g.dim() != 3:
            raise ValueError(f"{name}: jp_g has shape {tuple(jp_g.shape)}, expected (P, T2, 3)")
        p, t2, _ = jp_g.shape
        check_shape(name, "jp_g", jp_g, (p, t2, 3))
        check_shape(name, "r_g", r_g, (p, t2))
        sizes.append((p, t2))
        geoms.append(point_geometry(p, t2, jp_g.element_size(), sms))
    total = sum(p for p, _ in sizes)
    v_inv = torch.empty((total, 3, 3), dtype=dtype, device=dev)
    g = torch.empty((total, 3), dtype=dtype, device=dev)
    damp = torch.empty((total, 3), dtype=dtype, device=dev)
    jp_ptrs = (ctypes.c_uint64 * n)(*(t.data_ptr() for t in jp_gs))
    r_ptrs = (ctypes.c_uint64 * n)(*(t.data_ptr() for t in r_gs))
    ps = (ctypes.c_int * n)(*(p for p, _ in sizes))
    t2s = (ctypes.c_int * n)(*(t2 for _, t2 in sizes))
    ppbs = (ctypes.c_int * n)(*(geo.points for geo in geoms))
    lib = _build.library()
    code = lib.grid_point_normal(
        _build.dtype_code(dtype), n, ctypes.addressof(jp_ptrs), ctypes.addressof(r_ptrs),
        ctypes.addressof(ps), ctypes.addressof(t2s), ctypes.addressof(ppbs), lam.data_ptr(),
        v_inv.data_ptr(), g.data_ptr(), damp.data_ptr(), float(diag_floor),
        _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    for first in range(0, n, MAX_BUCKETS):  # the C entry skips a launch of no blocks
        if any(geo.blocks for geo in geoms[first:first + MAX_BUCKETS]):
            COUNTS.kernel += 1
    return v_inv, g, damp


def point_normal_fused(jp_g, r_g, lam, diag_floor: float = 1e-8):
    """(v_inv (P,3,3), g_pt (P,3), damp_pt (P,3)).

    ``jp_g`` (P, T2, 3) track-gathered whitened point Jacobians, ``r_g``
    (P, T2) residuals, ``lam`` a 0-d tensor.  CPU tensors run the plain
    version, CUDA tensors the kernel of ``point_normal_buckets`` on this
    one bucket."""
    if not is_cuda_call(jp_g):
        return point_normal_fused_plain(jp_g, r_g, lam, diag_floor)
    return point_normal_buckets([jp_g], [r_g], lam, diag_floor)
