"""Least device time of the wtt kernels B1-B4, from the problem's shapes.

Frozen from ``chip_smoke.py``'s "Bound" column (commit
a2ddbf06de4361660b45a75548f7333c894b1583: ``account``,
``live_slot_work``, ``FLOPS``, ``F32_FLOPS_PER_S`` and
``benchmark/timing.py``'s ``HBM_BYTES_PER_S``): each input read once and
each output written once at 3.35 TB/s, or the float operations per slot at
67 TFLOP/s, whichever is longer (every one of these kernels is bound by
its bytes).  B3 reads the Jacobian planes of the slots with a window row
only.  The counts use the shapes of one bucket, so a later change to the
kernels cannot move them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12
CAM_TABLE_DIM = 19  # R (9) | t (3) | fx fy | cx cy skew | k1 k2

# Float operations per slot (chip_smoke.py FLOPS) by the kernel's name in a
# device trace.
FLOPS_PER_SLOT = {"lin_kernel": 1000, "coupling_kernel": 80, "wt_planes_kernel": 44,
                  "cost_kernel": 45}


def _n_triu(np_cam: int) -> int:
    return np_cam * (np_cam + 1) // 2


def bucket_bytes(kernel: str, g: int, tb: int, pc: int, window: int, live: int,
                 np_cam: int = 8, itemsize: int = 4, use_sj: bool = True) -> int:
    """Bytes one launch of ``kernel`` must move on a bucket of ``g`` groups
    of (``tb``, ``pc``) slots, ``window`` camera rows and ``live`` slots
    with a window row."""
    e = itemsize
    slots = g * tb * pc
    wcam = 2 * slots  # int16
    if kernel == "lin_kernel":
        cols = _n_triu(np_cam) * (2 if use_sj else 1) + 2 * np_cam  # u | g | coupling | rhs
        inputs = (wcam + g * window * CAM_TABLE_DIM * e + 3 * g * pc * e
                  + 3 * slots * e + 2 * e)  # wcam, tw, pts, uv, mask, lam, inv_w
        outputs = (g * window * cols * e + (2 * np_cam + 6) * slots * e
                   + 12 * g * pc * e)  # rows, jc, jp, v_inv, g_pt, damp_pt
        return inputs + outputs
    if kernel == "coupling_kernel":
        return (2 * g * np_cam * window * e + wcam + (2 * np_cam + 6) * slots * e
                + 6 * g * pc * e)  # x, out, wcam, jc, jp, v_inv
    if kernel == "wt_planes_kernel":
        return g * np_cam * window * e + wcam + 3 * g * pc * e + live * (2 * np_cam + 6) * e
    if kernel == "cost_kernel":
        return (wcam + g * window * CAM_TABLE_DIM * e + 3 * g * pc * e + 3 * slots * e
                + g * pc * e)  # wcam, tw, pts, uv, mask, out
    raise KeyError(kernel)


def bucket_least_s(kernel: str, g: int, tb: int, pc: int, window: int, live: int,
                   np_cam: int = 8, itemsize: int = 4) -> float:
    """The least time of one launch: bytes or operations, the longer."""
    slots = live if kernel == "wt_planes_kernel" else g * tb * pc
    return max(bucket_bytes(kernel, g, tb, pc, window, live, np_cam, itemsize)
               / HBM_BYTES_PER_S,
               FLOPS_PER_SLOT[kernel] * slots / F32_FLOPS_PER_S)


def pass_least_s(kernel: str, buckets) -> float:
    """The least time of one pass of ``kernel`` over every bucket;
    ``buckets`` holds (g, tb, pc, window, live) per bucket."""
    return sum(bucket_least_s(kernel, *b) for b in buckets)
