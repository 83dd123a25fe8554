"""Kernels B2, B3, B5 and B6: the wtt Schur coupling product and its halves.

B2 replaces ``tpu3drecon/ops/pallas/wtt_matvec.py:wtt_coupling_rows_idx``
(body ``_matvec_kernel_idx``): the CG operator's rows (G, np, W) of
W V^-1 W^T x in one pass — W^T x accumulated over each point's track,
y = sym3(V^-1) W^T x, then z = jc (jp y) reduced into the window rows.
B3 replaces ``wtt_wt_planes_idx`` (body ``_wt_kernel_idx``): the
back-substitution's W^T x point planes (3, G, Pc).  B5 replaces
``wtt_w_rows_idx`` (body ``_w_kernel_idx``): the W y rows (G, np, W), B2's
second half, the Schur rhs when the linearization is unfused.  B6 replaces
``wtt_coupling_rows_fused`` (body ``_matvec_kernel``): B2's rows with the
slot's window row read from the dense one-hot (G, W, Tb*Pc) instead of
``wcam`` (``matvec_kernel=True``/``"fused"``); its plain version is the
literal one-hot product.

CUDA kernels (``csrc/wtt_kernels.cu``), x read from the group's window
rows in device memory.  B2 is slot-major (``csrc/wtt_kernels.cuh``): one
lane per track slot, its jc/jp read once into registers; the W^T x parts
of a point's slots meet in shared memory, where one lane adds them in
slot order and shares y back, and z goes into the zeroed (np, W) rows
through each warp's row tile, one atomic per (row, column) from every lane
at once.  ``_wtt_common.slot_geometry`` gives its launch geometry.  On the
H100 it is bound by those atomics on the medium buckets and by the jc/jp
stream (2 np + 6 planes per slot) on the BAL ones.  B3 takes one thread
per point column, has no cross-thread reduction and is bound by the jc/jp
bytes it reads.  B5 (``csrc/wtt_route_kernels.cu``) reuses B2's
phase 2 per point column.  B6 is B2's slot-major kernel itself, with each
slot's window row decoded from the one-hot: a warp reads the one-hot
entries of its 32 point columns, contiguous in each window row, with
vector loads of ``_wtt_common.onehot_vector_bytes`` (16 bytes where the
one-hot's address and Pc allow it) and keeps each column's first nonzero
row, so it agrees with the literal product on a one-hot with at most one 1
per column and reads the first 1 of a malformed column.  B2, B5 and B6
rows are atomic sums, so f32 rows vary in the last bits.  Any window width
runs, in one memory mode.

B2 also takes the TPU kernel's ``terms`` (``matvec_kernel`` "index1" /
"index2", ``csrc/wtt_terms_kernels.cu``): at 1 or 2 each window-row value
of x that a slot reads and each z value it reduces is rounded through that
many bfloat16 split pieces (``_wtt_common.split_round``); float64 and
``terms=3`` are exact.  The JAX kernel sums each split piece over the
slots before it folds them, this one folds per slot, so the two differ by
f32 re-association.  B3 and B5 stay exact in every mode.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import (
    check_inputs,
    check_shape,
    is_cuda_call,
    onehot_vector_bytes,
    reduce_rows,
    slot_geometry,
    slot_index,
    split_round,
)
from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec

COUPLING_COUNTS = _build.LaunchCounter()  # B2
COUPLING1_COUNTS = _build.LaunchCounter()  # B2 at terms 1
COUPLING2_COUNTS = _build.LaunchCounter()  # B2 at terms 2
WT_COUNTS = _build.LaunchCounter()  # B3
W_ROWS_COUNTS = _build.LaunchCounter()  # B5
FUSED_COUNTS = _build.LaunchCounter()  # B6

def _wt_x(xw_t, wcam, jc, jp, ordered: bool = False):
    """W^T x point planes [(G, Pc)] * 3: phase 1 of both kernels.  With
    ``ordered`` the sums over the camera block and the track run one term
    at a time in the kernels' order, so a float32 result is bit-equal to
    the kernels' before any split rounding of B2's reduced modes."""
    np_cam = jc.shape[0] // 2
    _, g, tb, pc = jp.shape
    window = xw_t.shape[2]
    xw_pad = torch.cat([xw_t, xw_t.new_zeros(g, np_cam, 1)], dim=2)
    idx = slot_index(wcam, window)
    xg = torch.gather(xw_pad, 2, idx[:, None, :].expand(g, np_cam, idx.shape[1]))
    xg = xg.permute(1, 0, 2).reshape(np_cam, g, tb, pc)
    if not ordered:
        s0 = torch.sum(jc[:np_cam] * xg, dim=0)
        s1 = torch.sum(jc[np_cam:] * xg, dim=0)
        return [torch.sum(jp[l] * s0 + jp[3 + l] * s1, dim=1) for l in range(3)]
    s0, s1 = jc[0] * xg[0], jc[np_cam] * xg[0]
    for i in range(1, np_cam):
        s0 = s0 + jc[i] * xg[i]
        s1 = s1 + jc[np_cam + i] * xg[i]
    out = []
    for l in range(3):
        part = jp[l] * s0 + jp[3 + l] * s1  # (G, Tb, Pc)
        acc = part[:, 0]
        for t in range(1, tb):
            acc = acc + part[:, t]
        out.append(acc)
    return out


def _w_z(y, jc, jp):
    """z = jc (jp y) slot planes (np, G, Tb, Pc) of point planes y
    [(G, Pc)] * 3: phase 2 of B2, B5 and B6 before the reduction."""
    np_cam = jc.shape[0] // 2
    yb = [t[:, None, :] for t in y]
    s0p = jp[0] * yb[0] + jp[1] * yb[1] + jp[2] * yb[2]
    s1p = jp[3] * yb[0] + jp[4] * yb[1] + jp[5] * yb[2]
    return jc[:np_cam] * s0p[None] + jc[np_cam:] * s1p[None]


def _coupling_counter(terms: int) -> _build.LaunchCounter:
    if terms not in (1, 2, 3):
        raise ValueError(f"wtt_coupling_rows_idx: terms must be 1, 2 or 3, not {terms!r}")
    return {1: COUPLING1_COUNTS, 2: COUPLING2_COUNTS, 3: COUPLING_COUNTS}[terms]


def wtt_coupling_rows_idx_plain(xw_t, wcam, jc, jp, v_inv, terms: int = 3):
    """Plain PyTorch version of ``wtt_coupling_rows_idx``."""
    _coupling_counter(terms).plain += 1
    wtx = _wt_x(split_round(xw_t, terms), wcam, jc, jp, ordered=True)
    z = split_round(_w_z(_sym3_matvec(v_inv, wtx), jc, jp), terms)
    return reduce_rows(z, wcam, xw_t.shape[2]).transpose(1, 2)


def wtt_wt_planes_idx_plain(xw_t, wcam, jc, jp):
    """Plain PyTorch version of ``wtt_wt_planes_idx``."""
    WT_COUNTS.plain += 1
    return torch.stack(_wt_x(xw_t, wcam, jc, jp))


def _check(name, xw_t, wcam, jc, jp, v_inv=None):
    np_cam = jc.shape[0] // 2
    _, g, tb, pc = jp.shape
    window = xw_t.shape[2]
    extra = {} if v_inv is None else {"v_inv": v_inv}
    check_inputs(name, xw_t.device, xw_t.dtype, xw_t=xw_t, wcam=wcam, jc=jc,
                 jp=jp, **extra)
    check_shape(name, "xw_t", xw_t, (g, np_cam, window))
    check_shape(name, "wcam", wcam, (g, tb * pc))
    check_shape(name, "jc", jc, (2 * np_cam, g, tb, pc))
    if v_inv is not None:
        check_shape(name, "v_inv", v_inv, (6, g, pc))
    return np_cam, g, tb, pc, window


def wtt_coupling_rows_idx(xw_t, wcam, jc, jp, v_inv, terms: int = 3):
    """Coupling rows (G, np, W) of W V^-1 W^T x for one bucket.

    ``xw_t`` (G, np, W) window rows of x (transposed), ``wcam``
    (G, Tb*Pc) int16, ``jc`` (2np, G, Tb, Pc), ``jp`` (6, G, Tb, Pc),
    ``v_inv`` (6, G, Pc).  ``terms`` (1, 2 or 3) is the number of bfloat16
    split pieces that x and z are rounded through in float32 (3: exact).
    CPU tensors run the plain version, CUDA tensors the kernel."""
    counter = _coupling_counter(terms)
    if not is_cuda_call(xw_t):
        return wtt_coupling_rows_idx_plain(xw_t, wcam, jc, jp, v_inv, terms)
    name = "wtt_coupling_rows_idx"
    np_cam, g, tb, pc, window = _check(name, xw_t, wcam, jc, jp, v_inv)
    geo = slot_geometry("coupling", tb, pc, np_cam, xw_t.element_size())
    out = torch.zeros((g, np_cam, window), dtype=xw_t.dtype, device=xw_t.device)
    lib = _build.library()
    code = lib.wtt_coupling(
        _build.dtype_code(xw_t.dtype), np_cam, terms, xw_t.data_ptr(), wcam.data_ptr(),
        jc.data_ptr(), jp.data_ptr(), v_inv.data_ptr(), out.data_ptr(),
        g, tb, pc, window, geo.warps, geo.groups, geo.smem, _build.stream_ptr(xw_t.device),
    )
    _build.check(lib, name, code)
    counter.launched(_build.GLOBAL)
    return out


def wtt_wt_planes_idx(xw_t, wcam, jc, jp):
    """(W^T x) point planes (3, G, Pc) for one bucket (inputs as
    ``wtt_coupling_rows_idx``).  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if not is_cuda_call(xw_t):
        return wtt_wt_planes_idx_plain(xw_t, wcam, jc, jp)
    name = "wtt_wt_planes_idx"
    np_cam, g, tb, pc, window = _check(name, xw_t, wcam, jc, jp)
    out = torch.empty((3, g, pc), dtype=xw_t.dtype, device=xw_t.device)
    lib = _build.library()
    code = lib.wtt_wt_planes(
        _build.dtype_code(xw_t.dtype), np_cam, xw_t.data_ptr(), wcam.data_ptr(),
        jc.data_ptr(), jp.data_ptr(), out.data_ptr(), g, tb, pc, window,
        _build.stream_ptr(xw_t.device),
    )
    _build.check(lib, name, code)
    WT_COUNTS.launched(_build.GLOBAL)
    return out


# ------------------------------------------------------------------ B5 ---
def wtt_w_rows_idx_plain(y, wcam, jc, jp, window: int):
    """Plain PyTorch version of ``wtt_w_rows_idx``."""
    W_ROWS_COUNTS.plain += 1
    return reduce_rows(_w_z(y, jc, jp), wcam, window).transpose(1, 2)


def wtt_w_rows_idx(y, wcam, jc, jp, window: int):
    """(W y) camera rows (G, np, W) of the point planes ``y`` (3, G, Pc)
    for one bucket (``wcam``, ``jc``, ``jp`` as ``wtt_coupling_rows_idx``).
    CPU tensors run the plain version, CUDA tensors the kernel."""
    if not is_cuda_call(y):
        return wtt_w_rows_idx_plain(y, wcam, jc, jp, window)
    name = "wtt_w_rows_idx"
    np_cam = jc.shape[0] // 2
    _, g, tb, pc = jp.shape
    check_inputs(name, y.device, y.dtype, y=y, wcam=wcam, jc=jc, jp=jp)
    check_shape(name, "y", y, (3, g, pc))
    check_shape(name, "wcam", wcam, (g, tb * pc))
    check_shape(name, "jc", jc, (2 * np_cam, g, tb, pc))
    out = torch.zeros((g, np_cam, window), dtype=y.dtype, device=y.device)
    lib = _build.library()
    code = lib.wtt_w_rows(
        _build.dtype_code(y.dtype), np_cam, y.data_ptr(), wcam.data_ptr(),
        jc.data_ptr(), jp.data_ptr(), out.data_ptr(), g, tb, pc, window,
        _build.stream_ptr(y.device),
    )
    _build.check(lib, name, code)
    W_ROWS_COUNTS.launched(_build.GLOBAL)
    return out


# ------------------------------------------------------------------ B6 ---
def wtt_coupling_rows_fused_plain(xw_t, onehot, jc, jp, v_inv):
    """Plain PyTorch version of ``wtt_coupling_rows_fused``: the literal
    one-hot products (the one-hot cast to the data's dtype)."""
    FUSED_COUNTS.plain += 1
    np_cam = jc.shape[0] // 2
    _, g, tb, pc = jp.shape
    oh = onehot.to(xw_t.dtype)  # (G, W, Tb*Pc)
    xg = torch.einsum("giw,gwn->ign", xw_t, oh).reshape(np_cam, g, tb, pc)
    s0 = torch.sum(jc[:np_cam] * xg, dim=0)
    s1 = torch.sum(jc[np_cam:] * xg, dim=0)
    wtx = [torch.sum(jp[l] * s0 + jp[3 + l] * s1, dim=1) for l in range(3)]
    z = _w_z(_sym3_matvec(v_inv, wtx), jc, jp)
    return torch.einsum("kgn,gwn->gkw", z.reshape(np_cam, g, tb * pc), oh)


def wtt_coupling_rows_fused(xw_t, onehot, jc, jp, v_inv):
    """Coupling rows (G, np, W) of W V^-1 W^T x for one bucket, the slots'
    window rows read from ``onehot`` (G, W, Tb*Pc), int8 or the data's
    float dtype; other inputs as ``wtt_coupling_rows_idx``.  CPU tensors
    run the plain version, CUDA tensors the kernel."""
    if not is_cuda_call(xw_t):
        return wtt_coupling_rows_fused_plain(xw_t, onehot, jc, jp, v_inv)
    name = "wtt_coupling_rows_fused"
    np_cam = jc.shape[0] // 2
    _, g, tb, pc = jp.shape
    window = xw_t.shape[2]
    if onehot.dtype not in (torch.int8, xw_t.dtype):
        raise ValueError(
            f"{name}: onehot has dtype {onehot.dtype}, expected int8 or {xw_t.dtype}"
        )
    check_inputs(name, xw_t.device, xw_t.dtype, xw_t=xw_t, jc=jc, jp=jp, v_inv=v_inv)
    check_inputs(name, xw_t.device, onehot.dtype, onehot=onehot)
    check_shape(name, "xw_t", xw_t, (g, np_cam, window))
    check_shape(name, "onehot", onehot, (g, window, tb * pc))
    check_shape(name, "jc", jc, (2 * np_cam, g, tb, pc))
    check_shape(name, "v_inv", v_inv, (6, g, pc))
    geo = slot_geometry("onehot", tb, pc, np_cam, xw_t.element_size())
    vec = onehot_vector_bytes(onehot.data_ptr(), pc, onehot.element_size())
    out = torch.zeros((g, np_cam, window), dtype=xw_t.dtype, device=xw_t.device)
    lib = _build.library()
    code = lib.wtt_coupling_onehot(
        _build.dtype_code(xw_t.dtype), np_cam, int(onehot.dtype != torch.int8),
        xw_t.data_ptr(), onehot.data_ptr(), jc.data_ptr(), jp.data_ptr(),
        v_inv.data_ptr(), out.data_ptr(), g, tb, pc, window, geo.warps, geo.groups,
        geo.smem, vec, _build.stream_ptr(xw_t.device),
    )
    _build.check(lib, name, code)
    FUSED_COUNTS.launched(_build.GLOBAL)
    return out
