"""Kernels B2 and B3: the wtt Schur coupling product and its W^T x half.

B2 replaces ``tpu3drecon/ops/pallas/wtt_matvec.py:wtt_coupling_rows_idx``
(body ``_matvec_kernel_idx``): the CG operator's rows (G, np, W) of
W V^-1 W^T x in one pass — W^T x accumulated over each point's track,
y = sym3(V^-1) W^T x, then z = jc (jp y) reduced into the window rows.
B3 replaces ``wtt_wt_planes_idx`` (body ``_wt_kernel_idx``): the
back-substitution's W^T x point planes (3, G, Pc).

CUDA kernels (``csrc/wtt_kernels.cu``): one thread per point column, the
group's x window staged in shared memory.  B2 keeps W^T x and y in
registers and reduces only z across threads (shared-memory atomics into an
(np, W) tile, one global atomic per nonzero entry); on the H100 it is
bound by those atomics and the jc/jp stream (2 np + 6 planes per slot).
B3 has no cross-thread reduction and is bound by the jc/jp bytes it reads.
B2's rows are atomic sums, so f32 rows vary in the last bits.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import (
    check_inputs,
    check_shape,
    is_cuda_call,
    reduce_rows,
    slot_index,
)
from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec

COUPLING_COUNTS = _build.LaunchCounter()
WT_COUNTS = _build.LaunchCounter()


def _wt_x(xw_t, wcam, jc, jp):
    """W^T x point planes [(G, Pc)] * 3: phase 1 of both kernels."""
    np_cam = jc.shape[0] // 2
    _, g, tb, pc = jp.shape
    window = xw_t.shape[2]
    xw_pad = torch.cat([xw_t, xw_t.new_zeros(g, np_cam, 1)], dim=2)
    idx = slot_index(wcam, window)
    xg = torch.gather(xw_pad, 2, idx[:, None, :].expand(g, np_cam, idx.shape[1]))
    xg = xg.permute(1, 0, 2).reshape(np_cam, g, tb, pc)
    s0 = torch.sum(jc[:np_cam] * xg, dim=0)
    s1 = torch.sum(jc[np_cam:] * xg, dim=0)
    return [torch.sum(jp[l] * s0 + jp[3 + l] * s1, dim=1) for l in range(3)]


def wtt_coupling_rows_idx_plain(xw_t, wcam, jc, jp, v_inv):
    """Plain PyTorch version of ``wtt_coupling_rows_idx``."""
    COUPLING_COUNTS.plain += 1
    np_cam = jc.shape[0] // 2
    window = xw_t.shape[2]
    y = [t[:, None, :] for t in _sym3_matvec(v_inv, _wt_x(xw_t, wcam, jc, jp))]
    s0p = jp[0] * y[0] + jp[1] * y[1] + jp[2] * y[2]
    s1p = jp[3] * y[0] + jp[4] * y[1] + jp[5] * y[2]
    z = jc[:np_cam] * s0p[None] + jc[np_cam:] * s1p[None]  # (np, G, Tb, Pc)
    return reduce_rows(z, wcam, window).transpose(1, 2)


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


def wtt_coupling_rows_idx(xw_t, wcam, jc, jp, v_inv):
    """Coupling rows (G, np, W) of W V^-1 W^T x for one bucket.

    ``xw_t`` (G, np, W) window rows of x (transposed), ``wcam``
    (G, Tb*Pc) int16, ``jc`` (2np, G, Tb, Pc), ``jp`` (6, G, Tb, Pc),
    ``v_inv`` (6, G, Pc).  CPU tensors run the plain version, CUDA tensors
    the kernel."""
    if not is_cuda_call(xw_t):
        return wtt_coupling_rows_idx_plain(xw_t, wcam, jc, jp, v_inv)
    name = "wtt_coupling_rows_idx"
    np_cam, g, tb, pc, window = _check(name, xw_t, wcam, jc, jp, v_inv)
    out = torch.zeros((g, np_cam, window), dtype=xw_t.dtype, device=xw_t.device)
    lib = _build.library()
    code = lib.wtt_coupling(
        _build.dtype_code(xw_t.dtype), np_cam, xw_t.data_ptr(), wcam.data_ptr(),
        jc.data_ptr(), jp.data_ptr(), v_inv.data_ptr(), out.data_ptr(),
        g, tb, pc, window, _build.stream_ptr(xw_t.device),
    )
    _build.check(lib, name, code)
    COUPLING_COUNTS.kernel += 1
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
    WT_COUNTS.kernel += 1
    return out
