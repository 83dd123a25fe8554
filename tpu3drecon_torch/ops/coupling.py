"""Kernel B11: the fused Schur-Jacobi coupling blocks of the grid engine.

Replaces ``tpu3drecon/ops/pallas/coupling.py:coupling_fused`` (body
``_coupling_kernel``).  Per camera row it forms the point-elimination
fill of the exact-S-diagonal preconditioner,

    coupling_c = sum_k W_ck Vinv_p(c,k) W_ck^T,     W_ck = jc_ck^T jp_ck,

from the whitened planes jc (C, 16, K) and jp (C, 6, K), returning
(C, 8, 8).  ``coupling_fused`` keeps JAX's signature, the six unique
V^-1 entries gathered onto the grid as (C, 6, K) planes; ``coupling_idx``,
what the grid solve calls, reads them from V^-1 (P, 3, 3) through the
grid's ``pt_idx`` itself.  The TPU kernel left that gather to XLA because
a TPU pays per gathered row; here it would write a (C, 6, K) plane set and
read it back.

CUDA kernel (``csrc/grid_kernels.cu:grid_coupling_kernel``): B9's launch,
one block per camera row, ``grid_lanes``' LPT lanes per thread per step;
W (8x3) and T = W V^-1 (8x3) stay in registers and the 36 upper-triangle
sums are register partials reduced per block (no atomics: two calls are
bit-equal).  On the H100 it is bound by the bytes of its 28 input planes.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import check_inputs, check_shape, is_cuda_call
from tpu3drecon_torch.ops.cam_normal import _ptr, launch_lanes

COUNTS = _build.LaunchCounter()

_SYM = ((0, 1, 2), (1, 3, 4), (2, 4, 5))  # vinv6 plane of entry (j, l)


def coupling_fused_plain(jc, jp, vinv6):
    """Plain PyTorch version of ``coupling_fused``: W, T = W V^-1 and the
    (i <= m) sums of T W^T in the JAX kernel's order, mirrored below the
    diagonal."""
    COUNTS.plain += 1
    jc0, jc1 = jc[:, :8], jc[:, 8:]  # (C, 8, K)
    w = [jc0 * jp[:, j : j + 1] + jc1 * jp[:, 3 + j : 4 + j] for j in range(3)]
    v = [[vinv6[:, _SYM[j][l] : _SYM[j][l] + 1] for l in range(3)] for j in range(3)]
    t = [w[0] * v[0][l] + w[1] * v[1][l] + w[2] * v[2][l] for l in range(3)]
    full = torch.sum(
        t[0][:, :, None] * w[0][:, None]
        + t[1][:, :, None] * w[1][:, None]
        + t[2][:, :, None] * w[2][:, None],
        dim=-1,
    )  # (C, 8, 8): full[c, i, m] = sum_k T_i . W_m
    upper = torch.ones(8, 8, dtype=torch.bool, device=jc.device).triu()
    return torch.where(upper, full, full.transpose(1, 2))


def vinv6_planes(v_inv, pt_idx):
    """(C, 6, K) planes of the unique V^-1 entries (00 01 02 11 12 22) of
    each lane's point, ``v_inv`` (P, 3, 3) gathered through ``pt_idx``."""
    rows = torch.stack([v_inv[:, 0, 0], v_inv[:, 0, 1], v_inv[:, 0, 2],
                        v_inv[:, 1, 1], v_inv[:, 1, 2], v_inv[:, 2, 2]], dim=1)
    return rows[pt_idx].permute(0, 2, 1).contiguous()


def coupling_idx_plain(jc, jp, v_inv, pt_idx):
    """Plain PyTorch version of ``coupling_idx``: the V^-1 entries gathered
    onto the grid, then ``coupling_fused_plain``."""
    return coupling_fused_plain(jc, jp, vinv6_planes(v_inv, pt_idx))


def _launch(name, jc, jp, lanes, vinv6=None, v_inv=None, pt_idx=None):
    """One launch of B11: on the vinv6 planes, or (``pt_idx`` given)
    indexed."""
    c, _, k = jc.shape
    dtype, dev = jc.dtype, jc.device
    check_inputs(name, dev, dtype, jc=jc, jp=jp)
    check_shape(name, "jc", jc, (c, 16, k))
    check_shape(name, "jp", jp, (c, 6, k))
    indexed = pt_idx is not None
    if indexed:
        check_inputs(name, dev, dtype, v_inv=v_inv)
        check_inputs(name, dev, torch.int32, pt_idx=pt_idx)
        check_shape(name, "v_inv", v_inv, (v_inv.shape[0], 3, 3))
        check_shape(name, "pt_idx", pt_idx, (c, k))
    else:
        check_inputs(name, dev, dtype, vinv6=vinv6)
        check_shape(name, "vinv6", vinv6, (c, 6, k))
    out = torch.empty((c, 8, 8), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.grid_coupling(
        _build.dtype_code(dtype), int(indexed), jc.data_ptr(), jp.data_ptr(), _ptr(vinv6),
        _ptr(v_inv), _ptr(pt_idx), out.data_ptr(), c, k, v_inv.shape[0] if indexed else 0,
        launch_lanes(k, jc, lanes), _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    return out


def coupling_fused(jc, jp, vinv6, _lanes=None):
    """(C, 8, 8) coupling blocks sum_k W V^-1 W^T.

    ``jc`` (C, 16, K), ``jp`` (C, 6, K), ``vinv6`` (C, 6, K) gathered
    V^-1 entries (00 01 02 11 12 22).  CPU tensors run the plain version,
    CUDA tensors the kernel.  ``_lanes`` forces LPT (tests and timing
    only)."""
    if not is_cuda_call(jc):
        return coupling_fused_plain(jc, jp, vinv6)
    return _launch("coupling_fused", jc, jp, _lanes, vinv6=vinv6)


def coupling_idx(jc, jp, v_inv, pt_idx, _lanes=None):
    """``coupling_fused`` with lane (c, k)'s V^-1 entries read from
    ``v_inv[pt_idx[c, k]]``: ``v_inv`` (P, 3, 3), ``pt_idx`` (C, K) int32 in
    [0, P) (the kernel traps on another index, the plain version's gather
    raises on one past P).  Equals ``coupling_fused`` on the gathered planes bit for bit.
    CPU tensors run the plain version (the gather, then
    ``coupling_fused_plain``), CUDA tensors the kernel."""
    if not is_cuda_call(jc):
        return coupling_idx_plain(jc, jp, v_inv, pt_idx)
    return _launch("coupling_idx", jc, jp, _lanes, v_inv=v_inv, pt_idx=pt_idx)
