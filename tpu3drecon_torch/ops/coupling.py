"""Kernel B11: the fused Schur-Jacobi coupling blocks of the grid engine.

Replaces ``tpu3drecon/ops/pallas/coupling.py:coupling_fused`` (body
``_coupling_kernel``).  Per camera row it forms the point-elimination
fill of the exact-S-diagonal preconditioner,

    coupling_c = sum_k W_ck Vinv_p(c,k) W_ck^T,     W_ck = jc_ck^T jp_ck,

from the whitened planes jc (C, 16, K), jp (C, 6, K) and the six unique
V^-1 entries gathered onto the grid by ``pt_idx`` (C, 6, K), returning
(C, 8, 8).

CUDA kernel (``csrc/grid_kernels.cu:coupling_kernel``): one block per
camera row, threads striding over K; W (8x3) and T = W V^-1 (8x3) stay in
registers and the 36 upper-triangle sums are register partials reduced
once per block.  On the H100 it is bound by the bytes of its 28 input
planes.  The V^-1 gather stays on the torch side, as in the JAX engine.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import check_inputs, check_shape, is_cuda_call

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


def coupling_fused(jc, jp, vinv6):
    """(C, 8, 8) coupling blocks sum_k W V^-1 W^T.

    ``jc`` (C, 16, K), ``jp`` (C, 6, K), ``vinv6`` (C, 6, K) gathered
    V^-1 entries (00 01 02 11 12 22).  CPU tensors run the plain version,
    CUDA tensors the kernel."""
    if not is_cuda_call(jc):
        return coupling_fused_plain(jc, jp, vinv6)
    name = "coupling_fused"
    c, _, k = jc.shape
    dtype, dev = jc.dtype, jc.device
    check_inputs(name, dev, dtype, jc=jc, jp=jp, vinv6=vinv6)
    check_shape(name, "jc", jc, (c, 16, k))
    check_shape(name, "jp", jp, (c, 6, k))
    check_shape(name, "vinv6", vinv6, (c, 6, k))
    out = torch.empty((c, 8, 8), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.grid_coupling(
        _build.dtype_code(dtype), jc.data_ptr(), jp.data_ptr(), vinv6.data_ptr(),
        out.data_ptr(), c, k, _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    return out
