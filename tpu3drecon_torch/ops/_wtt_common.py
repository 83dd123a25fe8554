"""Shared plumbing of the kernel wrappers: input checks and the device
dispatch rule (all wrappers), the window-row gather and scatter of the
wtt plain versions, and the bfloat16 split rounding of their
reduced-fidelity modes.

Dispatch rule of every public kernel function: a CPU tensor goes to the
plain PyTorch version; a CUDA tensor launches the CUDA kernel or raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch


def is_cuda_call(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_inputs(name: str, device, dtype, **tensors) -> None:
    """Raise unless every tensor lies on ``device``, is contiguous, and has
    ``dtype`` (``wcam`` must be int16, ``cam_ids`` int32)."""
    index_dtypes = {"wcam": torch.int16, "cam_ids": torch.int32}
    for key, t in tensors.items():
        want = index_dtypes.get(key, dtype)
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_shape(name: str, key: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def slot_index(wcam: torch.Tensor, window: int) -> torch.Tensor:
    """(G, N) int64 window row per slot, padding (-1) mapped to the extra
    all-zero row ``window``."""
    idx = wcam.long()
    return torch.where(idx < 0, torch.full_like(idx, window), idx)


def select_rows(tw: torch.Tensor, wcam: torch.Tensor, tb: int, pc: int) -> torch.Tensor:
    """(D, G, Tb, Pc) per-slot window rows of ``tw`` (G, W, D); padding
    slots get the all-zero row (what the TPU's empty one-hot column
    selects)."""
    g, w, d = tw.shape
    tw_pad = torch.cat([tw, tw.new_zeros(g, 1, d)], dim=1)
    idx = slot_index(wcam, w)
    sel = torch.gather(tw_pad, 1, idx[:, :, None].expand(g, idx.shape[1], d))
    return sel.permute(2, 0, 1).reshape(d, g, tb, pc)


def reduce_rows(planes: torch.Tensor, wcam: torch.Tensor, window: int) -> torch.Tensor:
    """Sum slot planes (K, G, Tb, Pc) into window rows (G, W, K); padding
    slots add nothing."""
    k, g = planes.shape[:2]
    n = planes[0, 0].numel()
    idx = slot_index(wcam, window)
    out = planes.new_zeros(g, window + 1, k)
    data = planes.reshape(k, g, n).permute(1, 2, 0)
    out.scatter_add_(1, idx[:, :, None].expand(g, n, k), data)
    return out[:, :window]



def split_round(x: torch.Tensor, terms: int) -> torch.Tensor:
    """``x`` as the TPU kernels' reduced-fidelity dots see it
    (``tpu3drecon/ops/pallas/splitdot.py``): split into ``terms`` bfloat16
    pieces h1 = bf16(x), h2 = bf16(x - h1), ... (round to nearest even) and
    folded back as (h1 + h2) + h3 in float32; the plain form of
    ``csrc/slot.cuh`` ``split_round``.  float32 at 3 terms or more is
    exact, and float64 is never split, so both come back unchanged."""
    if terms >= 3 or x.dtype != torch.float32:
        return x
    acc = x.to(torch.bfloat16).to(torch.float32)
    rem = x - acc
    for _ in range(terms - 1):
        h = rem.to(torch.bfloat16).to(torch.float32)
        rem = rem - h
        acc = acc + h
    return acc
