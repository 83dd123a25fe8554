"""Shared plumbing of the kernel wrappers: input checks and the device
dispatch rule (all wrappers), the window-row gather and scatter of the
wtt plain versions, the bfloat16 split rounding of their
reduced-fidelity modes, the launch geometry of the slot-major kernels
(B1, B2, B6, B8 and B12-B15) and B6's one-hot vector width.

Dispatch rule of every public kernel function: a CPU tensor goes to the
plain PyTorch version; a CUDA tensor launches the CUDA kernel or raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

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


# ------------------------------------------------- slot-major geometry ---
# The slot-major kernels run one lane per track slot: a warp holds slot t of
# 32 consecutive point columns, a block holds `groups` such 32-point groups
# as `warps` warps each, and a track longer than `warps` slots is walked in
# `chunks` chunks.  B1 ("lin") and B2 ("coupling") are csrc/wtt_kernels.cuh's
# templates; B6 ("onehot") is B2's kernel with each slot's row decoded from
# the one-hot; B8 ("contrib") is B1's pass 2 alone (csrc/wtt_route_kernels.cu);
# B12 ("tt_lin"), B13 ("tt_coupling"), B14 ("tt_wt") and B15 ("tt_w") are
# csrc/tt_kernels.cu's.  The C entries check the shared bytes against their
# own count (lin_smem, coupling_smem, contrib_smem, tt_lin_smem,
# tt_coupling_smem, tt_wt_smem, tt_w_smem), so these formulas are the
# kernels' layout.
SMEM_PER_BLOCK = 232_448  # the H100's opt-in shared memory per block
TILE_COLS = 32  # B1's, B8's, B12's and B13's row-tile columns (csrc/slot.cuh kTile)
TARGET_WARPS = 8  # warps per block the geometry aims at (256 threads)
INT_BYTES = 4
KERNELS = ("lin", "coupling", "onehot", "contrib", "tt_lin", "tt_coupling", "tt_wt", "tt_w")


def max_threads(kernel: str, itemsize: int) -> int:
    """Threads per block at most of a slot-major kernel: its
    ``__launch_bounds__``, which bound the registers per thread."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, not {kernel!r}")
    if kernel in ("lin", "contrib", "tt_lin", "tt_coupling"):
        return 512 if itemsize == 4 else 256
    return 512


def slot_smem(kernel: str, warps: int, groups: int, np_cam: int, itemsize: int,
              want_od: bool = False) -> int:
    """Shared bytes of one block: the per-slot parts of the per-point sums
    (9 values for B1 and B12, 3 for B2, B6 and B14) aliased by the warps'
    (32, cols + 1) row tiles, the per-point values shared back (9, 3), B1's
    and B8's od factors and rows of the chunk's slots and the one before it,
    each warp's (3, 32) int tile meta, and B6's (32,) int row table per warp.
    B12 shares nothing back; B14 has no row tile; B8, B13 and B15 have no
    per-point sum: their warps' (32, cols + 1) row tiles and their meta (and
    B8's od values)."""
    max_threads(kernel, itemsize)  # raises on an unknown kernel
    nw = warps * groups
    ints = nw * 96
    if kernel in ("lin", "contrib"):
        vals = nw * 32 * (TILE_COLS + 1)
        if kernel == "lin":
            vals = max(nw * 9 * 32, vals) + groups * 9 * 32
        if want_od:
            vals += groups * (warps + 1) * 3 * np_cam * 32
            ints += groups * (warps + 1) * 32
    elif kernel == "tt_coupling":
        vals = nw * 32 * (TILE_COLS + 1)
    elif kernel == "tt_lin":
        vals = max(nw * 9 * 32, nw * 32 * (TILE_COLS + 1))
    elif kernel == "tt_wt":
        vals, ints = nw * 3 * 32, 0
    elif kernel == "tt_w":
        vals = nw * 32 * (np_cam + 1)
    else:
        vals = max(nw * 3 * 32, nw * 32 * (np_cam + 1)) + groups * 3 * 32
        if kernel == "onehot":
            ints += nw * 32
    return vals * itemsize + ints * INT_BYTES


class SlotGeometry(NamedTuple):
    """Launch geometry of a slot-major kernel on one bucket."""

    warps: int  # warps (track slots) per 32-point group and chunk
    groups: int  # 32-point groups per block
    chunks: int  # chunks per track: ceil(Tb / warps)
    blocks: int  # blocks along the point axis: ceil(Pc / (32 * groups))
    smem: int  # shared bytes per block


def slot_geometry(kernel: str, tb: int, pc: int, np_cam: int, itemsize: int,
                  want_od: bool = False, limit: int = SMEM_PER_BLOCK,
                  tile: int = 0) -> SlotGeometry:
    """The geometry of B1 ("lin"), B2 ("coupling"), B6 ("onehot"), B8
    ("contrib"), B12 ("tt_lin"), B13 ("tt_coupling"), B14 ("tt_wt") or B15
    ("tt_w") on a bucket of ``tb`` slots
    per track and ``pc`` point columns: as many warps per group as the
    track has slots, up to the kernel's thread limit (a longer track is cut
    into balanced chunks);
    short tracks share a block, up to ``TARGET_WARPS`` warps; groups, then
    warps per group, shrink until the shared bytes (with ``tile`` bytes of
    a block-wide tile) fit ``limit``."""
    tb = max(int(tb), 1)
    max_warps = max_threads(kernel, itemsize) // 32
    warps = -(-tb // -(-tb // max_warps))
    groups = max(1, min(TARGET_WARPS // warps, -(-pc // 32)))

    def smem(w, gr):
        return slot_smem(kernel, w, gr, np_cam, itemsize, want_od) + tile

    while smem(warps, groups) > limit and groups > 1:
        groups -= 1
    while smem(warps, groups) > limit and warps > 1:
        warps = -(-tb // (-(-tb // warps) + 1))
    return SlotGeometry(warps, groups, -(-tb // warps), -(-pc // (32 * groups)),
                        smem(warps, groups))


def onehot_vector_bytes(address: int, pc: int, itemsize: int) -> int:
    """Bytes of B6's one-hot vector loads: the widest of 16, 8, 4 and 1
    that is no narrower than an entry of ``itemsize`` bytes and divides
    both the one-hot's ``address`` and the ``pc`` entries of a slot row, so
    that every warp's block of 32 columns (at t * Pc + a multiple of 32 in
    each of the W rows, N = Tb * Pc entries apart) starts aligned.  The C
    entry computes the same width (csrc/wtt_kernels.cuh onehot_vec) and
    refuses any other."""
    for vec in (16, 8, 4, 1):
        if vec >= itemsize and address % vec == 0 and pc * itemsize % vec == 0:
            return vec
    raise ValueError(f"a one-hot at {address:#x} with {itemsize}-byte entries is not aligned")
