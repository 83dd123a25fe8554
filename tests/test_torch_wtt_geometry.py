"""Launch geometry of the slot-major kernels B1, B2, B6, B8 and B12-B15
(``tpu3drecon_torch.ops._wtt_common.slot_geometry``), on the CPU: for every
(dtype, np, od, terms) that the C entries ``wtt_linearize`` and
``wtt_coupling`` take, every (dtype, np, one-hot type) of
``wtt_coupling_onehot``, every (dtype, np, od) of ``wtt_contrib`` and every
(dtype, np) of ``tt_cam_normal``, ``tt_coupling``, ``tt_wt_times`` and
``tt_w_times``, and
tracks of 1 to 100 slots, the shared bytes fit the card's per-block limit,
the chunks cover each track once, the blocks cover every point column once
and no block exceeds the kernel's thread limit.  Also pins B1's row width K
and B6's one-hot vector width against hand-worked alignments."""

import pytest
import torch

from tpu3drecon_torch.ops._wtt_common import (
    SMEM_PER_BLOCK,
    max_threads,
    onehot_vector_bytes,
    slot_geometry,
    slot_smem,
)
from tpu3drecon_torch.ops.wtt_linearize import n_rows_cols

TBS = (1, 2, 3, 4, 8, 12, 33, 100)
PCS = (1, 31, 32, 33, 300, 512, 67584)
NPS = (8, 10, 12)
# (kernel, dtype, np, want_od, terms): B1 takes terms 2 (float32) and 3, B2
# terms 1 and 2 (float32) and 3; float64 is always exact.
ENTRIES = [
    ("lin", dtype, np_cam, od, terms)
    for dtype in (torch.float32, torch.float64)
    for np_cam in NPS
    for od in (False, True)
    for terms in ((2, 3) if dtype == torch.float32 else (3,))
] + [
    ("coupling", dtype, np_cam, False, terms)
    for dtype in (torch.float32, torch.float64)
    for np_cam in NPS
    for terms in ((1, 2, 3) if dtype == torch.float32 else (3,))
]
# B6 ("onehot", TERMS = 3) with an int8 or a float one-hot (the geometry is
# the same, the one-hot type picks the C instantiation); B15 ("tt_w").
ONEHOT_ENTRIES = [
    (dtype, np_cam, onehot)
    for dtype in (torch.float32, torch.float64)
    for np_cam in NPS
    for onehot in ("int8", "float")
]
TT_W_ENTRIES = [(dtype, np_cam) for dtype in (torch.float32, torch.float64) for np_cam in NPS]
# B8 ("contrib"): with and without od (use_sj changes the instantiation, not
# the layout).
CONTRIB_ENTRIES = [(dtype, np_cam, od) for dtype, np_cam in TT_W_ENTRIES for od in (False, True)]


def _fits_and_covers(kernel, dtype, np_cam, want_od, label):
    itemsize = torch.empty((), dtype=dtype).element_size()
    for tb in TBS:
        for pc in PCS:
            geo = slot_geometry(kernel, tb, pc, np_cam, itemsize, want_od)
            what = f"{kernel} {dtype} np={np_cam} od={want_od} {label} Tb={tb} Pc={pc}"
            assert geo.smem <= SMEM_PER_BLOCK, what
            assert geo.smem == slot_smem(kernel, geo.warps, geo.groups, np_cam, itemsize,
                                         want_od), what
            assert 32 <= 32 * geo.warps * geo.groups <= max_threads(kernel, itemsize), what
            # The chunks (warp ti of chunk c holds slot c * warps + ti) cover
            # slots 0 .. Tb - 1 once, in order, none empty.
            chunks = [range(c * geo.warps, min((c + 1) * geo.warps, tb))
                      for c in range(geo.chunks)]
            assert [t for chunk in chunks for t in chunk] == list(range(tb)), what
            assert all(len(chunk) > 0 for chunk in chunks), what
            # The blocks cover the point columns once: block b holds columns
            # [b * 32 * groups, (b + 1) * 32 * groups), the last one ragged.
            per_block = 32 * geo.groups
            assert geo.blocks * per_block >= pc > (geo.blocks - 1) * per_block, what


@pytest.mark.parametrize("kernel,dtype,np_cam,want_od,terms", ENTRIES)
def test_geometry_fits_and_covers(kernel, dtype, np_cam, want_od, terms):
    _fits_and_covers(kernel, dtype, np_cam, want_od, f"terms={terms}")


@pytest.mark.parametrize("dtype,np_cam,onehot", ONEHOT_ENTRIES)
def test_onehot_geometry_fits_and_covers(dtype, np_cam, onehot):
    """B6: B2's layout plus a (32,) int row table per warp."""
    _fits_and_covers("onehot", dtype, np_cam, False, f"onehot={onehot}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    for tb in TBS:
        geo = slot_geometry("onehot", tb, 512, np_cam, itemsize)
        assert geo.smem == slot_smem("coupling", geo.warps, geo.groups, np_cam,
                                     itemsize) + geo.warps * geo.groups * 32 * 4


@pytest.mark.parametrize("dtype,np_cam", TT_W_ENTRIES)
def test_tt_w_geometry_fits_and_covers(dtype, np_cam):
    """B15: the warps' (32, np + 1) row tiles and their meta, no per-point
    parts."""
    _fits_and_covers("tt_w", dtype, np_cam, False, "tt")
    itemsize = torch.empty((), dtype=dtype).element_size()
    geo = slot_geometry("tt_w", 2, 67584, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks) == (2, 4, 1)
    assert geo.smem == 8 * 32 * (np_cam + 1) * itemsize + 8 * 96 * 4


@pytest.mark.parametrize("dtype,np_cam", TT_W_ENTRIES)
def test_tt_lin_geometry_fits_and_covers(dtype, np_cam):
    """B12: the per-slot V | g_pt parts aliased by the warps' (32, kTile + 1)
    row tiles, and their meta; nothing shared back."""
    _fits_and_covers("tt_lin", dtype, np_cam, False, "tt")
    itemsize = torch.empty((), dtype=dtype).element_size()
    geo = slot_geometry("tt_lin", 2, 67584, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks) == (2, 4, 1)
    assert geo.smem == 8 * 32 * 33 * itemsize + 8 * 96 * 4
    # The medium problem's longest bucket: one chunk of 12 warps in float32,
    # two of 6 in float64 (256 threads at most).
    geo = slot_geometry("tt_lin", 12, 512, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks) == ((12, 1, 1) if itemsize == 4 else (6, 1, 2))


@pytest.mark.parametrize("dtype,np_cam,want_od", CONTRIB_ENTRIES)
def test_contrib_geometry_fits_and_covers(dtype, np_cam, want_od):
    """B8: the warps' (32, kTile + 1) row tiles and their meta, no per-point
    parts; with od B1's factors and rows of the chunk's slots and the one
    before it.  B1's thread limits (512 in float32, 256 in float64)."""
    _fits_and_covers("contrib", dtype, np_cam, want_od, "contrib")
    itemsize = torch.empty((), dtype=dtype).element_size()
    geo = slot_geometry("contrib", 2, 67584, np_cam, itemsize, want_od)
    assert (geo.warps, geo.groups, geo.chunks) == (2, 4, 1)
    od_vals = 4 * 3 * 3 * np_cam * 32 if want_od else 0
    od_ints = 4 * 3 * 32 if want_od else 0
    assert geo.smem == (8 * 32 * 33 + od_vals) * itemsize + (8 * 96 + od_ints) * 4
    # The BAL sequential problem's longest bucket and a track of three chunks.
    geo = slot_geometry("contrib", 4, 68096, np_cam, itemsize, want_od)
    assert (geo.warps, geo.chunks) == (4, 1)
    geo = slot_geometry("contrib", 40, 300, np_cam, itemsize, want_od)
    assert geo.chunks == (3 if itemsize == 4 else 5)


@pytest.mark.parametrize("dtype,np_cam", TT_W_ENTRIES)
def test_tt_coupling_geometry_fits_and_covers(dtype, np_cam):
    """B13: the warps' (32, kTile + 1) row tiles and their meta, nothing
    else: no per-point sum, nothing shared back."""
    _fits_and_covers("tt_coupling", dtype, np_cam, False, "tt")
    itemsize = torch.empty((), dtype=dtype).element_size()
    geo = slot_geometry("tt_coupling", 2, 67584, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks) == (2, 4, 1)
    assert geo.smem == 8 * 32 * 33 * itemsize + 8 * 96 * 4
    geo = slot_geometry("tt_coupling", 12, 512, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks) == ((12, 1, 1) if itemsize == 4 else (6, 1, 2))
    assert geo.smem == slot_smem("tt_lin", geo.warps, geo.groups, np_cam, itemsize)


@pytest.mark.parametrize("dtype,np_cam", TT_W_ENTRIES)
def test_tt_wt_geometry_fits_and_covers(dtype, np_cam):
    """B14: the per-slot W^T x parts alone, no row tile and no meta."""
    _fits_and_covers("tt_wt", dtype, np_cam, False, "tt")
    itemsize = torch.empty((), dtype=dtype).element_size()
    geo = slot_geometry("tt_wt", 2, 67584, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks) == (2, 4, 1)
    assert geo.smem == 8 * 3 * 32 * itemsize
    geo = slot_geometry("tt_wt", 40, 300, np_cam, itemsize)
    assert (geo.warps, geo.groups, geo.chunks, geo.blocks) == (14, 1, 3, 10)


@pytest.mark.parametrize("address,pc,itemsize,vec", [
    (0, 512, 1, 16),  # the medium buckets, int8: 16-byte loads
    (0, 300, 1, 4),  # Pc = 300 bytes per slot row: 4-byte aligned only
    (0, 520, 1, 8),
    (0, 301, 1, 1),  # an odd Pc: byte loads
    (0, 302, 1, 1),  # 2-byte aligned: no 2-byte width, byte loads
    (8, 512, 1, 8),  # the address limits the width
    (1, 512, 1, 1),
    (0, 300, 4, 16),  # f32: 1200 bytes per slot row
    (0, 301, 4, 4),
    (0, 302, 4, 8),
    (4, 512, 4, 4),
    (0, 3, 8, 8),  # f64: never narrower than an entry
    (0, 2, 8, 16),
    (8, 512, 8, 8),
])
def test_onehot_vector_bytes(address, pc, itemsize, vec):
    """B6's one-hot load width: the widest of 16, 8, 4, 1 bytes, no
    narrower than an entry, that divides the address and Pc entries."""
    assert onehot_vector_bytes(address, pc, itemsize) == vec


def test_onehot_vector_bytes_refuses_a_misaligned_one_hot():
    with pytest.raises(ValueError, match="aligned"):
        onehot_vector_bytes(2, 512, 4)


@pytest.mark.parametrize("kernel,itemsize", [("lin", 4), ("lin", 8), ("coupling", 4),
                                             ("coupling", 8), ("onehot", 4), ("tt_w", 8),
                                             ("tt_lin", 4), ("tt_lin", 8), ("tt_wt", 8),
                                             ("contrib", 4), ("contrib", 8),
                                             ("tt_coupling", 4), ("tt_coupling", 8)])
def test_geometry_one_chunk_up_to_the_thread_limit(kernel, itemsize):
    """A track of up to max_threads / 32 slots runs in one chunk (each slot
    stays in registers from phase 1 to phase 2); a short track shares its
    block with other point groups, 8 warps in all where Pc allows."""
    max_warps = max_threads(kernel, itemsize) // 32
    for tb in range(1, max_warps + 1):
        geo = slot_geometry(kernel, tb, 67584, 8, itemsize)
        assert (geo.warps, geo.chunks) == (tb, 1)
        assert geo.groups == max(1, 8 // tb)
    geo = slot_geometry(kernel, max_warps + 1, 67584, 8, itemsize)
    assert geo.chunks == 2 and geo.warps == -(-(max_warps + 1) // 2)


@pytest.mark.parametrize("kernel", ["lin", "contrib"])
def test_geometry_shrinks_to_the_shared_limit(kernel):
    """Under a small per-block limit the groups, then the warps per group,
    shrink until the bytes fit (B1 and B8 f64 np 12 with od have the widest
    layouts)."""
    full = slot_geometry(kernel, 8, 67584, 12, 8, True)
    limit = slot_smem(kernel, 4, 1, 12, 8, True)
    small = slot_geometry(kernel, 8, 67584, 12, 8, True, limit=limit)
    assert full.smem > limit >= small.smem
    assert (small.warps, small.groups, small.chunks) == (4, 1, 2)
    with pytest.raises(ValueError, match="kernel"):
        slot_geometry("cost", 2, 10, 8, 4)


@pytest.mark.parametrize("np_cam,use_sj,want_od,k", [
    (8, False, False, 52), (8, True, False, 88), (8, True, True, 152),
    (10, False, False, 75), (10, True, False, 130), (10, True, True, 230),
    (12, False, False, 102), (12, True, False, 180), (12, True, True, 324),
])
def test_b1_row_width(np_cam, use_sj, want_od, k):
    """K of B1's rows: u (np(np+1)/2) | g (np) [| coupling] | rhs (np)
    [| od (np^2)]: the columns the kernel's row tile walks."""
    assert n_rows_cols(np_cam, use_sj, want_od) == k
