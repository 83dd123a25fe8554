"""The memory-mode choice of B15 and the C interface of the kernel library,
checked without a card.

Every kernel reads its camera rows and x from device memory and reduces
straight into its output rows, so no window width or camera count is
refused.  B15 (``tt_w_times_fused``) alone also keeps a shared-memory mode,
a block-shared (C, np) tile of its camera rows, which measured faster on
the H100 at 100 cameras and slower at 1024; one pure-Python function picks
the mode from the tile's entries: shared at or below
``tt_linearize.TILE_ENTRIES``, global above.

The ctypes argument lists of ``ops/_build.py`` must match the C entries of
``csrc/*.cu`` one for one: an argument too few passes the stream pointer as
a C int.
"""

import ctypes
import re

import pytest

from tpu3drecon_torch.ops import _build, tt_linearize

SHARED, GLOBAL = _build.SHARED, _build.GLOBAL


@pytest.mark.parametrize("n_cams,np_cam,want", [
    (100, 8, SHARED),  # the medium problem
    (256, 8, SHARED),
    (257, 8, GLOBAL),
    (170, 12, SHARED),
    (171, 12, GLOBAL),
    (1024, 8, GLOBAL),  # tt_seq1024
])
def test_tt_w_times_pins(n_cams, np_cam, want):
    """B15: the (C, np) tile's entries against TILE_ENTRIES = 2048."""
    assert tt_linearize.memory_mode(n_cams, np_cam) == want


FAMILIES = {  # id -> the mode of a tile of `entries` (C, np) entries
    "B15": lambda entries: tt_linearize.memory_mode(entries // 8, 8),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shared_at_and_below_the_limit_global_above(family):
    limit = tt_linearize.TILE_ENTRIES
    assert FAMILIES[family](limit) == SHARED
    assert FAMILIES[family](limit - 8) == SHARED
    assert FAMILIES[family](limit + 8) == GLOBAL


def test_forced_mode_overrides_and_is_checked():
    assert tt_linearize.memory_mode(9000, 8, forced=SHARED) == SHARED
    assert tt_linearize.memory_mode(100, 8, forced=GLOBAL) == GLOBAL
    with pytest.raises(ValueError, match="_mode"):
        tt_linearize.memory_mode(100, 8, forced="l2")
    assert tt_linearize.shared_memory_bytes(9000, 8, 4) == 288_000


def test_launch_counter_splits_modes():
    c = _build.LaunchCounter()
    c.launched(SHARED)
    c.launched(GLOBAL)
    c.launched(GLOBAL)
    c.plain += 1
    assert (c.kernel, c.plain, c.modes) == (3, 1, {SHARED: 1, GLOBAL: 2})
    c.reset()
    assert (c.kernel, c.plain, c.modes) == (0, 0, {})


_C_TYPES = {"int": ctypes.c_int, "double": ctypes.c_double}


def _c_sources():
    """name -> the argument text of every C entry in csrc/*.cu."""
    entries = {}
    for path in sorted(_build._CSRC.glob("*.cu")):
        text = path.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
            for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
                entries[name] = args
        for name, args in re.findall(r'^extern "C" int (\w+)\(([^)]*)\)', text, re.M):
            entries[name] = args
    return entries


def _c_entries():
    """name -> ctypes argument list of every C entry in csrc/*.cu."""
    out = {}
    for name, args in _c_sources().items():
        kinds = []
        for arg in " ".join(args.split()).split(","):
            ctype = arg.strip().rsplit(" ", 1)[0]
            kinds.append(ctypes.c_void_p if "*" in arg else _C_TYPES[ctype])
        out[name] = kinds
    return out


def test_ctypes_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(entries) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert entries[name] == argtypes, name


@pytest.mark.parametrize("name,n_args,tail", [
    ("wtt_linearize", 31, "tc ng smem stream"),
    ("wtt_coupling", 17, "tc ng smem stream"),
    ("tt_cam_normal", 25, "tc ng smem stream"),
    ("tt_wt_times", 15, "tc ng smem stream"),
    ("tt_w_times", 16, "tc ng smem tile stream"),
    ("wtt_contrib", 18, "tc ng smem stream"),
    ("tt_coupling", 15, "tc ng smem stream"),
])
def test_slot_major_entries_take_their_geometry(name, n_args, tail):
    """The C entries of the slot-major kernels (B1, B2, B8, B12-B15) end
    in the launch geometry of ``slot_geometry`` (and B15's tile bytes)
    before the stream, and their ctypes lists have as many
    arguments: the entries check tc, ng and smem against the kernels' own
    count."""
    args = [a.strip().rsplit(" ", 1)[-1].lstrip("*")
            for a in " ".join(_c_sources()[name].split()).split(",")]
    assert len(args) == n_args == len(_build._SIGNATURES[name])
    assert args[-len(tail.split()):] == tail.split()
