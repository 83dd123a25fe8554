"""The memory-mode choice of B6 and B15 and the C interface of the kernel
library, checked without a card.

Every staged kernel reads its camera rows and x from device memory and
reduces straight into its output rows, so no window width or camera count
is refused.  B6 (``wtt_coupling_rows_fused``) and B15
(``tt_w_times_fused``) also keep a shared-memory mode, which measured
faster on the H100 where its tiles fit; each has one pure-Python function
that gives the bytes of its shared tiles and the mode picked from them:
shared at or below the card's per-block limit, global above it.  The limit
stated here is the H100's opt-in shared memory per block, 232,448 bytes.

The ctypes argument lists of ``ops/_build.py`` must match the C entries of
``csrc/*.cu`` one for one: an argument too few passes the stream pointer as
a C int.
"""

import ctypes
import re

import pytest

from tpu3drecon_torch.ops import _build, tt_linearize, wtt_matvec

H100 = 232_448
SHARED, GLOBAL = _build.SHARED, _build.GLOBAL
F32, F64 = 4, 8


@pytest.mark.parametrize("w,np_cam,tb,itemsize,want", [
    (128, 8, 4, F32, (10_272, SHARED)),  # the medium buckets
    (1664, 8, 12, F32, (112_672, SHARED)),  # the hub layout's widest window
    (1152, 12, 4, F64, (223_328, SHARED)),
    (1280, 12, 4, F64, (247_904, GLOBAL)),
])
def test_fused_coupling_pins(w, np_cam, tb, itemsize, want):
    """B6: the (Tb, 256) int16 row table plus the (np, W + 1) x window and
    the (np, W) rows tile."""
    assert wtt_matvec.memory_mode(w, np_cam, tb, itemsize, H100) == want


@pytest.mark.parametrize("n_cams,np_cam,itemsize,want", [
    (1024, 8, F32, (32_768, SHARED)),  # tt_seq1024
    (7264, 8, F32, (232_448, SHARED)),
    (7265, 8, F32, (232_480, GLOBAL)),
    (2421, 12, F64, (232_416, SHARED)),
    (2422, 12, F64, (232_512, GLOBAL)),
])
def test_tt_w_times_pins(n_cams, np_cam, itemsize, want):
    """B15: the (C, np) rows tile."""
    assert tt_linearize.memory_mode(n_cams, np_cam, itemsize, H100) == want


FAMILIES = {  # id -> (bytes, mode) of the shared tiles under the limit given
    "B6": lambda limit: wtt_matvec.memory_mode(896, 8, 3, F32, limit),
    "B15": lambda limit: tt_linearize.memory_mode(500, 10, F64, limit),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shared_at_and_below_the_limit_global_above(family):
    need, _ = FAMILIES[family](H100)
    assert FAMILIES[family](need) == (need, SHARED)
    assert FAMILIES[family](need + 1) == (need, SHARED)
    assert FAMILIES[family](need - 1) == (need, GLOBAL)


def test_forced_mode_overrides_and_is_checked():
    assert _build.memory_mode(10, 5, forced=SHARED) == SHARED
    assert _build.memory_mode(10, 50, forced=GLOBAL) == GLOBAL
    with pytest.raises(ValueError, match="_mode"):
        _build.memory_mode(10, 50, forced="l2")
    assert wtt_matvec.memory_mode(128, 8, 4, F32, H100, forced=GLOBAL) == (10_272, GLOBAL)
    assert tt_linearize.memory_mode(9000, 8, F32, H100, forced=SHARED) == (288_000, SHARED)


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


def _c_entries():
    """name -> ctypes argument list of every C entry in csrc/*.cu."""
    entries = {}
    for path in sorted(_build._CSRC.glob("*.cu")):
        text = path.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
            for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
                entries[name] = args
        for name, args in re.findall(r'^extern "C" int (\w+)\(([^)]*)\)', text, re.M):
            entries[name] = args
    out = {}
    for name, args in entries.items():
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
