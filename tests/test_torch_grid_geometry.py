"""The lanes per thread of the grid engine's camera kernels B9 and B11
(``ops/cam_normal.grid_lanes``): pins at the medium and tt_seq1024 grid
shapes, every lane of a camera row visited once by the kernels' loop, and
the C entries' argument lists.  Pure Python: no JAX and no card."""

import numpy as np
import pytest
import torch

from tpu3drecon_torch.ops import _build, cam_normal
from tpu3drecon_torch.ops.cam_normal import grid_lanes, launch_lanes


@pytest.mark.parametrize("k,itemsize,want", [
    # The medium grid problem's K = 2048: two steps of four float32 lanes a
    # thread; float64 one lane.
    (2048, 4, 4),
    (2048, 8, 1),
    (4096, 4, 4),
    # tt_seq1024's grid packing, K 1024 (one step of four lanes a thread)
    # and K 256: one lane.
    (1024, 4, 1),
    (256, 4, 1),
    # Just below two steps of four lanes; the GPU tests' odd widths.
    (2047, 4, 1),
    (300, 4, 1),
])
def test_grid_lanes_pins(k, itemsize, want):
    assert grid_lanes(k, itemsize) == want


@pytest.mark.parametrize("itemsize", [4, 8])
def test_grid_lanes_rule(itemsize):
    """Four lanes a thread only in float32 and where each of a block's
    threads takes two steps of them; the pick is a value the C entries
    take."""
    for k in (0, 1, 255, 256, 300, 1000, 1024, 2047, 2048, 4096, 10000):
        lanes = grid_lanes(k, itemsize)
        assert lanes in cam_normal.LANES
        assert lanes == (4 if itemsize == 4 and k >= 2 * 4 * cam_normal.THREADS else 1)


def test_launch_lanes_forced_or_picked():
    t32 = torch.zeros(1, dtype=torch.float32)
    t64 = torch.zeros(1, dtype=torch.float64)
    assert launch_lanes(2048, t32) == 4 and launch_lanes(2048, t64) == 1
    assert launch_lanes(2048, t32, 1) == 1 and launch_lanes(300, t64, 4) == 4


def visited_lanes(k: int, lanes: int) -> list:
    """The lanes of one camera row in the order of the loop of B9's and
    B11's kernels (``csrc/grid_kernels.cu``): thread x, then step, lanes
    base .. base + LPT - 1 below K for base = x LPT, (x + 256) LPT, ..."""
    threads = cam_normal.THREADS
    out = []
    for x in range(threads):
        for base in range(x * lanes, k, threads * lanes):
            out.extend(range(base, min(base + lanes, k)))
    return out


def test_every_lane_visited_once():
    """For random K and each LPT the kernels' loop visits every lane of a
    camera row exactly once; at LPT 1 thread x takes lanes x, x + 256, ..."""
    rng = np.random.default_rng(15)
    ks = [0, 1, 31, 256, 300, 1000, 1023, 2048, 4097]
    ks += [int(v) for v in rng.integers(0, 6000, size=40)]
    for k in ks:
        for lanes in cam_normal.LANES:
            assert sorted(visited_lanes(k, lanes)) == list(range(k)), (k, lanes)
    assert visited_lanes(600, 1)[:3] == [0, 256, 512]


@pytest.mark.parametrize("name,n_args,tail", [
    ("grid_cam_normal", 24, "C K P loss lanes stream"),
    ("grid_coupling", 13, "C K P lanes stream"),
])
def test_grid_entries_take_their_lanes(name, n_args, tail):
    """B9's and B11's C entries end in the grid's sizes, the points' count
    P (the kernels' bound on pt_idx) and ``grid_lanes``' LPT before the
    stream, and their ctypes lists have as many arguments."""
    from test_torch_memory_modes import _c_sources

    args = [a.strip().rsplit(" ", 1)[-1].lstrip("*")
            for a in " ".join(_c_sources()[name].split()).split(",")]
    assert len(args) == n_args == len(_build._SIGNATURES[name])
    assert args[-len(tail.split()):] == tail.split()
