"""Helpers of the tests of the port's sharded solves (tests/test_torch_sharding.py,
tests/test_torch_sharded_{wtt,tt,grid}.py).

``run_ranks`` starts a gloo group of local ranks
(``tpu3drecon_torch.parallel.distributed.launch``, one intra-op thread each,
a timeout on every collective and a deadline on the group), runs a list of
solves in it (``call_each``) and asserts that every rank returned the same
bits; it returns rank 0's results as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu3drecon_torch.parallel.distributed import launch

WTT = "tpu3drecon_torch.parallel.sharded_wtt.ba_solve_wtt_sharded"
TT = "tpu3drecon_torch.parallel.sharded_tt.ba_solve_tt_sharded"
GRID = "tpu3drecon_torch.parallel.sharded_grid.ba_solve_grid_sharded"
FLAT = "tpu3drecon_torch.parallel.sharded_ba.ba_solve_sharded"
POSE = "tpu3drecon_torch.parallel.sharded_pose.refine_poses_sharded"


def leaves(x) -> list:
    """The arrays and scalars of a result tree, in order."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [v for f in dataclasses.fields(x) for v in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in leaves(item)]
    return [x]


def run_ranks(world_size: int, calls, timeout_s: float = 60.0) -> list:
    """``calls`` ((target, args, kwargs) each) run in ``world_size`` gloo
    ranks on the CPU; every rank's results must be bit-equal."""
    results = launch("tpu3drecon_torch.parallel.distributed.call_each", world_size,
                     args=(list(calls),), backend="gloo", device="cpu",
                     timeout_s=timeout_s, deadline_s=timeout_s + 180)
    first = leaves(results[0])
    for rank, other in enumerate(results[1:], start=1):
        got = leaves(other)
        assert len(got) == len(first)
        for a, b in zip(first, got):
            a, b = np.asarray(a), np.asarray(b)
            assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), \
                f"rank {rank} differs from rank 0"
    return results[0]


def rank_mesh(rank: int, size: int):
    """A stand-in for rank ``rank`` of a ``size``-rank CPU mesh: the
    placement methods of ``Mesh`` (``block``, ``shard``, ``replicate``) need
    no process group."""
    import torch

    from tpu3drecon_torch.parallel.mesh import Mesh

    mesh = Mesh.__new__(Mesh)
    mesh.rank, mesh.size, mesh.device = rank, size, torch.device("cpu")
    return mesh


def one_rank_all_reduce(mesh) -> int:
    """Rank 0 enters an all-reduce that the other ranks skip: a rank that
    took another branch than its peers (the launcher must fail, not hang)."""
    import torch

    if mesh.rank == 0:
        mesh.psum(torch.ones(1))
    return mesh.rank


def sleep(seconds: float, mesh) -> int:
    """Outlives a short deadline."""
    import time

    time.sleep(seconds)
    return mesh.rank
