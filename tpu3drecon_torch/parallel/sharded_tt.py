"""The dense track-table engine with the point axis sharded over a mesh.

Counterpart of ``tpu3drecon/parallel/sharded_tt.py``.  The track-table
layout (``problems/tt.py``, ``solvers/ba_tt.py``) shards along one axis,
the point axis (the last axis of every bucket plane):

  - each rank holds its block of every bucket's points: the uv and mask
    planes, the slot cameras ``cam_ids`` (the port keeps them in place of
    JAX's one-hot, ROADMAP A.8) and the point planes (3, Pb), and does all
    point-side math on them with no collective;
  - the camera table and the CG state are replicated; the collectives are
    all-reduces of (C, np)-sized camera sums (the linearization's columns,
    one per CG matvec, the rhs) and of the scalar cost, predicted
    reduction and gradient maximum.

The solve body is ``ba_tt._ba_solve_tt_core`` with the mesh as its
communicator, on ``kernels=False``, the route JAX's sharded solve runs
(PyTorch products through ``cam_ids``).  JAX's jitted factory
``make_sharded_tt_solver`` keys XLA's cache and has no counterpart
(ROADMAP A.8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu3drecon_torch.parallel.mesh import Mesh, make_mesh
from tpu3drecon_torch.problems.grid import unpermute_points
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.problems.tt import BATTProblem, TTBucket
from tpu3drecon_torch.solvers.ba_tt import _ba_solve_tt_core, _check_config, _tt_state
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState

SHARD_AXIS = "shard"


class _TTView:
    """The fields ``_ba_solve_tt_core`` reads, as this rank's shards."""

    def __init__(self, cameras, buckets, avg_cam_width):
        self.cameras = cameras
        self.buckets = buckets
        self.avg_cam_width = avg_cam_width
        self.n_cameras = cameras.rmats.shape[0]


def _check_divisible(problem: BATTProblem, n_devices: int) -> None:
    for b in problem.buckets:
        pb = b.mask.shape[1]
        if pb % n_devices:
            raise ValueError(
                f"bucket point axis {pb} not divisible by mesh size "
                f"{n_devices}; rebuild with tt_from_flat(point_block=k*"
                f"{n_devices})"
            )


def shard_tt_problem(
    problem: BATTProblem, mesh: Mesh, axis_name: str = SHARD_AXIS
) -> Tuple[Tuple[TTBucket, ...], Tuple[torch.Tensor, ...], CameraParams, torch.Tensor]:
    """This rank's part of a track-table problem: (buckets, point planes,
    cameras, avg_cam_width), every bucket plane and each bucket's point
    planes (3, Pb) cut to the rank's block of the point axis, the cameras
    and width whole."""
    _check_divisible(problem, mesh.size)
    buckets = tuple(
        TTBucket(uv=mesh.shard(b.uv, dim=2), mask=mesh.shard(b.mask, dim=1),
                 cam_ids=mesh.shard(b.cam_ids, dim=1))
        for b in problem.buckets
    )
    pts = tuple(
        mesh.shard(problem.points3d[off : off + b.mask.shape[1]].T, dim=1)
        for b, off in zip(problem.buckets, problem.bucket_offsets)
    )
    return (buckets, pts, problem.cameras.to(mesh.device),
            mesh.replicate(problem.avg_cam_width))


def ba_solve_tt_sharded(
    problem: BATTProblem,
    config: BAConfig = BAConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: Optional[str] = None,
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Sharded track-table solve over ``mesh`` (default: the whole group);
    the outputs of ``ba_solve_tt`` (points in their original order), whole
    on every rank."""
    _check_config(config, False)
    torch.set_float32_matmul_precision("highest")
    mesh = mesh or make_mesh(axis_name=axis_name or SHARD_AXIS)
    buckets, pts, cams, avg_w = shard_tt_problem(problem, mesh)
    view = _TTView(cams, buckets, avg_w)
    cameras, pts_out, final = _ba_solve_tt_core(view, pts, config, False, comm=mesh)
    points3d = torch.cat([mesh.all_gather(p.T) for p in pts_out], dim=0)
    pts_full = unpermute_points(points3d, problem)
    return cameras, pts_full, _tt_state(cameras, pts_full, final)
