"""The windowed track-table engine with the chunk axis sharded over a mesh.

Counterpart of ``tpu3drecon/parallel/sharded_wtt.py``.  The wtt layout
(``problems/wtt.py``, ``solvers/ba_wtt.py``) shards along its chunk axis,
the leading axis of every bucket array:

  - each rank holds its block of every bucket's chunks: uv, mask,
    ``cam_base``, ``wcam`` and the dense one-hot where the packing has one,
    and the point planes (3, G, Pc), and does all point-side math (V,
    V^-1, g_p, the back-substituted dp) on them;
  - the camera table (``c_pad`` rows) and the CG state are replicated; the
    collectives are all-reduces of (c_pad, np)-sized camera sums (the
    linearization's columns, one per CG matvec, the rhs) and of the scalar
    cost, predicted reduction and gradient maximum.

The window, ``global_tiles`` and ``global_tile0`` are per-bucket
attributes, the same on every rank.  The solve body is the single-device
engine's (``ba_wtt._ba_solve_wtt_core`` with the mesh as its
communicator), so it runs the route ``BAConfig`` picks: with the index
kernels (``matvec_kernel``/``linearize_kernel`` "index"), B1-B4 on each
rank's shard; on the unfused and one-hot routes, B7, B8 and B5, B2, B3 or
B6.  JAX's jitted factory ``make_sharded_wtt_solver`` keys XLA's cache and
has no counterpart (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpu3drecon_torch.parallel.mesh import Mesh, make_mesh
from tpu3drecon_torch.problems.grid import unpermute_points
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.problems.wtt import BAWTTProblem, WTTBucket, unpermute_cameras
from tpu3drecon_torch.solvers.ba_tt import _tt_state
from tpu3drecon_torch.solvers.ba_wtt import _ba_solve_wtt_core, _check_config
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState

SHARD_AXIS = "shard"


class _WTTView:
    """The fields ``_ba_solve_wtt_core`` reads, as this rank's shards."""

    def __init__(self, cameras, buckets, avg_cam_width, c_pad):
        self.cameras = cameras
        self.buckets = buckets
        self.avg_cam_width = avg_cam_width
        self.c_pad = c_pad


def _check_divisible(problem: BAWTTProblem, n_devices: int) -> None:
    for b in problem.buckets:
        g = b.uv.shape[0]
        if g % n_devices:
            raise ValueError(
                f"bucket chunk axis {g} not divisible by mesh size "
                f"{n_devices}; rebuild with wtt_from_flat(chunk_multiple="
                f"{n_devices})"
            )


def _shard_or_none(mesh: Mesh, x):
    return None if x is None else mesh.shard(x)


def shard_wtt_problem(
    problem: BAWTTProblem, mesh: Mesh, axis_name: str = SHARD_AXIS
) -> Tuple[Tuple[WTTBucket, ...], Tuple[torch.Tensor, ...], CameraParams, torch.Tensor]:
    """This rank's part of a windowed track-table problem: (buckets,
    point planes, cameras, avg_cam_width), every bucket array and each
    bucket's point planes (3, G, Pc) cut to the rank's block of the chunk
    axis, the cameras and width whole."""
    _check_divisible(problem, mesh.size)
    buckets = tuple(
        dataclasses.replace(
            b, uv=mesh.shard(b.uv), mask=mesh.shard(b.mask), cam_base=mesh.shard(b.cam_base),
            wcam=_shard_or_none(mesh, b.wcam), onehot=_shard_or_none(mesh, b.onehot),
        )
        for b in problem.buckets
    )
    pts = []
    for b, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, _, pc = b.uv.shape
        block = problem.points3d[off : off + g * pc]
        pts.append(mesh.shard(block.reshape(g, pc, 3).permute(2, 0, 1), dim=1))
    return (buckets, tuple(pts), problem.cameras.to(mesh.device),
            mesh.replicate(problem.avg_cam_width))


def ba_solve_wtt_sharded(
    problem: BAWTTProblem,
    config: BAConfig = BAConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: Optional[str] = None,
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Sharded windowed track-table solve over ``mesh`` (default: the whole
    group); the outputs of ``ba_solve_wtt`` (cameras and points in their
    original order), whole on every rank."""
    _check_config(config, problem)
    torch.set_float32_matmul_precision("highest")
    mesh = mesh or make_mesh(axis_name=axis_name or SHARD_AXIS)
    buckets, pts, cams, avg_w = shard_wtt_problem(problem, mesh)
    view = _WTTView(cams, buckets, avg_w, problem.c_pad)
    cameras, pts_out, final = _ba_solve_wtt_core(view, pts, config, mesh.device, comm=mesh)
    # (3, G_local, Pc) planes -> (G, Pc, 3) rows in rank order, per bucket.
    points3d = torch.cat(
        [mesh.all_gather(p.permute(1, 2, 0)).reshape(-1, 3) for p in pts_out], dim=0)
    pts_full = unpermute_points(points3d, problem)
    cameras = unpermute_cameras(cameras, problem.cam_rows)
    return cameras, pts_full, _tt_state(cameras, pts_full, final)
