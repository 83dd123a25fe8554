"""Batched pose refinement with the frame batch sharded over a mesh.

Counterpart of ``tpu3drecon/parallel/sharded_pose.py``: each rank refines
its contiguous block of the frames with the batched LM
(``solvers/pose_refine.refine_poses``).  The frames are independent, so
the solve makes no collective; one ``all_gather`` at the end returns the
whole batch's cameras and per-frame LM state on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.parallel.mesh import Mesh, make_mesh
from tpu3drecon_torch.problems.packing import CameraParams, PoseProblem
from tpu3drecon_torch.solvers.lm_core import LMConfig, LMState
from tpu3drecon_torch.solvers.pose_refine import refine_poses


def shard_pose_problem(problem: PoseProblem, mesh: Mesh, axis_name: str = "obs") -> PoseProblem:
    """This rank's block of the frame batch; the width is replicated.  The
    batch must divide by the mesh size (pad it with masked frames)."""
    c = problem.cameras
    return PoseProblem(
        cameras=CameraParams(
            rmats=mesh.shard(c.rmats), tvecs=mesh.shard(c.tvecs), fx_fy=mesh.shard(c.fx_fy),
            cx_cy_skew=mesh.shard(c.cx_cy_skew), dist=mesh.shard(c.dist),
        ),
        points3d=mesh.shard(problem.points3d),
        points2d=mesh.shard(problem.points2d),
        mask=mesh.shard(problem.mask),
        avg_cam_width=mesh.replicate(problem.avg_cam_width),
    )


def _gather_lanes(mesh: Mesh, fields: dict) -> dict:
    """Every rank's per-frame fields in one all_gather: each field flattened
    to (B_local, n) in the first float field's dtype, concatenated, gathered
    and split back to its dtype and shape (integer and boolean fields hold
    small counts and flags, exact in that dtype)."""
    dtype = next(v for v in fields.values() if v.is_floating_point()).dtype
    flat = [v.reshape(v.shape[0], -1) for v in fields.values()]
    whole = mesh.all_gather(torch.cat([f.to(dtype) for f in flat], dim=1))
    out, off = {}, 0
    for (name, v), f in zip(fields.items(), flat):
        n = f.shape[1]
        out[name] = whole[:, off : off + n].reshape((-1,) + v.shape[1:]).to(v.dtype)
        off += n
    return out


def refine_poses_sharded(
    problem: PoseProblem,
    mesh: Optional[Mesh] = None,
    loss: RobustLoss = RobustLoss.CAUCHY,
    config: LMConfig = LMConfig(maxiter=100, gtol=1e-7),
    axis_name: str = "obs",
) -> Tuple[CameraParams, LMState]:
    """Refine every frame of a PoseProblem with the batch sharded over the
    mesh (default: the whole group); returns (CameraParams, LMState) of the
    whole batch on every rank."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    placed = shard_pose_problem(problem, mesh, axis_name)
    cams, state = refine_poses(placed, loss=loss, config=config, device=mesh.device)
    cam_names = [f.name for f in dataclasses.fields(CameraParams)]
    fields = {f"cam_{n}": getattr(cams, n) for n in cam_names}
    fields.update(state._asdict())
    whole = _gather_lanes(mesh, fields)
    cameras = CameraParams(**{n: whole[f"cam_{n}"] for n in cam_names})
    return cameras, LMState(**{n: whole[n] for n in LMState._fields})
