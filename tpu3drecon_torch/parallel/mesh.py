"""Process-group meshes: the communicator of the sharded solves.

Counterpart of ``tpu3drecon/parallel/mesh.py``.  JAX's 1-D device mesh
becomes a ``torch.distributed`` process group, one process per device
(NCCL on the card, gloo on the CPU), and ``shard_map`` becomes the same
per-rank body run in every process on the rank's contiguous block of the
sharded axis, the placement that JAX's ``P(axis)`` gives.  A ``Mesh`` is
also the communicator the engines take (``comm=None``: one device, no
collective):

  - ``jax.lax.psum`` -> ``Mesh.psum``, ``all_reduce(SUM)``;
  - ``jax.lax.pmax`` -> ``Mesh.pmax``, ``all_reduce(MAX)``;
  - ``all_gather(tiled=True)`` -> ``Mesh.all_gather``, an ``all_gather``
    of equal blocks concatenated in rank order.

Gloo's and NCCL's all-reduce give every rank the same bits, so a
decision taken on an all-reduced value is taken alike on every rank; a
rank that took another branch would wait in its next collective until the
group's timeout.  ``Mesh.counts`` counts the collectives a solve made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from tpu3drecon_torch.device import resolve_device

OBS_AXIS = "obs"

# The device type each backend's collectives take: gloo has no all_gather
# of CUDA tensors, and NCCL takes CUDA tensors only.
_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


@dataclasses.dataclass
class CollectiveCounts:
    """Collectives made through one mesh since the last ``reset``."""

    all_reduce: int = 0
    all_gather: int = 0

    def reset(self) -> None:
        self.all_reduce = 0
        self.all_gather = 0


class Mesh:
    """A 1-D mesh over the processes of ``group`` (None: the default group):
    this process's ``rank`` of ``size``, the ``device`` its tensors live on,
    and the collectives over the group."""

    def __init__(self, group=None, device=None, axis_name: str = OBS_AXIS):
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group: call parallel.distributed.initialize_distributed "
                "(or torch.distributed.init_process_group) first"
            )
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = resolve_device(device)
        self.axis_name = axis_name
        self.backend = dist.get_backend(group)
        want = _BACKEND_DEVICE.get(self.backend)
        if want is not None and self.device.type != want:
            raise ValueError(
                f"the {self.backend} backend takes {want} tensors; this mesh's device "
                f"is {self.device}"
            )
        self.counts = CollectiveCounts()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, on every rank."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.counts.all_reduce += 1
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks, on every rank."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        self.counts.all_reduce += 1
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along axis 0 in rank
        order: JAX's ``all_gather(tiled=True)``."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self.counts.all_gather += 1
        return torch.cat(parts)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of length ``n``."""
        if n % self.size:
            raise ValueError(f"axis of {n} not divisible by mesh size {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim``, contiguous, on the mesh's
        device (the whole tensor at size 1)."""
        sl = self.block(x.shape[dim])
        return x[(slice(None),) * dim + (sl,)].to(self.device).contiguous()

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` whole on the mesh's device."""
        return x.to(self.device)


def psum(x: torch.Tensor, comm: Optional[Mesh]) -> torch.Tensor:
    """``comm.psum(x)``, or ``x`` on one device (``comm`` None)."""
    return x if comm is None else comm.psum(x)


def pmax(x: torch.Tensor, comm: Optional[Mesh]) -> torch.Tensor:
    """``comm.pmax(x)``, or ``x`` on one device (``comm`` None)."""
    return x if comm is None else comm.pmax(x)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = OBS_AXIS,
              device=None) -> Mesh:
    """A mesh over the default process group (one process per device).
    ``n_devices``, where given, must be the group's size: the processes of
    a mesh are started with it (``parallel.distributed.launch``)."""
    mesh = Mesh(device=device, axis_name=axis_name)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {mesh.size} ranks"
        )
    return mesh


def mesh_key(mesh: Mesh) -> tuple:
    """Hashable identity of a mesh by its content (backend, size, rank,
    device, axis name), never by ``id``."""
    return (mesh.backend, mesh.size, mesh.rank, str(mesh.device), mesh.axis_name)


def obs_sharding(mesh: Mesh, axis_name: str = OBS_AXIS):
    """Placement of flat observation arrays: the rank's block of the
    leading axis."""
    return mesh.shard


def replicated_sharding(mesh: Mesh):
    """Placement of replicated arrays: the whole tensor on every rank."""
    return mesh.replicate


def shard_ba_problem(problem, mesh: Mesh, axis_name: str = OBS_AXIS):
    """This rank's part of a BAProblem: the observation arrays' block, the
    cameras, points and width whole.  The packers pad observations to a
    multiple of 1024, so any mesh size up to 1024 divides them."""
    from tpu3drecon_torch.problems.packing import BAProblem

    obs = obs_sharding(mesh, axis_name)
    return BAProblem(
        cameras=problem.cameras.to(mesh.device),
        points3d=mesh.replicate(problem.points3d),
        cam_idx=obs(problem.cam_idx),
        pt_idx=obs(problem.pt_idx),
        uv=obs(problem.uv),
        mask=obs(problem.mask),
        avg_cam_width=mesh.replicate(problem.avg_cam_width),
    )
