"""The flat engine with the observation axis sharded over a mesh.

Counterpart of ``tpu3drecon/parallel/sharded_ba.py``: every rank runs the
flat ``ba_solve`` (``solvers/bundle_adjust.py``) on its block of the
observation arrays with the mesh as its communicator.  Each rank
linearizes its observations and all-reduces the U/V blocks and gradients;
cameras and points are replicated, so every rank runs the same
trust-region and CG control flow in lockstep and returns the same bits.

Collectives per LM iteration: one all-reduce each of U, V, g_c, g_p (and
the Schur-Jacobi coupling) at the linearization, one for the rhs W V^-1 g_p,
two per CG iteration (W^T x and W y), one for the back-substitution and
one for the candidate's loss.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from tpu3drecon_torch.parallel.mesh import OBS_AXIS, Mesh, make_mesh, shard_ba_problem
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState, ba_solve

def make_sharded_ba_solver(mesh: Mesh, config: BAConfig = BAConfig(),
                           axis_name: str = OBS_AXIS):
    """``placed -> ba_solve(placed, config)`` over ``mesh``, for a problem
    placed with ``shard_ba_problem``; returns (cameras, points3d, state),
    replicated.  JAX's factory caches a jitted executable per mesh and
    config; eager PyTorch has nothing to keep (ROADMAP A.8)."""
    return functools.partial(ba_solve, config=config, device=mesh.device, comm=mesh)


def ba_solve_sharded(
    problem: BAProblem,
    config: BAConfig = BAConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: str = OBS_AXIS,
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """One-call sharded flat solve: the mesh (default: the whole group),
    this rank's placement, the solve."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    placed = shard_ba_problem(problem, mesh, axis_name)
    return make_sharded_ba_solver(mesh, config, axis_name)(placed)
