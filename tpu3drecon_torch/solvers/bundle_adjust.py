"""Bundle-adjustment configuration, state and evaluation metric.

Counterpart of ``tpu3drecon/solvers/bundle_adjust.py:35-228, 469-487``:
``BAConfig`` has the same fields and defaults (the option documentation
lives with the JAX reference), ``BAState`` the same fields.  The flat
engine itself is not ported yet; the windowed track-table engine
(solvers/ba_wtt.py) returns these types.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops.jacobians import gather_obs_blocks
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams


class BAConfig(NamedTuple):
    """Outer-LM + inner-CG configuration (fields as in the JAX package)."""

    maxiter: int = 50
    gtol: float = 1e-8  # inf-norm of the (whitened) gradient
    ftol: float = 1e-12  # relative cost decrease on accepted steps
    init_lambda: float = 1e-4
    min_lambda: float = 1e-32
    max_lambda: float = 1e32
    cg_maxiter: int = 100
    cg_rtol: float = 1e-5
    loss: RobustLoss = RobustLoss.TRIVIAL
    optimize_focal: bool = True
    optimize_points: bool = True
    optimize_dist: bool = False
    optimize_pp: bool = False
    precond: str = "schur_jacobi"
    matvec_kernel: object = False
    linearize_kernel: object = False
    matvec_bf16: bool = False
    packed_gathers: bool = False


def n_cam_params(config: BAConfig) -> int:
    """Per-camera parameter-block width: pose(6) + focal(2) [+ k1,k2]
    [+ cx,cy].  Column order: so3 | t | fx fy | dist | pp."""
    return 8 + 2 * bool(config.optimize_dist) + 2 * bool(config.optimize_pp)


class BAState(NamedTuple):
    rmats: torch.Tensor  # (C,3,3)
    tvecs: torch.Tensor  # (C,3)
    fx_fy: torch.Tensor  # (C,2)
    points3d: torch.Tensor  # (P,3)
    loss: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    iter_num: int
    accepted: torch.Tensor
    grad_norm: torch.Tensor
    converged: torch.Tensor
    cg_iters: int  # last inner-CG iteration count
    gain: torch.Tensor


def reprojection_rmse(
    problem: BAProblem, cameras: CameraParams, points3d: torch.Tensor
) -> torch.Tensor:
    """Unwhitened pixel-space RMSE over real observations."""
    blocks = gather_obs_blocks(
        cameras.rmats, cameras.tvecs, cameras.fx_fy, cameras.cx_cy_skew,
        cameras.dist, points3d, problem.cam_idx, problem.pt_idx, problem.uv,
        problem.mask, 1.0, RobustLoss.TRIVIAL,
    )
    n = torch.clamp(torch.sum(problem.mask), min=1.0)
    return torch.sqrt(torch.sum(blocks.residual**2) / (2.0 * n))
