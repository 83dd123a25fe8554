"""Batched single-camera pose (PnP) refinement.

Counterpart of ``tpu3drecon/solvers/pose_refine.py``: per-camera
parameters ``[rodrigues(3), t(3), fx, fy]`` with frozen ``cx, cy, skew``
and ``dist``, masked width-normalized reprojection residuals, all cameras
refined at once by the batched LM (``solvers/lm_core.py``).

Two residual forms:
  - ``per_axis`` (default): 2 residuals per observation with robust IRLS
    whitening, the weights frozen per linearization (``.detach()``, JAX's
    ``stop_gradient``);
  - ``scalar`` (reference parity): one residual per point,
    sum_axis loss(obs, proj) * mask / width^2.

The JAX refiner's jit cache and its ``aot=True`` executable cache have no
counterpart: PyTorch runs eagerly, and the AOT cache works around a TPU
plugin's compile cache (ROADMAP A.8).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.losses import RobustLoss, cauchy_loss, l2_loss, robust_weight
from tpu3drecon_torch.geometry.projection import project_points
from tpu3drecon_torch.geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
from tpu3drecon_torch.problems.packing import CameraParams, PoseProblem
from tpu3drecon_torch.solvers.lm_core import LMConfig, LMState, lm_solve_batched


def pose_params_pack(cameras: CameraParams) -> torch.Tensor:
    """(B, 8) LM parameter vectors [rodrigues | t | fx, fy] from cameras."""
    rvecs = matrix_to_rodrigues(cameras.rmats)
    return torch.cat([rvecs, cameras.tvecs, cameras.fx_fy], dim=1)


def pose_params_unpack(
    params: torch.Tensor, cx_cy_skew: torch.Tensor, dist: torch.Tensor
) -> CameraParams:
    """(B, 8) parameter vectors -> CameraParams (frozen cx/cy/skew/dist)."""
    return CameraParams(
        rmats=rodrigues_to_matrix(params[:, :3]),
        tvecs=params[:, 3:6],
        fx_fy=params[:, 6:8],
        cx_cy_skew=cx_cy_skew,
        dist=dist,
    )


def pose_residuals_per_axis(
    params: torch.Tensor,
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    cx_cy_skew: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    avg_cam_width: torch.Tensor,
    loss: RobustLoss = RobustLoss.CAUCHY,
) -> torch.Tensor:
    """Whitened per-axis residuals of one camera, flattened to (2N,):
    r_i = (proj - obs) * sqrt(w(s_i)) * mask / width, the IRLS weights
    frozen per linearization."""
    rmat = rodrigues_to_matrix(params[:3])
    proj = project_points(rmat, params[3:6], params[6:8], cx_cy_skew, dist, points3d)
    r = proj - points2d
    s = torch.sum(r * r, dim=1)
    w = robust_weight(loss, s.detach())
    return (r * (torch.sqrt(w) * mask / avg_cam_width)[:, None]).reshape(-1)


def pose_residuals_scalar(
    params: torch.Tensor,
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    cx_cy_skew: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    avg_cam_width_sqr: torch.Tensor,
    loss: RobustLoss = RobustLoss.CAUCHY,
) -> torch.Tensor:
    """Reference-parity scalar residuals (N,) of one camera: per point, the
    sum over both axes of loss(obs, proj), masked, over the squared width."""
    rmat = rodrigues_to_matrix(params[:3])
    proj = project_points(rmat, params[3:6], params[6:8], cx_cy_skew, dist, points3d)
    if loss == RobustLoss.CAUCHY:
        res = cauchy_loss(points2d, proj)
    else:
        res = l2_loss(points2d, proj)
    return res.sum(dim=1) * mask / avg_cam_width_sqr


class PoseRefiner:
    """Batched PnP refiner with the JAX refiner's interface; refines on
    ``device`` (default: the CUDA card)."""

    def __init__(
        self,
        avg_cam_width: float,
        loss: RobustLoss = RobustLoss.CAUCHY,
        residual_form: str = "per_axis",
        config: LMConfig = LMConfig(maxiter=100, gtol=1e-7),
        aot: bool = False,
        device=None,
    ):
        if aot:
            raise NotImplementedError(
                "aot=True (the persistent executable cache) is TPU-specific and "
                "not ported (ROADMAP A.8)"
            )
        if residual_form == "per_axis":
            self.norm = float(avg_cam_width)
            self.residual_fn = functools.partial(pose_residuals_per_axis, loss=loss)
        elif residual_form == "scalar":
            self.norm = float(avg_cam_width**2)
            self.residual_fn = functools.partial(pose_residuals_scalar, loss=loss)
        else:
            raise ValueError(f"unknown residual_form {residual_form!r}")
        self.avg_cam_width = avg_cam_width
        self.loss = loss
        self.residual_form = residual_form
        self.config = config
        self.device = resolve_device(device)

    def optimize(
        self, params0, points3d, points2d, cx_cy_skew, mask, dist=None
    ) -> Tuple[torch.Tensor, LMState]:
        """Refine the (B, 8) ``params0`` against each camera's points;
        ``dist`` defaults to pinhole."""
        dev = self.device
        params0 = params0.to(dev)
        if dist is None:
            dist = torch.zeros((params0.shape[0], 2), dtype=params0.dtype, device=dev)
        norm = torch.full((params0.shape[0],), self.norm, dtype=params0.dtype, device=dev)
        return lm_solve_batched(
            self.residual_fn, params0, points3d.to(dev), points2d.to(dev),
            cx_cy_skew.to(dev), dist.to(dev), mask.to(dev), norm, config=self.config,
        )

    def compile(self, points_num: int, batch_size: int = 8, dtype=torch.float32):
        """Zeros-shaped warm-up run (the JAX refiner's compile)."""
        dev = self.device
        row = torch.tensor([[1e-3, 0, 0, 0, 0, 5.0, 1.0, 1.0]], dtype=dtype, device=dev)
        self.optimize(
            row.repeat(batch_size, 1),
            torch.zeros((batch_size, points_num, 3), dtype=dtype, device=dev),
            torch.zeros((batch_size, points_num, 2), dtype=dtype, device=dev),
            torch.zeros((batch_size, 3), dtype=dtype, device=dev),
            torch.zeros((batch_size, points_num), dtype=dtype, device=dev),
        )


def refine_poses(
    problem: PoseProblem,
    loss: RobustLoss = RobustLoss.CAUCHY,
    config: LMConfig = LMConfig(maxiter=100, gtol=1e-7),
    residual_form: str = "per_axis",
    aot: bool = False,
    device=None,
) -> Tuple[CameraParams, LMState]:
    """One-call refinement of every camera of a PoseProblem on ``device``
    (default: the CUDA card)."""
    refiner = PoseRefiner(
        float(problem.avg_cam_width), loss, residual_form, config, aot=aot,
        device=device,
    )
    problem = problem.to(refiner.device)
    params0 = pose_params_pack(problem.cameras)
    params, state = refiner.optimize(
        params0,
        problem.points3d,
        problem.points2d,
        problem.cameras.cx_cy_skew,
        problem.mask,
        dist=problem.cameras.dist,
    )
    return (
        pose_params_unpack(params, problem.cameras.cx_cy_skew, problem.cameras.dist),
        state,
    )
