"""Per-camera intrinsics + radial-distortion refinement (poses fixed).

Counterpart of ``tpu3drecon/solvers/intrinsics_refine.py``: with camera
poses and 3D points held fixed, each camera's ``[fx, fy, k1, k2]`` is
refined against its observations, all cameras at once on the batched LM
(``solvers/lm_core.py``), as pose refinement does
(``solvers/pose_refine.py``).  ``ba_with_intrinsics_calibration``
alternates the flat ``ba_solve`` with this refinement.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.losses import RobustLoss, robust_weight
from tpu3drecon_torch.geometry.projection import project_points
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams, PoseProblem, bucket_size
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, ba_solve
from tpu3drecon_torch.solvers.lm_core import LMConfig, LMState, lm_solve_batched


def intrinsics_residuals(
    params: torch.Tensor,  # (4,) [fx, fy, k1, k2]
    rmat: torch.Tensor,
    tvec: torch.Tensor,
    cx_cy_skew: torch.Tensor,
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    mask: torch.Tensor,
    avg_cam_width: torch.Tensor,
    loss: RobustLoss = RobustLoss.TRIVIAL,
) -> torch.Tensor:
    """Whitened per-axis residuals (2N,) of one camera as a function of its
    intrinsics only; the IRLS weights frozen per linearization."""
    proj = project_points(rmat, tvec, params[:2], cx_cy_skew, params[2:4], points3d)
    r = proj - points2d
    s = torch.sum(r * r, dim=1)
    w = robust_weight(loss, s.detach())
    return (r * (torch.sqrt(w) * mask / avg_cam_width)[:, None]).reshape(-1)


def _focal_only(params, *args, loss):
    """``intrinsics_residuals`` with (k1, k2) frozen: their Jacobian
    columns are zero (JAX's ``stop_gradient``)."""
    frozen = torch.cat([params[:2], params[2:4].detach()])
    return intrinsics_residuals(frozen, *args, loss=loss)


def refine_intrinsics(
    problem: PoseProblem,
    loss: RobustLoss = RobustLoss.TRIVIAL,
    config: LMConfig = LMConfig(maxiter=60, gtol=1e-10),
    refine_distortion: bool = True,
    device=None,
) -> Tuple[CameraParams, LMState]:
    """Refine [fx, fy, k1, k2] per camera on ``device`` (default: the CUDA
    card); returns updated CameraParams.  ``refine_distortion=False``
    freezes (k1, k2) and refines focal lengths only."""
    problem = problem.to(resolve_device(device))
    cams = problem.cameras
    params0 = torch.cat([cams.fx_fy, cams.dist], dim=1)  # (B, 4)
    norm = problem.avg_cam_width.to(params0.dtype).expand(params0.shape[0])
    fn = intrinsics_residuals if refine_distortion else _focal_only
    params, state = lm_solve_batched(
        functools.partial(fn, loss=loss), params0, cams.rmats, cams.tvecs,
        cams.cx_cy_skew, problem.points3d, problem.points2d, problem.mask, norm,
        config=config,
    )
    new_cams = CameraParams(
        rmats=cams.rmats,
        tvecs=cams.tvecs,
        fx_fy=params[:, :2],
        cx_cy_skew=cams.cx_cy_skew,
        dist=params[:, 2:4] if refine_distortion else cams.dist,
    )
    return new_cams, state


def pose_problem_from_ba(
    problem: BAProblem, cameras: CameraParams = None, points3d: torch.Tensor = None,
    pad_multiple: int = 256,
) -> PoseProblem:
    """Repack a (possibly solved) BAProblem as a PoseProblem: per-camera
    observation lists against fixed 3D points, packed on the host and put
    back on the problem's device."""
    cams = cameras if cameras is not None else problem.cameras
    pts = (points3d if points3d is not None else problem.points3d).detach().cpu().numpy()
    cam_idx = problem.cam_idx.cpu().numpy()
    pt_idx = problem.pt_idx.cpu().numpy()
    uv = problem.uv.detach().cpu().numpy()
    mask = problem.mask.cpu().numpy() > 0
    cam_idx, pt_idx, uv = cam_idx[mask], pt_idx[mask], uv[mask]

    B = cams.n_cameras
    counts = np.bincount(cam_idx, minlength=B)
    n = bucket_size(max(int(counts.max()), 1), pad_multiple)
    p3 = np.zeros((B, n, 3))
    p2 = np.zeros((B, n, 2))
    m = np.zeros((B, n))
    order = np.argsort(cam_idx, kind="stable")
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    local = np.arange(len(order)) - starts[cam_idx[order]]
    p3[cam_idx[order], local] = pts[pt_idx[order]]
    p2[cam_idx[order], local] = uv[order]
    m[cam_idx[order], local] = 1.0

    def t(x):
        return torch.as_tensor(x, dtype=problem.uv.dtype, device=problem.uv.device)

    return PoseProblem(
        cameras=cams, points3d=t(p3), points2d=t(p2), mask=t(m),
        avg_cam_width=problem.avg_cam_width,
    )


def ba_with_intrinsics_calibration(
    problem: BAProblem,
    ba_config=None,
    lm_config: LMConfig = LMConfig(maxiter=60, gtol=1e-12),
    rounds: int = 2,
    refine_distortion: bool = True,
    device=None,
):
    """Joint structure + intrinsics + distortion estimation by alternation
    on ``device`` (default: the CUDA card): ``rounds`` of a full flat BA
    (distortion frozen) followed by per-camera intrinsics + distortion
    refinement (poses and points fixed), then a last BA.  Returns
    (cameras, points3d, last BA state).  Converges linearly in ``rounds``
    (see the JAX function's docstring for measured rates)."""
    dev = resolve_device(device)
    problem = problem.to(dev)
    ba_config = ba_config or BAConfig(maxiter=30, gtol=1e-12, cg_maxiter=30, cg_rtol=1e-8)
    cams = problem.cameras
    pts = problem.points3d
    for _ in range(rounds):
        problem = dataclasses.replace(problem, cameras=cams, points3d=pts)
        cams, pts, state = ba_solve(problem, ba_config, device=dev)
        pose_prob = pose_problem_from_ba(problem, cams, pts)
        cams, _ = refine_intrinsics(
            pose_prob, config=lm_config, refine_distortion=refine_distortion, device=dev
        )
    problem = dataclasses.replace(problem, cameras=cams, points3d=pts)
    cams, pts, state = ba_solve(problem, ba_config, device=dev)
    return cams, pts, state
