"""Drop-in compatibility surface for mokrueger/jaxopt-3D-reconstruction users.

Counterpart of ``tpu3drecon/compat.py``: the port's components under the
reference project's public names and module-level contracts (SURVEY.md
§1-2), so a user of the reference can switch imports wholesale:

    from tpu3drecon_torch.compat import (
        JaxPoseOptimizer, JaxBundleAdjustment, JaxLossFunction,
        Dataset, Camera, CameraPose, CameraSet,
        load_colmap_dataset, export_in_colmap_format,
    )

The names (``JaxPoseOptimizer``, ``JaxBundleAdjustment``,
``JaxLossFunction``, ``to_gpu``) are the reference API's; they say nothing
of what runs underneath, which is PyTorch.  ``JaxPoseOptimizer`` /
``JaxBundleAdjustment`` keep the reference classes' constructor / compile /
optimize / prepare_params contracts (reference:
src/reconstruction/bundle_adjustment/pose_optimization.py:55-99,
bundle_adjustment.py:77-129) over the port's dense LM and implicit-Schur
engines, on ``device`` (default: the CUDA card; raises without one).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

# ---- dataset & IO surface (reference src/dataset) -------------------------

from tpu3drecon_torch.dataset import (  # noqa: F401
    Camera,
    CameraIntrinsics,
    CameraPose,
    CameraSet,
    CoordinateSystem,
    Dataset,
    DatasetEntry,
    ImageMetadata,
    Point2D,
    Point3D,
    PoseFormat,
    TransformationDirection,
    export_in_colmap_format,
    load_colmap_cameras,
    load_colmap_dataset,
)
from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.losses import RobustLoss, cauchy_loss, l2_loss  # noqa: F401
from tpu3drecon_torch.geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, ba_solve
from tpu3drecon_torch.solvers.lm_core import LMConfig
from tpu3drecon_torch.solvers.pose_refine import PoseRefiner


class JaxLossFunction(enum.Enum):
    """Reference loss.py:17-19 enum, mapped onto RobustLoss."""

    L2 = RobustLoss.TRIVIAL
    CAUCHY = RobustLoss.CAUCHY


class LossFunction(enum.Enum):
    """Reference loss_functions.py:14-17 (CPU evaluation losses)."""

    CAUCHY_LOSS = staticmethod(lambda x: np.log1p(x))
    TRIVIAL_LOSS = staticmethod(lambda x: x)


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor (numpy's dtype for arrays and lists: float64 for
    floats), on ``device`` if given."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def to_gpu(data, device=None):
    """Reference utils.py:15-18: ``data`` on ``device`` (default: the CUDA
    card; raises without one); a list or tuple is stacked."""
    device = resolve_device(device)
    if isinstance(data, (list, tuple)):
        return torch.stack([_tensor(i, device) for i in data])
    return _tensor(data, device)


def rot_mat_from_vec(rodrigues_vec):
    """Reference utils.py:21-28 (safe at theta -> 0)."""
    return rodrigues_to_matrix(_tensor(rodrigues_vec))


def pose_mat_to_vec(pose):
    """Reference utils.py:31-44: 3x4 or 4x4 pose -> [rodrigues|t]."""
    pose = _tensor(pose)
    return torch.cat([matrix_to_rodrigues(pose[:3, :3]), pose[:3, 3]])


def parse_intrinsics(params, cx_cy_skew):
    """Reference utils.py:47-57."""
    from tpu3drecon_torch.geometry.projection import make_intrinsics_matrix

    return make_intrinsics_matrix(_tensor(params), _tensor(cx_cy_skew))


def parse_cam_pose(cam_vec):
    """Reference utils.py:60-64: [rodrigues|t] -> [R|t]."""
    cam_vec = _tensor(cam_vec)
    return torch.cat([rodrigues_to_matrix(cam_vec[:3]), cam_vec[3:6, None]], dim=1)


def _pose_params(poses0, intrinsics0, device):
    """(rodrigues, t, fx_fy, cx_cy_skew) of [3x4 poses], [5-vector intrinsics]."""
    poses0 = _tensor(poses0, device)
    intrinsics0 = _tensor(intrinsics0, device)
    rvecs = matrix_to_rodrigues(poses0[:, :3, :3])
    return rvecs, poses0[:, :3, 3], intrinsics0[..., :2], intrinsics0[..., 2:]


class JaxPoseOptimizer:
    """Reference JaxPoseOptimizer (pose_optimization.py:55-99) contract.

    Same constructor and method shapes; underneath, the port's batched LM
    with the scalar reference-parity residual form, so convergence follows
    the original's cauchy-of-squares objective.
    """

    def __init__(self, avg_cam_width: float,
                 loss_fn: JaxLossFunction = JaxLossFunction.CAUCHY, device=None):
        self._refiner = PoseRefiner(
            avg_cam_width=float(avg_cam_width),
            loss=loss_fn.value,
            residual_form="scalar",
            config=LMConfig(maxiter=100, gtol=1e-7),
            device=device,
        )
        self.device = self._refiner.device

    def prepare_params(self, poses0, intrinsics0):
        """[3x4 pose matrices], [5-vector intrinsics] -> (opt_params, cx_cy_skew)
        (reference pose_optimization.py:73-84)."""
        rvecs, tvecs, fx_fy, cx_cy_skew = _pose_params(poses0, intrinsics0, self.device)
        return torch.cat([rvecs, tvecs, fx_fy], dim=1), cx_cy_skew

    def optimize(self, opt_params, points, observations, cx_cy_skew, mask):
        return self._refiner.optimize(
            _tensor(opt_params), _tensor(points), _tensor(observations),
            _tensor(cx_cy_skew), _tensor(mask),
        )

    def compile(self, points_num: int, batch_size: int = 8):
        self._refiner.compile(points_num, batch_size)


class JaxBundleAdjustment:
    """Reference JaxBundleAdjustment (bundle_adjustment.py:77-129) contract,
    backed by the implicit-Schur engine (no dense-J size wall)."""

    def __init__(self, cam_num: int, avg_cam_width: float, device=None):
        self.cam_num = cam_num
        self.avg_cam_width = float(avg_cam_width)
        self.config = BAConfig(maxiter=100, gtol=1e-6)
        self.device = resolve_device(device)

    def prepare_params(self, poses0, intrinsics0, points0):
        """Flat [6N | 2N | 3P] parameter vector (reference
        bundle_adjustment.py:93-102)."""
        rvecs, tvecs, fx_fy, cx_cy_skew = _pose_params(poses0, intrinsics0, self.device)
        cam_params = torch.cat([rvecs, tvecs], dim=1).reshape(-1)
        points0 = _tensor(points0, self.device)
        return torch.cat([cam_params, fx_fy.reshape(-1), points0.reshape(-1)]), cx_cy_skew

    def optimize(self, opt_params, points_2d_all, p3d_indices_all, cx_cy_skew, masks_all):
        """Solve the packed problem given the reference's (cam, obs)-grid
        arrays; returns (opt_params_out, state)."""
        dev = self.device
        opt_params = _tensor(opt_params, dev)
        points_2d_all = _tensor(points_2d_all, dev)
        pt_idx = _tensor(p3d_indices_all, dev).to(torch.int32).reshape(-1)
        cx_cy_skew = _tensor(cx_cy_skew, dev)
        mask = _tensor(masks_all, dev).reshape(-1)

        n = self.cam_num
        cam_block = opt_params[: n * 6].reshape(n, 6)
        fx_fy = opt_params[n * 6 : n * 8].reshape(n, 2)
        points3d = opt_params[n * 8 :].reshape(-1, 3)
        obs = points_2d_all.reshape(-1, 2)
        cam_idx = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=dev), points_2d_all.shape[1])
        problem = BAProblem(
            cameras=CameraParams(
                rmats=rodrigues_to_matrix(cam_block[:, :3]),
                tvecs=cam_block[:, 3:6],
                fx_fy=fx_fy,
                cx_cy_skew=cx_cy_skew,
                dist=torch.zeros((n, 2), dtype=fx_fy.dtype, device=dev),  # pinhole
            ),
            points3d=points3d,
            cam_idx=cam_idx,
            pt_idx=pt_idx,
            uv=obs,
            mask=mask.to(obs.dtype),
            avg_cam_width=torch.tensor(self.avg_cam_width, dtype=obs.dtype, device=dev),
        )
        cams, pts, state = ba_solve(problem, self.config, device=dev)
        rvecs_out = matrix_to_rodrigues(cams.rmats)
        out = torch.cat([
            torch.cat([rvecs_out, cams.tvecs], dim=1).reshape(-1),
            cams.fx_fy.reshape(-1),
            pts.reshape(-1),
        ])
        return out, state

    def compile(self, points_num: int, indices_num: int):
        """Zeros-shaped warm-up (reference bundle_adjustment.py:122-129)."""
        n = self.cam_num
        self.optimize(
            np.concatenate([
                np.tile([1e-3, 0, 0, 0, 0, 5.0], n),
                np.ones(n * 2),
                np.ones(points_num * 3),
            ]),
            np.zeros((n, indices_num, 2)),
            np.zeros((n, indices_num), dtype=np.int32),
            np.zeros((n, 3)),
            np.zeros((n, indices_num)),
        )


def get_reprojection_residuals_cpu(pose, points, observations, intrinsics, mask):
    """Reference utils.py:6-12: numpy CPU residual oracle (with its
    hardcoded /250000 = 500^2 width normalizer)."""
    ke = np.einsum("ij,jk->ik", np.asarray(intrinsics), np.asarray(pose)[:3, :])
    x = np.einsum("ij,hj->hi", ke, np.asarray(points))
    x = x[..., :2] / x[..., 2:3]
    res = ((np.asarray(observations) - x) ** 2).sum(axis=1) / 250000
    return np.where(np.asarray(mask), res, np.zeros_like(res))


from tpu3drecon_torch.utils.multiprocess import ListMultiProcessor  # noqa: E402,F401
from tpu3drecon_torch.benchmark.adapters.output_grabber import OutputGrabber  # noqa: E402,F401
