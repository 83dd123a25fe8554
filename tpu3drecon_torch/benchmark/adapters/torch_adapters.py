"""The port's solver adapters for the benchmark harness.

Counterpart of ``tpu3drecon/benchmark/adapters/tpu_adapters.py`` and of
the reference's jaxopt adapters (reference:
src/benchmark/jaxopt_benchmark/benchmark_pose_optimization.py,
benchmark_bundle_adjustment.py, helpers.py): run the port's packed solvers
on a Dataset -- batched PnP through ``refine_poses``, bundle adjustment
through ``make_ba_solver`` (the flat implicit-Schur engine) -- keep the
first-call / second-call timing split, guard against NaN output
(helpers.py:24-27,82-85), and re-materialize results into Camera/Point3D
objects through explicit host numpy (so pickles never hold device tensors).
Each adapter runs on ``device`` (default: the CUDA card; raises without
one).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from tpu3drecon_torch.benchmark.harness import (
    BundleAdjustmentBenchmark,
    BundleAdjustmentBenchmarkResults,
    SinglePoseBenchmark,
    SinglePoseBenchmarkResults,
)
from tpu3drecon_torch.dataset.camera_pose import (
    CameraPose,
    CoordinateSystem,
    TransformationDirection,
)
from tpu3drecon_torch.dataset.model import Camera, Point3D, params_to_intrinsics
from tpu3drecon_torch.dataset.scene import Dataset
from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.problems.from_dataset import (
    ba_problem_from_dataset,
    pose_problem_from_dataset,
)
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, make_ba_solver
from tpu3drecon_torch.solvers.lm_core import LMConfig
from tpu3drecon_torch.solvers.pose_refine import refine_poses


class NanGuardError(RuntimeError):
    """Solver diverged to NaN (reference helpers.py:24-27 raised ValueError)."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _check_finite(name: str, *arrays) -> None:
    for a in arrays:
        if not np.all(np.isfinite(np.asarray(a))):
            raise NanGuardError(f"{name}: non-finite values in solver output")


def _sync(device: torch.device, loss: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    loss.sum().item()


def _cameras_to_objects(
    cameras: CameraParams, dataset: Dataset
) -> Dict[int, Camera]:
    """Packed camera params -> {entry index: Camera} (reference
    helpers.py:19-53 / 56-129 parsing, vectorized, in host float64)."""
    rmats = _host(cameras.rmats)
    tvecs = _host(cameras.tvecs)
    fx_fy = _host(cameras.fx_fy)
    ccs = _host(cameras.cx_cy_skew)
    _check_finite("cameras", rmats, tvecs, fx_fy)
    out: Dict[int, Camera] = {}
    for i, entry in enumerate(dataset.datasetEntries):
        pose = CameraPose(
            rmats[i],
            tvecs[i],
            identifier=entry.camera.camera_pose.identifier,
            coordinate_system=CoordinateSystem.COLMAP,
            direction=TransformationDirection.W2C,
        )
        out[i] = Camera(
            camera_pose=pose,
            camera_intrinsics=params_to_intrinsics(
                fx_fy[i, 0], fx_fy[i, 1], ccs[i, 0], ccs[i, 1], ccs[i, 2] or None
            ),
            width=entry.camera.width,
            height=entry.camera.height,
        )
    return out


class TorchSinglePoseBenchmark(SinglePoseBenchmark):
    """Batched PnP refinement on the card (analog of
    JaxoptSinglePoseBenchmarkBatched, benchmark_pose_optimization.py:14)."""

    FRAMEWORK = "tpu3drecon_torch"
    NAME = "TorchSinglePoseBenchmark"

    def __init__(self, dataset: Dataset, loss: RobustLoss = RobustLoss.CAUCHY,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dataset)
        self.loss = loss
        self.dtype = dtype
        self.compile_time: Optional[float] = None

    def benchmark(self, maxiter: int = 100, gtol: float = 1e-7, device=None, **_) -> None:
        device = resolve_device(device)
        problem, meta = pose_problem_from_dataset(self.dataset, dtype=self.dtype,
                                                  device=device)
        config = LMConfig(maxiter=maxiter, gtol=gtol)

        t0 = time.perf_counter()
        cams, state = refine_poses(problem, loss=self.loss, config=config, device=device)
        _sync(device, state.loss)
        first = time.perf_counter() - t0

        t0 = time.perf_counter()
        cams, state = refine_poses(problem, loss=self.loss, config=config, device=device)
        _sync(device, state.loss)
        run = time.perf_counter() - t0

        self.compile_time = first - run
        self.time = run
        self.iterations = [int(i) for i in state.iter_num.cpu().tolist()]
        self.single_times = [run / max(problem.batch, 1)] * problem.batch
        self.results = SinglePoseBenchmarkResults(
            camera_mapping=_cameras_to_objects(cams, self.dataset)
        )


class TorchBundleAdjustmentBenchmark(BundleAdjustmentBenchmark):
    """Implicit-Schur BA on the card (analog of
    JaxoptBundleAdjustmentBenchmark, benchmark_bundle_adjustment.py:21 --
    without its 15-cam/400-pt cap)."""

    FRAMEWORK = "tpu3drecon_torch"
    NAME = "TorchBundleAdjustmentBenchmark"

    def __init__(self, dataset: Dataset, dtype: torch.dtype = torch.float32):
        super().__init__(dataset)
        self.dtype = dtype
        self.compile_time: Optional[float] = None

    def benchmark(
        self,
        camera_limit: Optional[int] = None,
        points_limit: Optional[int] = None,
        config: Optional[BAConfig] = None,
        device=None,
        **_,
    ) -> None:
        device = resolve_device(device)
        ds = self.dataset
        if camera_limit is not None:
            ds = ds.make_reduced_dataset(camera_limit, points_limit or 10**9)
        problem, meta = ba_problem_from_dataset(ds, dtype=self.dtype, device=device)
        config = config or BAConfig(
            maxiter=100, gtol=1e-6 if self.dtype == torch.float32 else 1e-10)
        solver = make_ba_solver(config)

        t0 = time.perf_counter()
        cams, pts, state = solver(problem, device=device)
        _sync(device, state.loss)
        first = time.perf_counter() - t0

        t0 = time.perf_counter()
        cams, pts, state = solver(problem, device=device)
        _sync(device, state.loss)
        run = time.perf_counter() - t0

        self.compile_time = first - run
        self.time = run
        self.iterations = [int(state.iter_num)]

        pts_np = _host(pts)
        _check_finite("points", pts_np)
        point_mapping = {
            int(pid): Point3D(
                int(pid), float(p[0]), float(p[1]), float(p[2]),
                dict(ds.points3D_mapped[int(pid)].metadata),
            )
            for pid, p in zip(meta.point_ids, pts_np)
        }
        self.results = BundleAdjustmentBenchmarkResults(
            camera_mapping=_cameras_to_objects(cams, ds),
            point_mapping=point_mapping,
        )
        # The reduced dataset is what results re-materialize against.
        self.dataset = ds
