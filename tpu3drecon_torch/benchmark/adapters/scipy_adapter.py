"""CPU scipy least_squares baseline adapters.

Counterpart of ``tpu3drecon/benchmark/adapters/scipy_adapter.py``: the
reference's scipy CPU prototype (reference: experiments/experiments.ipynb
cells 8-12, the original oracle for its JAX solver) as baseline adapters:
per-camera PnP refinement (LM) and small-scale BA (trf with the sparse
Jacobian pattern) through ``scipy.optimize.least_squares``, on the port's
dataset model.  They are the cross-framework parity check the reference ran
against COLMAP and GTSAM (see colmap_adapter / gtsam_adapter for those
gated baselines).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
from scipy.optimize import least_squares
from scipy.spatial.transform import Rotation

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


def _project(rvec, tvec, fx, fy, cx, cy, skew, xyz):
    rot = Rotation.from_rotvec(rvec).as_matrix()
    xc = xyz @ rot.T + tvec
    x = xc[:, 0] / xc[:, 2]
    y = xc[:, 1] / xc[:, 2]
    return np.stack([fx * x + skew * y + cx, fy * y + cy], axis=1)


class ScipySinglePoseBenchmark(SinglePoseBenchmark):
    """Per-camera CPU LM on [rodrigues|t|fx,fy] — the jaxopt-CPU stand-in."""

    FRAMEWORK = "scipy"
    NAME = "ScipySinglePoseBenchmark"

    def benchmark(self, maxiter: int = 100, **_) -> None:
        camera_mapping = {}
        single_times = []
        iterations = []
        t_total0 = time.perf_counter()
        for i, entry in enumerate(self.dataset.datasetEntries):
            p2d, p3d = entry.map2d_3d(self.dataset.points3D_mapped, zipped=False, np=True)
            p2d = np.asarray(p2d).reshape(-1, 2)
            p3d = np.asarray(p3d).reshape(-1, 3)
            cam = entry.camera
            w2c = cam.camera_pose.in_direction(TransformationDirection.W2C)
            intr = cam.camera_intrinsics
            x0 = np.concatenate(
                [
                    Rotation.from_matrix(w2c.rotation).as_rotvec(),
                    w2c.translation,
                    [intr.focal_x, intr.focal_y],
                ]
            )
            cx, cy, skew = intr.center_x, intr.center_y, intr.skew_factor or 0.0
            width = cam.width

            def residuals(p):
                proj = _project(p[:3], p[3:6], p[6], p[7], cx, cy, skew, p3d)
                return ((proj - p2d) / width).ravel()

            t0 = time.perf_counter()
            sol = least_squares(residuals, x0, method="lm", max_nfev=maxiter * 10)
            single_times.append(time.perf_counter() - t0)
            iterations.append(int(sol.nfev))

            pose = CameraPose(
                Rotation.from_rotvec(sol.x[:3]).as_matrix(),
                sol.x[3:6],
                identifier=cam.camera_pose.identifier,
                coordinate_system=CoordinateSystem.COLMAP,
                direction=TransformationDirection.W2C,
            )
            camera_mapping[i] = Camera(
                camera_pose=pose,
                camera_intrinsics=params_to_intrinsics(
                    sol.x[6], sol.x[7], cx, cy, skew or None
                ),
                width=cam.width,
                height=cam.height,
            )
        self.time = time.perf_counter() - t_total0
        self.single_times = single_times
        self.iterations = iterations
        self.results = SinglePoseBenchmarkResults(camera_mapping=camera_mapping)


class ScipyBundleAdjustmentBenchmark(BundleAdjustmentBenchmark):
    """Small-scale CPU BA with scipy sparse-Jacobian least_squares."""

    FRAMEWORK = "scipy"
    NAME = "ScipyBundleAdjustmentBenchmark"

    def benchmark(
        self,
        camera_limit: Optional[int] = None,
        points_limit: Optional[int] = None,
        maxiter: int = 50,
        **_,
    ) -> None:
        ds = self.dataset
        if camera_limit is not None:
            ds = ds.make_reduced_dataset(camera_limit, points_limit or 10**9)
        self.dataset = ds

        entries = ds.datasetEntries
        n_cams = len(entries)
        point_ids = sorted(p.identifier for p in ds.points3D)
        id_to_row = {pid: r for r, pid in enumerate(point_ids)}
        n_pts = len(point_ids)

        cam_idx, pt_idx, uv = [], [], []
        for i, e in enumerate(entries):
            for p in e.points_with_3d():
                if p.point3D_identifier in id_to_row:
                    cam_idx.append(i)
                    pt_idx.append(id_to_row[p.point3D_identifier])
                    uv.append([p.x, p.y])
        cam_idx = np.array(cam_idx)
        pt_idx = np.array(pt_idx)
        uv = np.array(uv).reshape(-1, 2)

        x0 = []
        fixed = []
        for e in entries:
            w2c = e.camera.camera_pose.in_direction(TransformationDirection.W2C)
            intr = e.camera.camera_intrinsics
            x0.append(
                np.concatenate(
                    [
                        Rotation.from_matrix(w2c.rotation).as_rotvec(),
                        w2c.translation,
                        [intr.focal_x, intr.focal_y],
                    ]
                )
            )
            fixed.append([intr.center_x, intr.center_y, intr.skew_factor or 0.0])
        xyz0 = np.stack([ds.points3D_mapped[pid].xyz for pid in point_ids])
        x0 = np.concatenate([np.concatenate(x0), xyz0.ravel()])
        fixed = np.array(fixed)
        width = float(np.mean([e.camera.width for e in entries]))

        def unpack(x):
            cams = x[: n_cams * 8].reshape(n_cams, 8)
            pts = x[n_cams * 8 :].reshape(n_pts, 3)
            return cams, pts

        def residuals(x):
            cams, pts = unpack(x)
            rot = Rotation.from_rotvec(cams[cam_idx, :3]).as_matrix()
            xc = np.einsum("kij,kj->ki", rot, pts[pt_idx]) + cams[cam_idx, 3:6]
            xn = xc[:, :2] / xc[:, 2:3]
            fx = cams[cam_idx, 6]
            fy = cams[cam_idx, 7]
            cx, cy, skew = (fixed[cam_idx, 0], fixed[cam_idx, 1], fixed[cam_idx, 2])
            proj = np.stack(
                [fx * xn[:, 0] + skew * xn[:, 1] + cx, fy * xn[:, 1] + cy], axis=1
            )
            return ((proj - uv) / width).ravel()

        from scipy.sparse import lil_matrix

        jac_sparsity = lil_matrix((2 * len(cam_idx), len(x0)), dtype=int)
        rows = np.arange(len(cam_idx))
        for r in range(2):
            for c in range(8):
                jac_sparsity[2 * rows + r, cam_idx * 8 + c] = 1
            for c in range(3):
                jac_sparsity[2 * rows + r, n_cams * 8 + pt_idx * 3 + c] = 1

        t0 = time.perf_counter()
        sol = least_squares(
            residuals,
            x0,
            jac_sparsity=jac_sparsity,
            method="trf",
            max_nfev=maxiter,
            x_scale="jac",
        )
        self.time = time.perf_counter() - t0
        self.iterations = [int(sol.nfev)]

        cams, pts = unpack(sol.x)
        camera_mapping = {}
        for i, e in enumerate(entries):
            pose = CameraPose(
                Rotation.from_rotvec(cams[i, :3]).as_matrix(),
                cams[i, 3:6],
                identifier=e.camera.camera_pose.identifier,
                coordinate_system=CoordinateSystem.COLMAP,
                direction=TransformationDirection.W2C,
            )
            camera_mapping[i] = Camera(
                camera_pose=pose,
                camera_intrinsics=params_to_intrinsics(
                    cams[i, 6], cams[i, 7], fixed[i, 0], fixed[i, 1], fixed[i, 2] or None
                ),
                width=e.camera.width,
                height=e.camera.height,
            )
        point_mapping = {
            pid: Point3D(pid, *pts[r], dict(ds.points3D_mapped[pid].metadata))
            for pid, r in id_to_row.items()
        }
        self.results = BundleAdjustmentBenchmarkResults(
            camera_mapping=camera_mapping, point_mapping=point_mapping
        )
