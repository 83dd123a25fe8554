"""GTSAM factor-graph BA baseline adapter (gated: gtsam optional).

Counterpart of ``tpu3drecon/benchmark/adapters/gtsam_adapter.py`` and of
the reference's GTSAM adapter (reference:
src/benchmark/gtsam_benchmark/benchmark_bundle_adjustment.py:38-181): a
``NonlinearFactorGraph`` of GeneralSFMFactorCal3_S2 per observation with
priors on the first camera and first landmark, solved by
LevenbergMarquardtOptimizer, its optimized values parsed back (reading from
the OPTIMIZED values, not from ``initial_estimate`` as the reference's
lines 123 and 152 did, SURVEY.md C22).  gtsam is imported inside the
adapters; without it they raise ``BaselineUnavailable``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from tpu3drecon_torch.benchmark.adapters.colmap_adapter import BaselineUnavailable
from tpu3drecon_torch.benchmark.harness import (
    BundleAdjustmentBenchmark,
    BundleAdjustmentBenchmarkResults,
    SinglePoseBenchmark,
    SinglePoseBenchmarkResults,
)


def _require_gtsam():
    try:
        import gtsam  # noqa: F401

        return gtsam
    except ImportError as e:
        raise BaselineUnavailable(
            "gtsam is not installed; GTSAM BA baseline unavailable"
        ) from e


class GtsamBundleAdjustmentBenchmark(BundleAdjustmentBenchmark):
    FRAMEWORK = "gtsam"
    NAME = "GtsamBundleAdjustmentBenchmark"

    def benchmark(
        self,
        camera_limit: Optional[int] = None,
        points_limit: Optional[int] = None,
        **_,
    ) -> None:
        gtsam = _require_gtsam()
        from gtsam import symbol_shorthand

        from tpu3drecon_torch.dataset.camera_pose import (
            CameraPose,
            CoordinateSystem,
            TransformationDirection,
        )
        from tpu3drecon_torch.dataset.model import Camera, Point3D, params_to_intrinsics

        C = symbol_shorthand.C
        L = symbol_shorthand.L

        ds = self.dataset
        if camera_limit is not None:
            ds = ds.make_reduced_dataset(camera_limit, points_limit or 10**9)
        self.dataset = ds

        graph = gtsam.NonlinearFactorGraph()
        initial = gtsam.Values()
        noise = gtsam.noiseModel.Isotropic.Sigma(2, 1.0)

        point_ids = sorted(p.identifier for p in ds.points3D)
        id_to_row = {pid: r for r, pid in enumerate(point_ids)}

        for i, entry in enumerate(ds.datasetEntries):
            cam = entry.camera
            intr = cam.camera_intrinsics
            c2w = cam.camera_pose.in_direction(TransformationDirection.C2W)
            pose = gtsam.Pose3(
                gtsam.Rot3(c2w.rotation), gtsam.Point3(*c2w.translation)
            )
            cal = gtsam.Cal3_S2(
                intr.focal_x, intr.focal_y, intr.skew_factor or 0.0,
                intr.center_x, intr.center_y,
            )
            initial.insert(C(i), gtsam.PinholeCameraCal3_S2(pose, cal))
            for p in entry.points_with_3d():
                row = id_to_row.get(p.point3D_identifier)
                if row is not None:
                    graph.add(
                        gtsam.GeneralSFMFactorCal3_S2(
                            gtsam.Point2(p.x, p.y), noise, C(i), L(row)
                        )
                    )

        for pid in point_ids:
            initial.insert(L(id_to_row[pid]), gtsam.Point3(*ds.points3D_mapped[pid].xyz))

        # Gauge priors: first camera + first landmark (reference
        # gtsam_benchmark lines 66-98).
        graph.add(
            gtsam.PriorFactorPinholeCameraCal3_S2(
                C(0), initial.atPinholeCameraCal3_S2(C(0)),
                gtsam.noiseModel.Isotropic.Sigma(11, 1e-4),
            )
        )
        graph.add(
            gtsam.PriorFactorPoint3(
                L(0), initial.atPoint3(L(0)),
                gtsam.noiseModel.Isotropic.Sigma(3, 1e-4),
            )
        )

        params = gtsam.LevenbergMarquardtParams()
        params.setMaxIterations(100)
        optimizer = gtsam.LevenbergMarquardtOptimizer(graph, initial, params)
        t0 = time.perf_counter()
        values = optimizer.optimize()
        self.time = time.perf_counter() - t0
        self.iterations = [int(optimizer.iterations())]

        camera_mapping = {}
        for i, entry in enumerate(ds.datasetEntries):
            opt_cam = values.atPinholeCameraCal3_S2(C(i))  # optimized, not initial
            pose3 = opt_cam.pose()
            cal = opt_cam.calibration()
            pose = CameraPose(
                np.asarray(pose3.rotation().matrix()),
                np.asarray(pose3.translation()),
                identifier=entry.camera.camera_pose.identifier,
                coordinate_system=CoordinateSystem.COLMAP,
                direction=TransformationDirection.C2W,
            )
            camera_mapping[i] = Camera(
                camera_pose=pose,
                camera_intrinsics=params_to_intrinsics(
                    cal.fx(), cal.fy(), cal.px(), cal.py(), cal.skew() or None
                ),
                width=entry.camera.width,
                height=entry.camera.height,
            )
        point_mapping = {
            pid: Point3D(
                pid, *np.asarray(values.atPoint3(L(id_to_row[pid]))),
                dict(ds.points3D_mapped[pid].metadata),
            )
            for pid in point_ids
        }
        self.results = BundleAdjustmentBenchmarkResults(
            camera_mapping=camera_mapping, point_mapping=point_mapping
        )


class GtsamSinglePoseBenchmark(SinglePoseBenchmark):
    """Per-camera pose refinement with fixed landmarks (factor-graph
    resectioning).

    The reference's GTSAM single-pose benchmark is an empty stub
    (reference src/benchmark/gtsam_benchmark/benchmark_single_pose.py:66-67);
    this is a working implementation: one NonlinearFactorGraph per camera
    with projection factors on a single Pose3 variable, landmarks pinned by
    tight priors (GTSAM's projection factors require landmark variables).
    Degrades to BaselineUnavailable without gtsam.
    """

    FRAMEWORK = "gtsam"
    NAME = "GtsamSinglePoseBenchmark"

    def benchmark(self, **_) -> None:
        gtsam = _require_gtsam()
        from gtsam import symbol_shorthand

        from tpu3drecon_torch.dataset.camera_pose import (
            CameraPose,
            CoordinateSystem,
            TransformationDirection,
        )
        from tpu3drecon_torch.dataset.model import Camera

        X = symbol_shorthand.X
        L = symbol_shorthand.L
        pix_noise = gtsam.noiseModel.Isotropic.Sigma(2, 1.0)
        pin_noise = gtsam.noiseModel.Isotropic.Sigma(3, 1e-6)

        camera_mapping = {}
        single_times = []
        t_total = time.perf_counter()
        for i, entry in enumerate(self.dataset.datasetEntries):
            cam = entry.camera
            intr = cam.camera_intrinsics
            cal = gtsam.Cal3_S2(
                intr.focal_x, intr.focal_y, intr.skew_factor or 0.0,
                intr.center_x, intr.center_y,
            )
            c2w = cam.camera_pose.in_direction(TransformationDirection.C2W)
            graph = gtsam.NonlinearFactorGraph()
            initial = gtsam.Values()
            initial.insert(
                X(0),
                gtsam.Pose3(gtsam.Rot3(c2w.rotation), gtsam.Point3(*c2w.translation)),
            )
            p2d, p3d = entry.map2d_3d(
                self.dataset.points3D_mapped, zipped=False, np=True
            )
            for j, (uv, xyz) in enumerate(zip(np.asarray(p2d), np.asarray(p3d))):
                graph.add(
                    gtsam.GenericProjectionFactorCal3_S2(
                        gtsam.Point2(*uv), pix_noise, X(0), L(j), cal
                    )
                )
                initial.insert(L(j), gtsam.Point3(*xyz))
                graph.add(gtsam.PriorFactorPoint3(L(j), gtsam.Point3(*xyz), pin_noise))

            params = gtsam.LevenbergMarquardtParams()
            params.setMaxIterations(100)
            t0 = time.perf_counter()
            values = gtsam.LevenbergMarquardtOptimizer(graph, initial, params).optimize()
            single_times.append(time.perf_counter() - t0)

            pose3 = values.atPose3(X(0))
            pose = CameraPose(
                np.asarray(pose3.rotation().matrix()),
                np.asarray(pose3.translation()),
                identifier=cam.camera_pose.identifier,
                coordinate_system=CoordinateSystem.COLMAP,
                direction=TransformationDirection.C2W,
            )
            camera_mapping[i] = Camera(
                camera_pose=pose,
                camera_intrinsics=intr,
                width=cam.width,
                height=cam.height,
            )
        self.time = time.perf_counter() - t_total
        self.single_times = single_times
        self.results = SinglePoseBenchmarkResults(camera_mapping=camera_mapping)
