"""COLMAP/Ceres baseline adapters (gated: pycolmap / colmap CLI optional).

Counterpart of ``tpu3drecon/benchmark/adapters/colmap_adapter.py``, with
the reference's external-baseline strategy (reference:
src/benchmark/colmap_benchmark/): single-pose refinement through pycolmap's
``pose_refinement`` binding and full BA through the ``colmap
bundle_adjuster`` CLI round trip with Ceres-flag options and stdout report
parsing (bundle_adjuster.py:25-104).  pycolmap is imported inside the
adapter and the binary is looked up when it runs, so where either is
missing the entry point raises ``BaselineUnavailable`` instead of an import
error; the adapters run for real wherever the tools exist.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpu3drecon_torch.benchmark.harness import (
    BundleAdjustmentBenchmark,
    BundleAdjustmentBenchmarkResults,
    SinglePoseBenchmark,
    SinglePoseBenchmarkResults,
)
from tpu3drecon_torch.dataset.scene import Dataset


class BaselineUnavailable(RuntimeError):
    """The external baseline tool is not installed in this environment."""


def _find_colmap_binary() -> Optional[str]:
    for candidate in (os.environ.get("COLMAP_BIN"), "/usr/local/bin/colmap", "colmap"):
        if candidate and shutil.which(candidate):
            return shutil.which(candidate)
    return None


def _require_pycolmap():
    try:
        import pycolmap  # noqa: F401

        return pycolmap
    except ImportError as e:
        raise BaselineUnavailable(
            "pycolmap is not installed; COLMAP single-pose baseline unavailable"
        ) from e


@dataclass
class BundleAdjustmentOptions:
    """Ceres flags mirrored by the reference (bundle_adjuster.py:25-38)."""

    max_num_iterations: int = 100
    max_linear_solver_iterations: int = 200
    function_tolerance: float = 0.0
    gradient_tolerance: float = 0.0
    parameter_tolerance: float = 0.0
    refine_focal_length: bool = True
    refine_principal_point: bool = False
    refine_extra_params: bool = True
    refine_extrinsics: bool = True

    def to_args(self) -> List[str]:
        def b(x):
            return "1" if x else "0"

        return [
            "--BundleAdjustment.max_num_iterations", str(self.max_num_iterations),
            "--BundleAdjustment.max_linear_solver_iterations", str(self.max_linear_solver_iterations),
            "--BundleAdjustment.function_tolerance", str(self.function_tolerance),
            "--BundleAdjustment.gradient_tolerance", str(self.gradient_tolerance),
            "--BundleAdjustment.parameter_tolerance", str(self.parameter_tolerance),
            "--BundleAdjustment.refine_focal_length", b(self.refine_focal_length),
            "--BundleAdjustment.refine_principal_point", b(self.refine_principal_point),
            "--BundleAdjustment.refine_extra_params", b(self.refine_extra_params),
            "--BundleAdjustment.refine_extrinsics", b(self.refine_extrinsics),
        ]


@dataclass
class BundleAdjustmentReport:
    """Parsed Ceres self-report (reference bundle_adjuster.py:86-104)."""

    residuals: Optional[int] = None
    parameters: Optional[int] = None
    iterations: Optional[int] = None
    time: Optional[float] = None
    initial_cost: Optional[float] = None
    final_cost: Optional[float] = None
    termination: Optional[str] = None
    raw_stdout: str = field(default="", repr=False)


_REPORT_PATTERNS = {
    "residuals": re.compile(r"Residuals\s*:\s*(\d+)"),
    "parameters": re.compile(r"Parameters\s*:\s*(\d+)"),
    "iterations": re.compile(r"Iterations\s*:\s*(\d+)"),
    "time": re.compile(r"Time\s*:\s*([0-9.eE+-]+)"),
    "initial_cost": re.compile(r"Initial cost\s*:\s*([0-9.eE+-]+)"),
    "final_cost": re.compile(r"Final cost\s*:\s*([0-9.eE+-]+)"),
    "termination": re.compile(r"Termination\s*:\s*(\w+)"),
}


def parse_ba_report(stdout: str) -> BundleAdjustmentReport:
    report = BundleAdjustmentReport(raw_stdout=stdout)
    for name, pattern in _REPORT_PATTERNS.items():
        m = pattern.search(stdout)
        if m:
            value = m.group(1)
            if name in ("residuals", "parameters", "iterations"):
                setattr(report, name, int(value))
            elif name == "termination":
                report.termination = value
            else:
                setattr(report, name, float(value))
    return report


def perform_bundle_adjustment(
    input_path: str,
    output_path: str,
    options: Optional[BundleAdjustmentOptions] = None,
) -> BundleAdjustmentReport:
    """Run ``colmap bundle_adjuster`` on an exported sparse model
    (reference bundle_adjuster.py:41-83)."""
    binary = _find_colmap_binary()
    if binary is None:
        raise BaselineUnavailable(
            "colmap binary not found (set COLMAP_BIN); CLI BA baseline unavailable"
        )
    os.makedirs(output_path, exist_ok=True)
    options = options or BundleAdjustmentOptions()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [binary, "bundle_adjuster", "--input_path", input_path,
         "--output_path", output_path, *options.to_args()],
        capture_output=True,
        text=True,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"colmap bundle_adjuster failed ({proc.returncode}): {proc.stderr[-2000:]}"
        )
    report = parse_ba_report(proc.stdout)
    if report.time is None:
        report.time = wall
    return report


class ColmapSinglePoseBenchmark(SinglePoseBenchmark):
    """pycolmap absolute-pose refinement per camera
    (reference benchmark_single_pose.py:53-234)."""

    FRAMEWORK = "colmap"
    NAME = "ColmapSinglePoseBenchmark"

    def benchmark(self, refine_focal_length: bool = True, **_) -> None:
        pycolmap = _require_pycolmap()
        from tpu3drecon_torch.dataset.camera_pose import (
            CameraPose,
            CoordinateSystem,
            TransformationDirection,
        )
        from tpu3drecon_torch.dataset.model import Camera

        camera_mapping: Dict[int, Camera] = {}
        single_times: List[float] = []
        t_total = time.perf_counter()
        for i, entry in enumerate(self.dataset.datasetEntries):
            p2d, p3d = entry.map2d_3d(self.dataset.points3D_mapped, zipped=False, np=True)
            cam = entry.camera
            intr = cam.camera_intrinsics
            pyc_cam = pycolmap.Camera(
                model="PINHOLE",
                width=cam.width,
                height=cam.height,
                params=[intr.focal_x, intr.focal_y, intr.center_x, intr.center_y],
            )
            w2c = cam.camera_pose.in_direction(TransformationDirection.W2C)
            t0 = time.perf_counter()
            result = pycolmap.pose_refinement(
                w2c.translation,
                w2c.wxyz_quaternion,
                np.asarray(p2d),
                np.asarray(p3d),
                [True] * len(p2d),
                pyc_cam,
            )
            single_times.append(time.perf_counter() - t0)
            pose = CameraPose.from_string_wxyz_quaternion_translation(
                " ".join(map(str, [*result["qvec"], *result["tvec"]])),
                identifier=cam.camera_pose.identifier,
                coordinate_system=CoordinateSystem.COLMAP,
                direction=TransformationDirection.W2C,
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


class ColmapBundleAdjustmentBenchmark(BundleAdjustmentBenchmark):
    """CLI round-trip BA baseline (reference colmap_benchmark/
    benchmark_bundle_adjustment.py:24-91): export reduced dataset, run the
    bundle_adjuster binary, read back the optimized model."""

    FRAMEWORK = "colmap"
    NAME = "ColmapBundleAdjustmentBenchmark"

    def benchmark(
        self,
        camera_limit: Optional[int] = None,
        points_limit: Optional[int] = None,
        work_dir: Optional[str] = None,
        options: Optional[BundleAdjustmentOptions] = None,
        **_,
    ) -> None:
        from tpu3drecon_torch.dataset.loader import (
            export_in_colmap_format,
            load_colmap_dataset,
        )

        ds = self.dataset
        if camera_limit is not None:
            ds = ds.make_reduced_dataset(camera_limit, points_limit or 10**9)
        self.dataset = ds

        if work_dir is None:
            import tempfile

            work_dir = os.path.join(tempfile.gettempdir(), "tpu3drecon_torch_colmap_ba")
        input_dir = os.path.join(work_dir, "benchmark_input")
        output_dir = os.path.join(work_dir, "benchmark_output")
        shutil.rmtree(work_dir, ignore_errors=True)
        os.makedirs(input_dir, exist_ok=True)
        export_in_colmap_format(ds, input_dir, binary=True)

        report = perform_bundle_adjustment(input_dir, output_dir, options)
        self.time = report.time
        self.iterations = [report.iterations or 0]
        self.report = report

        optimized = load_colmap_dataset(output_dir, binary=True)
        camera_mapping = {i: e.camera for i, e in enumerate(optimized.datasetEntries)}
        point_mapping = {p.identifier: p for p in optimized.points3D}
        self.results = BundleAdjustmentBenchmarkResults(
            camera_mapping=camera_mapping, point_mapping=point_mapping
        )
