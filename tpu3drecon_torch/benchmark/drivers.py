"""Benchmark drivers: the public entry points of the harness.

Counterpart of ``tpu3drecon/benchmark/drivers.py`` and of the reference
drivers (reference: src/benchmark_implementation/
benchmark_impl_single_pose.py:24-80, benchmark_impl_bundle_adjustment.py:
27-109) with the same semantics: ``benchmark_single_pose(dataset, **kw)``
and ``benchmark_bundle_adjustment(dataset)`` run the port's solver (on
``device``, default the CUDA card), then the scipy baseline, then the gated
COLMAP and GTSAM baselines (each skipped with a printed line where its tool
is missing) on the same (reduced) dataset, compute cross-framework mean
reprojection errors and persist pickles (timestamp + latest/).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tpu3drecon_torch.benchmark.adapters.colmap_adapter import (
    BaselineUnavailable,
    ColmapBundleAdjustmentBenchmark,
    ColmapSinglePoseBenchmark,
)
from tpu3drecon_torch.benchmark.adapters.gtsam_adapter import GtsamBundleAdjustmentBenchmark
from tpu3drecon_torch.benchmark.adapters.scipy_adapter import (
    ScipyBundleAdjustmentBenchmark,
    ScipySinglePoseBenchmark,
)
from tpu3drecon_torch.benchmark.adapters.torch_adapters import (
    TorchBundleAdjustmentBenchmark,
    TorchSinglePoseBenchmark,
)
from tpu3drecon_torch.benchmark.harness import Benchmark, save_benchmarks
from tpu3drecon_torch.config import (
    BENCHMARK_BUNDLE_ADJUSTMENT_RESULTS_PATH,
    BENCHMARK_SINGLE_POSE_RESULTS_PATH,
)
from tpu3drecon_torch.dataset.scene import Dataset


def mean_reprojection_errors(benchmark: Benchmark) -> Dict[int, float]:
    """Mean per-camera reprojection error of a finished benchmark
    (reference benchmark_impl_bundle_adjustment.py:40-67)."""
    errors = benchmark.reprojection_errors()
    return {k: float(np.mean(v)) if len(v) else float("nan") for k, v in errors.items()}


def benchmark_single_pose(
    dataset: Dataset,
    with_scipy_baseline: bool = True,
    with_colmap_baseline: bool = True,
    save: bool = True,
    results_root: Optional[str] = None,
    device=None,
    **solver_kwargs,
) -> List[Benchmark]:
    """Run single-pose refinement across frameworks (reference
    benchmark_impl_single_pose.py:24-52 semantics); the port's solver runs
    on ``device`` (default: the CUDA card)."""
    benchmarks: List[Benchmark] = []

    ours = TorchSinglePoseBenchmark(dataset)
    ours.benchmark(device=device, **solver_kwargs)
    benchmarks.append(ours)

    if with_scipy_baseline:
        sp = ScipySinglePoseBenchmark(dataset)
        sp.benchmark(**solver_kwargs)
        benchmarks.append(sp)

    if with_colmap_baseline:
        try:
            cm = ColmapSinglePoseBenchmark(dataset)
            cm.benchmark()
            benchmarks.append(cm)
        except BaselineUnavailable as e:
            print(f"[benchmark_single_pose] skipping COLMAP baseline: {e}")

    if save:
        save_benchmarks(
            benchmarks, results_root or BENCHMARK_SINGLE_POSE_RESULTS_PATH
        )
    return benchmarks


def benchmark_bundle_adjustment(
    dataset: Dataset,
    camera_limit: Optional[int] = None,
    points_limit: Optional[int] = None,
    with_scipy_baseline: bool = True,
    with_colmap_baseline: bool = True,
    with_gtsam_baseline: bool = True,
    save: bool = True,
    results_root: Optional[str] = None,
    device=None,
) -> List[Benchmark]:
    """Run BA across frameworks on the same reduced dataset and report
    cross-framework mean reprojection errors (reference
    benchmark_impl_bundle_adjustment.py:27-87 semantics -- note its driver
    capped the problem at 15 cams / 400 points because of the dense-J wall;
    the default here is the full dataset).  The port's solver runs on
    ``device`` (default: the CUDA card)."""
    benchmarks: List[Benchmark] = []

    ours = TorchBundleAdjustmentBenchmark(dataset)
    ours.benchmark(camera_limit=camera_limit, points_limit=points_limit, device=device)
    benchmarks.append(ours)

    if with_scipy_baseline:
        sp = ScipyBundleAdjustmentBenchmark(dataset)
        sp.benchmark(camera_limit=camera_limit, points_limit=points_limit)
        benchmarks.append(sp)

    if with_colmap_baseline:
        try:
            cm = ColmapBundleAdjustmentBenchmark(dataset)
            cm.benchmark(camera_limit=camera_limit, points_limit=points_limit)
            benchmarks.append(cm)
        except BaselineUnavailable as e:
            print(f"[benchmark_bundle_adjustment] skipping COLMAP baseline: {e}")

    if with_gtsam_baseline:
        try:
            gt = GtsamBundleAdjustmentBenchmark(dataset)
            gt.benchmark(camera_limit=camera_limit, points_limit=points_limit)
            benchmarks.append(gt)
        except BaselineUnavailable as e:
            print(f"[benchmark_bundle_adjustment] skipping GTSAM baseline: {e}")

    print("Cross-framework mean reprojection errors (per camera):")
    for b in benchmarks:
        means = mean_reprojection_errors(b)
        overall = float(np.nanmean(list(means.values()))) if means else float("nan")
        print(f"  {b.FRAMEWORK:16s} {b.NAME:34s} mean={overall:.6f} time={b.time:.3f}s")

    if save:
        save_benchmarks(
            benchmarks, results_root or BENCHMARK_BUNDLE_ADJUSTMENT_RESULTS_PATH
        )
    return benchmarks


if __name__ == "__main__":
    from tpu3drecon_torch.benchmark.datasets import get_dataset

    ds = get_dataset("synthetic_small_noised")
    benchmark_bundle_adjustment(ds, save=False)
