"""Reporting suite: reprojection histograms, runtime and iteration plots.

Counterpart of ``tpu3drecon/benchmark/reporting.py`` and of the
reference's matplotlib observability layer (reference:
src/benchmark_implementation/benchmark_visualization.py:13-354): per-
framework squared-reprojection-error histograms, mean-runtime and
mean-optimization-time bars, time-vs-problem-size scatter with linear fit,
iteration histograms, the aggregate entry points that re-plot from
pickles, and the cost along the path between two poses.  PNGs land under
``evaluation/<dataset>/``.  matplotlib is imported by each plot when it
runs, so this module imports where matplotlib is absent; a plot call there
raises ImportError.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpu3drecon_torch.benchmark.harness import Benchmark
from tpu3drecon_torch.config import EVALUATION_PATH


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError naming matplotlib
    where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the benchmark plots need matplotlib, which is not installed"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _out_dir(dataset_name: Optional[str]) -> str:
    d = os.path.join(EVALUATION_PATH, dataset_name or "unnamed")
    os.makedirs(d, exist_ok=True)
    return d


def _all_errors(benchmark: Benchmark) -> np.ndarray:
    errs = benchmark.reprojection_errors()
    if not errs:
        return np.zeros(0)
    return np.concatenate([np.asarray(v) for v in errs.values() if len(v)])


def reprojection_error_histogram(
    benchmarks: Sequence[Benchmark],
    dataset_name: Optional[str] = None,
    clip_percentile: float = 99.0,
    fname: str = "reprojection_errors.png",
) -> str:
    """Overlaid per-framework histograms (reference
    benchmark_visualization.py:13-114)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 5))
    for b in benchmarks:
        errors = _all_errors(b)
        if not len(errors):
            continue
        clip = np.percentile(errors, clip_percentile)
        ax.hist(
            np.clip(errors, 0, clip),
            bins=100,
            alpha=0.5,
            label=f"{b.FRAMEWORK} (median {np.median(errors):.3f})",
        )
    ax.set_xlabel("squared reprojection error [px^2]")
    ax.set_ylabel("observations")
    ax.set_title(f"Reprojection errors — {dataset_name or ''}")
    ax.legend()
    path = os.path.join(_out_dir(dataset_name), fname)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def runtime_bars(
    benchmarks: Sequence[Benchmark],
    dataset_name: Optional[str] = None,
    fname: str = "runtimes.png",
) -> str:
    """Total + mean-per-camera runtime bars (reference
    benchmark_visualization.py:117-213)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    names = [b.FRAMEWORK for b in benchmarks]
    totals = [b.time or 0.0 for b in benchmarks]
    per_cam = [
        float(np.mean(b.single_times)) if b.single_times else (b.time or 0.0) / max(len(b.dataset.datasetEntries), 1)
        for b in benchmarks
    ]
    ax1.bar(names, totals)
    ax1.set_ylabel("total optimization time [s]")
    ax2.bar(names, per_cam)
    ax2.set_ylabel("mean time per camera [s]")
    for ax in (ax1, ax2):
        ax.tick_params(axis="x", rotation=20)
    fig.suptitle(f"Runtimes — {dataset_name or ''}")
    path = os.path.join(_out_dir(dataset_name), fname)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def time_vs_correspondences(
    benchmark: Benchmark,
    dataset_name: Optional[str] = None,
    fname: str = "time_vs_points.png",
) -> Optional[str]:
    """Per-camera time vs. #correspondences with a linear fit (reference
    benchmark_visualization.py:216-248)."""
    if not benchmark.single_times:
        return None
    counts = [e.num_3d_points for e in benchmark.dataset.datasetEntries]
    times = benchmark.single_times
    n = min(len(counts), len(times))
    counts, times = np.asarray(counts[:n]), np.asarray(times[:n])
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.scatter(counts, times, s=12, label=benchmark.FRAMEWORK)
    if n >= 2 and np.ptp(counts) > 0:
        coef = np.polyfit(counts, times, 1)
        xs = np.linspace(counts.min(), counts.max(), 50)
        ax.plot(xs, np.polyval(coef, xs), "r--", label=f"fit {coef[0]:.2e}*n+{coef[1]:.2e}")
    ax.set_xlabel("# 2D-3D correspondences")
    ax.set_ylabel("optimization time [s]")
    ax.legend()
    path = os.path.join(_out_dir(dataset_name), fname)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def iteration_histogram(
    benchmarks: Sequence[Benchmark],
    dataset_name: Optional[str] = None,
    fname: str = "iterations.png",
) -> str:
    """Iteration-count histograms with medians (reference
    benchmark_visualization.py:251-327)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 5))
    for b in benchmarks:
        if not b.iterations:
            continue
        its = np.asarray(b.iterations)
        ax.hist(its, bins=min(30, max(3, len(set(its.tolist())))), alpha=0.5,
                label=f"{b.FRAMEWORK} (median {np.median(its):.0f})")
    ax.set_xlabel("LM iterations")
    ax.set_ylabel("cameras")
    ax.legend()
    path = os.path.join(_out_dir(dataset_name), fname)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def single_pose_statistics(
    benchmarks: Sequence[Benchmark], dataset_name: Optional[str] = None
) -> List[str]:
    """Full single-pose report (reference benchmark_visualization.py:330-337)."""
    out = [
        reprojection_error_histogram(benchmarks, dataset_name),
        runtime_bars(benchmarks, dataset_name),
        iteration_histogram(benchmarks, dataset_name),
    ]
    for b in benchmarks:
        p = time_vs_correspondences(b, dataset_name, fname=f"time_vs_points_{b.FRAMEWORK}.png")
        if p:
            out.append(p)
    return out


def bundle_adjustment_statistics(
    benchmarks: Sequence[Benchmark], dataset_name: Optional[str] = None
) -> List[str]:
    """Full BA report (reference benchmark_visualization.py:339-343)."""
    return [
        reprojection_error_histogram(benchmarks, dataset_name, fname="ba_reprojection_errors.png"),
        runtime_bars(benchmarks, dataset_name, fname="ba_runtimes.png"),
        iteration_histogram(benchmarks, dataset_name, fname="ba_iterations.png"),
    ]


def replot_latest(results_dir: str, dataset_name: Optional[str] = None) -> List[str]:
    """Regenerate every plot from pickled benchmarks (reference
    benchmark_visualization.py:346-354 / visualization.ipynb)."""
    from tpu3drecon_torch.benchmark.harness import load_benchmarks

    benchmarks = load_benchmarks(os.path.join(results_dir, "latest"))
    sp = [b for b in benchmarks if "SinglePose" in type(b).__name__]
    ba = [b for b in benchmarks if "BundleAdjustment" in type(b).__name__]
    paths = []
    if sp:
        paths += single_pose_statistics(sp, dataset_name)
    if ba:
        paths += bundle_adjustment_statistics(ba, dataset_name)
    return paths


def pose_cost_curve(problem, camera_index: int, params_initial, params_final,
                    n_samples: int = 50):
    """(t, cost) samples along the SE(3)-interpolated path between an initial
    and a final pose ([rodrigues | t | fx, fy] vectors): geodesic
    interpolation of the rotation (via rodrigues of the relative rotation)
    and linear interpolation of translation and focals, each sample the
    whitened PnP cost of camera ``camera_index`` of a PoseProblem, on the
    host."""
    import torch

    from tpu3drecon_torch.geometry.rotations import (
        matrix_to_rodrigues,
        rodrigues_to_matrix,
    )
    from tpu3drecon_torch.solvers.pose_refine import pose_residuals_per_axis

    def rot(v) -> np.ndarray:
        return rodrigues_to_matrix(torch.as_tensor(v, dtype=torch.float64)).numpy()

    def rvec(m) -> np.ndarray:
        return matrix_to_rodrigues(torch.as_tensor(m, dtype=torch.float64)).numpy()

    def host(t):
        return (t[camera_index] if t.dim() else t).detach().cpu()

    p0 = np.asarray(params_initial, dtype=np.float64)
    p1 = np.asarray(params_final, dtype=np.float64)
    r0, r1 = rot(p0[:3]), rot(p1[:3])
    rel = rvec(r0.T @ r1)
    fixed = [host(x) for x in (problem.points3d, problem.points2d,
                               problem.cameras.cx_cy_skew, problem.cameras.dist,
                               problem.mask, problem.avg_cam_width)]
    ts = np.linspace(0.0, 1.0, n_samples)
    costs = []
    for t in ts:
        pt = np.concatenate([rvec(r0 @ rot(t * rel)), (1 - t) * p0[3:] + t * p1[3:]])
        res = pose_residuals_per_axis(
            torch.as_tensor(pt, dtype=problem.points3d.dtype), *fixed)
        costs.append(0.5 * float(np.sum(res.double().numpy() ** 2)))
    return ts, np.asarray(costs)


def plot_pose_cost_curve(
    problem,
    camera_index: int,
    params_initial,
    params_final,
    n_samples: int = 50,
    dataset_name: Optional[str] = None,
    fname: str = "pose_cost_curve.png",
) -> str:
    """The cost along the SE(3)-interpolated path between an initial and
    final pose (``pose_cost_curve``; reference jaxopt_benchmark/
    helpers.py:132-191's plot_costs), plotted on a log axis."""
    ts, costs = pose_cost_curve(problem, camera_index, params_initial, params_final,
                                n_samples)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(ts, costs, marker=".")
    ax.set_xlabel("interpolation t (0 = initial pose, 1 = optimized)")
    ax.set_ylabel("0.5 * ||whitened residual||^2")
    ax.set_yscale("log")
    ax.set_title(f"Cost along SE(3) path — camera {camera_index}")
    path = os.path.join(_out_dir(dataset_name), fname)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
