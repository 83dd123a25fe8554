"""Benchmark framework: ABCs, timing, process isolation, persistence.

Counterpart of ``tpu3drecon/benchmark/harness.py`` and of the reference
benchmark layer (reference: src/benchmark/benchmark.py): an abstract
``Benchmark`` carrying (dataset, results, time), ``SinglePoseBenchmark`` /
``BundleAdjustmentBenchmark`` bases with typed result containers, optional
subprocess isolation with queue hand-off (benchmark.py:112-168 -- kept
because external native baselines can leak memory or crash; polled with a
timeout because ``join`` can deadlock on large pickles), pickle persistence
with the timestamped/latest layout (benchmark_impl_shared.py:12-33), result
re-materialization into a Dataset, reprojection-error extraction, and
COLMAP-format export of results.

Results hold host numpy and ``Camera`` / ``Point3D`` objects, never device
tensors, so a saved benchmark loads in any process: one without a card,
and one without JAX.
"""

from __future__ import annotations

import abc
import copy
import multiprocessing
import os
import pickle
import shutil
import time as _time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np

from tpu3drecon_torch.dataset.model import Camera, Point3D
from tpu3drecon_torch.dataset.scene import Dataset


@dataclass
class SinglePoseBenchmarkResults:
    """Per-camera optimized cameras keyed by entry index
    (reference benchmark.py:73-75)."""

    camera_mapping: Dict[int, Camera] = field(default_factory=dict)


@dataclass
class BundleAdjustmentBenchmarkResults:
    """Optimized cameras + points (reference benchmark.py:237-240)."""

    camera_mapping: Dict[int, Camera] = field(default_factory=dict)
    point_mapping: Dict[int, Point3D] = field(default_factory=dict)


def _subprocess_worker(payload: bytes, queue, device: Optional[str]) -> None:
    """Spawn-target for subprocess_benchmark (top-level for picklability).
    ``device`` is the child's explicit device; the adapters refuse a CUDA
    device that the child does not have."""
    bench, kwargs = pickle.loads(payload)
    if device is not None:
        kwargs = {**kwargs, "device": device}
    bench.benchmark(**kwargs)
    queue.put(
        {
            "results": bench.results,
            "time": bench.time,
            "single_times": bench.single_times,
            "iterations": bench.iterations,
        }
    )


class Benchmark(abc.ABC):
    """Base benchmark: owns a dataset, produces results + timings."""

    FRAMEWORK: str = "abstract"
    NAME: str = "Benchmark"

    def __init__(self, dataset: Dataset):
        self.dataset = dataset
        self.results: Any = None
        self.time: Optional[float] = None
        self.single_times: Optional[List[float]] = None
        self.iterations: Optional[List[int]] = None
        self.time_creation = datetime.now()

    @abc.abstractmethod
    def benchmark(self, *args, **kwargs) -> None:
        """Run the benchmark, filling results/time/iterations."""

    # ---- process isolation ----------------------------------------------

    def subprocess_benchmark(
        self,
        timeout_s: float = 3600.0,
        device: Optional[str] = None,
        **kwargs,
    ) -> None:
        """Run ``benchmark`` in a child process, shipping results back via a
        Queue polled with a timeout (reference benchmark.py:112-168 used
        fork; this spawns, because a fork after CUDA has started leaves the
        child a broken context).  ``device`` (e.g. "cpu" or "cuda") is
        passed to the child's ``benchmark``; None leaves the adapter's
        default, the card.  A child asked for "cuda" where there is none
        fails; it does not drop to the CPU."""
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()

        proc = ctx.Process(
            target=_subprocess_worker,
            args=(pickle.dumps((self, kwargs)), queue, device),
        )
        proc.start()
        deadline = _time.monotonic() + timeout_s
        payload = None
        while _time.monotonic() < deadline:
            try:
                payload = queue.get(timeout=5.0)
                break
            except Exception:
                if not proc.is_alive():
                    break
        proc.join(timeout=10.0)
        if proc.exitcode not in (0, None):
            raise RuntimeError(
                f"{self.NAME}: benchmark child exited with code {proc.exitcode}"
            )
        if payload is None:
            proc.terminate()
            raise TimeoutError(f"{self.NAME}: no results within {timeout_s}s")
        self.results = payload["results"]
        self.time = payload["time"]
        self.single_times = payload["single_times"]
        self.iterations = payload["iterations"]

    # ---- persistence -----------------------------------------------------

    def save(self, directory: str) -> str:
        """Pickle this benchmark (reference benchmark.py:46-60).  Unpicklable
        solver handles are stripped (benchmark_impl_shared.py:22-26)."""
        os.makedirs(directory, exist_ok=True)
        state = {
            k: v
            for k, v in self.__dict__.items()
            if k not in ("optimizer", "solver", "_solver")
        }
        clone = copy.copy(self)
        clone.__dict__ = state
        path = os.path.join(directory, f"{self.NAME}.pickle")
        with open(path, "wb") as f:
            pickle.dump(clone, f)
        return path

    @classmethod
    def load(cls, directory: str, name: Optional[str] = None) -> "Benchmark":
        path = os.path.join(directory, f"{name or cls.NAME}.pickle")
        with open(path, "rb") as f:
            return pickle.load(f)


class SinglePoseBenchmark(Benchmark):
    """Base for per-camera pose-refinement benchmarks
    (reference benchmark.py:78-234)."""

    NAME = "SinglePoseBenchmark"

    def shallow_results_dataset(self) -> Dataset:
        """Dataset copy with optimized cameras swapped in
        (reference benchmark.py:170-185)."""
        assert isinstance(self.results, SinglePoseBenchmarkResults)
        ds = copy.deepcopy(self.dataset)
        for index, camera in self.results.camera_mapping.items():
            ds.datasetEntries[index].camera = camera
        return ds

    def reprojection_errors(self, loss_function=None) -> Dict[int, np.ndarray]:
        """(reference benchmark.py:220-234)."""
        fn = loss_function or (lambda x: x)
        return self.shallow_results_dataset().compute_reprojection_errors_alt(fn)

    def export_results_in_colmap_format(self, output_path: str, binary: bool = True) -> None:
        from tpu3drecon_torch.dataset.loader import export_in_colmap_format

        export_in_colmap_format(self.shallow_results_dataset(), output_path, binary)


class BundleAdjustmentBenchmark(Benchmark):
    """Base for full-BA benchmarks (reference benchmark.py:243-504)."""

    NAME = "BundleAdjustmentBenchmark"

    def shallow_results_dataset(self) -> Dataset:
        """Dataset copy with optimized cameras AND points swapped in
        (reference benchmark.py:374-474); entries whose camera wasn't
        optimized keep their input camera, 2D points whose 3D point fell out
        of the reduced problem lose the association."""
        assert isinstance(self.results, BundleAdjustmentBenchmarkResults)
        ds = copy.deepcopy(self.dataset)
        surviving_ids = set(self.results.point_mapping.keys())
        ds.points3D = list(self.results.point_mapping.values())
        ds.refresh_mapping()
        for index, camera in self.results.camera_mapping.items():
            ds.datasetEntries[index].camera = camera
        for entry in ds.datasetEntries:
            for p in entry.points2D:
                if p.point3D_identifier is not None and p.point3D_identifier not in surviving_ids:
                    p.point3D_identifier = None
            entry.refresh_mapping()
        return ds

    def reprojection_errors(self, loss_function=None) -> Dict[int, np.ndarray]:
        fn = loss_function or (lambda x: x)
        return self.shallow_results_dataset().compute_reprojection_errors_alt(fn)

    def export_results_in_colmap_format(self, output_path: str, binary: bool = True) -> None:
        from tpu3drecon_torch.dataset.loader import export_in_colmap_format

        export_in_colmap_format(self.shallow_results_dataset(), output_path, binary)


def save_benchmarks(benchmarks: List[Benchmark], results_root: str) -> str:
    """Timestamped dir + refreshed ``latest/`` copy
    (reference benchmark_impl_shared.py:12-33)."""
    stamp = datetime.now().isoformat(timespec="seconds").replace(":", "-")
    out_dir = os.path.join(results_root, stamp)
    os.makedirs(out_dir, exist_ok=True)
    for b in benchmarks:
        b.save(out_dir)
    latest = os.path.join(results_root, "latest")
    if os.path.isdir(latest):
        shutil.rmtree(latest)
    shutil.copytree(out_dir, latest)
    return out_dir


def load_benchmarks(directory: str) -> List[Benchmark]:
    out = []
    for fname in sorted(os.listdir(directory)):
        if fname.endswith(".pickle"):
            with open(os.path.join(directory, fname), "rb") as f:
                out.append(pickle.load(f))
    return out
