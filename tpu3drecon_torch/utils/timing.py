"""Timing helpers: the first-call / steady-state split, device sync,
stopwatches and profiler traces.

Counterpart of ``tpu3drecon/utils/timing.py``.  ``device_sync`` waits for
the card (``torch.cuda.synchronize`` on the devices of the CUDA tensors in
its argument) and is a no-op for CPU tensors, which PyTorch computes
before it returns.  ``profiler_trace`` records a ``torch.profiler`` trace
(CPU and, where a card is present, CUDA activity) as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)


def device_sync(out: Any) -> None:
    """Wait until ``out`` (a tensor or a tree of them) is computed: a
    synchronize of every CUDA device it lives on; nothing on the CPU."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class CompileRunTimer:
    """Measures the first call (kernel build, caches, warm-up) apart from
    steady-state calls."""

    compile_time: Optional[float] = None
    run_times: List[float] = field(default_factory=list)

    def measure(self, fn: Callable, *args, repeats: int = 1, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        device_sync(out)
        first = time.perf_counter() - t0
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            device_sync(out)
            self.run_times.append(time.perf_counter() - t0)
        run = min(self.run_times) if self.run_times else 0.0
        self.compile_time = max(first - run, 0.0)
        return out

    @property
    def best_run(self) -> float:
        return min(self.run_times) if self.run_times else float("nan")


@contextlib.contextmanager
def stopwatch(label: str, sink: Optional[Dict[str, float]] = None):
    """Host-clock bracket; the seconds are added to ``sink[label]`` or
    printed."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        if sink is not None:
            sink[label] = sink.get(label, 0.0) + elapsed
        else:
            print(f"[stopwatch] {label}: {elapsed:.4f}s")


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = True):
    """Record a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
