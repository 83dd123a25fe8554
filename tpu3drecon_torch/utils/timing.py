"""Timing helpers: the first-call / steady-state split, device sync, and
the program's spans and counters.

Counterpart of ``tpu3drecon/utils/timing.py``.  ``device_sync`` waits for
the card (``torch.cuda.synchronize`` on the devices of the CUDA tensors in
its argument) and is a no-op for CPU tensors, which PyTorch computes
before it returns.

Spans and counters.  ``span(name)`` brackets a phase of the program and
``count(name, n)`` adds to a counter; ``host_wait(site)`` is both, named
``sync.<site>``, around a place where the host waits on the card.  They
record only while a ``torch.profiler`` session records or a
``recording()`` block is open; otherwise a span costs one check of the
profiler and of a module flag and does nothing else (in particular it
enters no ``torch.profiler.record_function``, which costs ~15 us even
with no profiler running).  While a profiler records, a span also enters
``record_function(name)``, so it sits in the Chrome trace beside the
kernels it launched.  Recorded spans and counters add up in one in-memory
tally per process, on the host clock: ``tally()`` returns it as plain
dicts, ``reset()`` empties it.  Nothing here reads a value back from the
card, so recording adds no synchronization and changes no result.  The
names the solvers use are listed in PERF.md.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

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


# The tally: span name -> [calls, seconds, self seconds, first parent],
# counter name -> total; the stack of open spans; open recording() blocks.
_SPANS: dict = {}
_COUNTS: dict = {}
_STACK: list = []
_RECORDING = 0
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    """One recorded span: host-clock seconds into the tally, and a
    ``record_function`` where a profiler records."""

    __slots__ = ("name", "_rf", "_child", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._child = 0.0
        _STACK.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _STACK.pop()
        parent = _STACK[-1] if _STACK else None
        if parent is not None:
            parent._child += dt
        entry = _SPANS.get(self.name)
        if entry is None:
            entry = _SPANS[self.name] = [0, 0.0, 0.0, parent.name if parent else None]
        entry[0] += 1
        entry[1] += dt
        entry[2] += dt - self._child
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager bracketing one phase named ``name``; it records
    only while a profiler records or ``recording()`` is open."""
    if not (_RECORDING or _profiler_enabled()):
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number, never a tensor) to the counter ``name``,
    under the same conditions as ``span``."""
    if _RECORDING or _profiler_enabled():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def host_wait(site: str):
    """``span`` and ``count`` of ``sync.<site>``: wrap the one statement at
    which the host waits on the card (a read-back, a copy from pageable
    host memory, a library call that synchronizes)."""
    if not (_RECORDING or _profiler_enabled()):
        return _OFF
    name = "sync." + site
    _COUNTS[name] = _COUNTS.get(name, 0) + 1
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record spans and counters into the tally inside the block, with no
    profiler (blocks nest)."""
    global _RECORDING
    _RECORDING += 1
    try:
        yield
    finally:
        _RECORDING -= 1


def tally() -> dict:
    """A snapshot of the tally: ``{"spans": {name: {"calls", "s", "self_s",
    "parent"}}, "counts": {name: n}}``; ``s`` is inclusive host seconds,
    ``self_s`` less the time of child spans, ``parent`` the enclosing
    span's name at the first call (None at the top)."""
    spans = {name: dict(calls=c, s=s, self_s=self_s, parent=parent)
             for name, (c, s, self_s, parent) in _SPANS.items()}
    return dict(spans=spans, counts=dict(_COUNTS))


def reset() -> None:
    """Empty the tally."""
    _SPANS.clear()
    _COUNTS.clear()
