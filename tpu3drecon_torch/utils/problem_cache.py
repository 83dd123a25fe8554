"""Disk cache for expensive host-side problem builds.

Counterpart of ``tpu3drecon/utils/problem_cache.py``: the BAL-scale
packing (synthetic scene, flat packing, ``wtt_from_flat``) is seconds of
host work that every process would pay again.  This module memoizes the
built problem on disk, every tensor stored as a numpy array, so that

- no device buffer is pickled, and a cache hit needs no device: the
  caller's ``device`` places the loaded tensors, and
- the value on a miss is the one a later hit returns, bit for bit (both
  come from the stored arrays).

The JAX package's cache pickles JAX classes.  Were the port to unpickle
one, it would import ``tpu3drecon`` (an error where JAX is absent) or
load the wrong classes, so the two caches never share an entry: the
port's default directory is ``<repo>/.problem_cache_torch``, its keys are
hashed with their own prefix, its files end in ``.torch.pickle`` (JAX's
in ``.pkl``), and its unpickler refuses any class of ``tpu3drecon`` or
``jax``.  The environment variables are JAX's:
``TPU3DRECON_PROBLEM_CACHE_DIR`` relocates the cache,
``TPU3DRECON_PROBLEM_CACHE_DISABLE=1`` bypasses it,
``TPU3DRECON_PROBLEM_CACHE_VERBOSE=1`` prints hits and misses.

Usage::

    wtt = cached_problem("balseq_1712x584_..._v1", build_fn, device=dev)

Keys are caller-chosen strings that name every build parameter; bump the
version suffix when the builder's semantics change.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device

_DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".problem_cache_torch"
_KEY_PREFIX = "tpu3drecon_torch/"
_SUFFIX = ".torch.pickle"
COUNTS = {"hit": 0, "miss": 0}  # lookups served from disk / built


@dataclasses.dataclass(frozen=True)
class _Stored:
    """One tensor as a host array and the name of its torch dtype
    (bfloat16, which numpy lacks, as its int16 bits)."""

    array: np.ndarray
    dtype: str


def _cache_dir(cache_dir=None) -> Path:
    return Path(
        cache_dir
        or os.environ.get("TPU3DRECON_PROBLEM_CACHE_DIR")
        or _DEFAULT_DIR
    )


def _disabled() -> bool:
    return os.environ.get("TPU3DRECON_PROBLEM_CACHE_DISABLE", "") not in ("", "0")


def _map(tree: Any, fn: Callable) -> Any:
    """``tree`` with ``fn`` applied to every tensor and stored array, through
    dataclasses, named tuples, tuples, lists and dicts."""
    if isinstance(tree, (torch.Tensor, _Stored)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def _store(t: torch.Tensor) -> _Stored:
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return _Stored(t.numpy().copy(), name)


def _load(device) -> Callable:
    def load(s: _Stored) -> torch.Tensor:
        t = torch.from_numpy(s.array)
        if s.dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    return load


class _PortUnpickler(pickle.Unpickler):
    """Refuses the JAX package's classes and JAX's own."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in ("tpu3drecon", "jax", "jaxlib"):
            raise pickle.UnpicklingError(f"refusing {module}.{name}: not the port's")
        return super().find_class(module, name)


def entry_path(key: str, cache_dir=None) -> Path:
    """The file that holds ``key``'s entry."""
    h = hashlib.sha256((_KEY_PREFIX + key).encode()).hexdigest()[:32]
    return _cache_dir(cache_dir) / f"{h}{_SUFFIX}"


def cached_problem(
    key: str,
    builder: Callable[[], Any],
    cache_dir=None,
    verbose: Optional[bool] = None,
    device=None,
) -> Any:
    """``builder()``, memoized on disk under ``key``, its tensors placed on
    ``device`` (default: the CUDA card; raises without one).

    Misses write atomically (temporary file and rename), so processes may
    share a cache directory.  A stale or unreadable entry is dropped and
    rebuilt.
    """
    device = resolve_device(device)
    if verbose is None:
        verbose = os.environ.get("TPU3DRECON_PROBLEM_CACHE_VERBOSE", "") not in ("", "0")
    if _disabled():
        return _map(builder(), lambda t: t.to(device))
    path = entry_path(key, cache_dir)
    if path.exists():
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                stored = _PortUnpickler(f).load()
        except Exception as e:
            if verbose:
                print(f"problem_cache: stale entry {path.name}: {e!r}", flush=True)
            try:
                path.unlink()
            except OSError:
                pass
        else:
            COUNTS["hit"] += 1
            if verbose:
                print(f"problem_cache: HIT {path.name} ({key}) load "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
            return _map(stored, _load(device))
    stored = _map(builder(), _store)
    COUNTS["miss"] += 1
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(stored, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if verbose:
        print(f"problem_cache: MISS -> wrote {path.name} "
              f"({path.stat().st_size / 1e6:.0f} MB) for {key}", flush=True)
    return _map(stored, _load(device))


def clear(cache_dir=None) -> int:
    """Removes the port's entries (never JAX's) and returns their count."""
    d = _cache_dir(cache_dir)
    n = 0
    if d.exists():
        for p in d.glob(f"*{_SUFFIX}"):
            p.unlink()
            n += 1
    return n
