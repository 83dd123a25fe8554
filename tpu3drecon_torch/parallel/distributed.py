"""Process-group start-up, the whole-group mesh, and a local launcher.

Counterpart of ``tpu3drecon/parallel/distributed.py``.  JAX's multi-host
``jax.distributed.initialize`` becomes ``torch.distributed``'s
``init_process_group``: ``initialize_distributed`` reads the standard
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` variables
(or takes an ``init_method`` such as ``file://...`` or
``tcp://host:port``) and is a no-op where nothing is set.  The group is
NCCL unless the caller names another backend: gloo serves the CPU.

``launch`` starts ``world_size`` local ranks (spawned processes, a
``file://`` rendezvous, a timeout on every collective), runs one
importable function in each with the whole-group mesh, and returns each
rank's result as numpy arrays.  A rank that raises, or a group that does
not finish by its deadline, fails the call: the ranks still alive are
killed, so a rank that took another branch than its peers fails its
caller instead of hanging it.  It serves the tests and ``chip_smoke.py``;
a multi-process solve of one's own starts its ranks with
``torch.distributed``'s tools (``torchrun``) and calls
``initialize_distributed`` in each.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from tpu3drecon_torch.parallel.mesh import OBS_AXIS, Mesh

DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
    store=None,
) -> bool:
    """Start the default process group if a multi-process run is set up:
    ``init_method`` or a ``torch.distributed`` ``store`` given, or
    ``MASTER_ADDR`` in the environment (with ``WORLD_SIZE`` and ``RANK``, as
    ``torchrun`` sets them).  Returns whether a group is running; with
    nothing set and no group it starts none (one process, no mesh
    needed)."""
    if dist.is_initialized():
        return True
    if init_method is None and store is None and "MASTER_ADDR" not in os.environ:
        return False
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    where = dict(store=store) if store is not None else dict(init_method=init_method or "env://")
    dist.init_process_group(backend=backend, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **where)
    return True


def global_obs_mesh(axis_name: str = OBS_AXIS, device=None) -> Mesh:
    """The 1-D mesh over every rank of the default group."""
    return Mesh(device=device, axis_name=axis_name)


def process_local_obs_slice(n_obs: int) -> slice:
    """The observation rows this process should load (each rank reads only
    its slice of a huge BAL problem); the last rank takes the remainder.
    One process (no group) loads everything."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = n_obs // n_proc
    start = pid * per
    end = n_obs if pid == n_proc - 1 else start + per
    return slice(start, end)


def to_numpy(x):
    """``x`` with every tensor replaced by a numpy copy (tuples, named
    tuples, lists, dicts and dataclasses walked)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def call_each(calls, mesh: Mesh) -> list:
    """Run each ``(target, args, kwargs)`` of ``calls`` in turn with
    ``mesh`` (``target`` a dotted function name, called as
    ``target(*args, mesh=mesh, **kwargs)``) and return their results: one
    ``launch`` of it runs several solves in one group of ranks."""
    out = []
    for target, args, kwargs in calls:
        module, name = target.rsplit(".", 1)
        out.append(getattr(importlib.import_module(module), name)(*args, mesh=mesh, **kwargs))
    return out


def _rank_main(target: str, rank: int, world_size: int, init_method: str, backend: str,
               device: str, timeout_s: float, args: tuple, kwargs: dict, results) -> None:
    """One rank: join the group, run ``target(*args, mesh=mesh, **kwargs)``
    and put ``(rank, ok, numpy result or traceback)`` on ``results``."""
    try:
        torch.set_num_threads(1)
        if device.startswith("cuda"):
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = f"cuda:{torch.cuda.current_device()}"
        initialize_distributed(init_method, world_size, rank, backend, timeout_s)
        module, name = target.rsplit(".", 1)
        fn = getattr(importlib.import_module(module), name)
        out = fn(*args, mesh=global_obs_mesh(device=device), **kwargs)
        results.put((rank, True, to_numpy(out)))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(target: str, world_size: int, args: tuple = (), kwargs: Optional[dict] = None,
           backend: str = "nccl", device: str = "cuda", timeout_s: float = 120.0,
           deadline_s: Optional[float] = None, rendezvous_dir: Optional[str] = None) -> list:
    """Run ``target`` (``"package.module.function"``, a function of a module
    that imports neither JAX nor a test file: each rank imports it anew) in
    ``world_size`` spawned ranks as ``target(*args, mesh=mesh, **kwargs)``
    and return the results in rank order, tensors as numpy arrays.  The
    ranks run on the card over NCCL unless the caller names another
    backend and device (``backend="gloo", device="cpu"`` for the CPU).

    Every collective times out after ``timeout_s``; the whole run must end
    by ``deadline_s`` (default ``timeout_s + 60``), else the live ranks are
    killed and ``RuntimeError`` is raised, as it is for a rank that
    raised."""
    deadline = time.monotonic() + (timeout_s + 60.0 if deadline_s is None else deadline_s)
    own_dir = rendezvous_dir is None
    rdv = tempfile.mkdtemp(prefix="rendezvous_") if own_dir else rendezvous_dir
    init_method = "file://" + os.path.join(rdv, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(
            target, r, world_size, init_method, backend, device, timeout_s, tuple(args),
            dict(kwargs or {}), results), daemon=True)
        for r in range(world_size)
    ]
    try:
        for p in procs:
            p.start()
        got: dict = {}
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"{target}: {world_size - len(got)} of {world_size} "
                                   "ranks did not finish by the deadline")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead and results.empty():
                    raise RuntimeError(f"{target}: ranks {dead} died without a result")
                continue
            if not ok:  # the peers may wait on this rank: stop them all
                raise RuntimeError(f"{target} failed on rank {rank}:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        if own_dir:
            shutil.rmtree(rdv, ignore_errors=True)
