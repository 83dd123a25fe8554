"""Reduce an exported ``torch.profiler`` Chrome trace to the numbers the
per-layer readers take.

``summarize`` is frozen from ``tpu3drecon_torch/benchmark/profile_solve.py``
(commit a2ddbf06de4361660b45a75548f7333c894b1583): device busy time is the
union of kernel, memcpy and memset intervals; ``cudaLaunchKernel`` and
``cudaStreamSynchronize`` calls are counted on the host; device time is
summed per kernel name.  Added here: the window is the span from the first
to the last event, and the idle gaps of the device are attributed to the
host's top-level operator running in them (``host_between_ops`` where none
runs), the ``breakdown`` the result line carries.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans) -> list[tuple[float, float]]:
    """The union of (start, end) spans, as sorted disjoint spans."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _top_level(spans) -> list[tuple[float, float, str]]:
    """The (start, end, name) spans not inside another one."""
    out: list[tuple[float, float, str]] = []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if out and e <= out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _idle_gaps(busy, host_ops, t0: float, t1: float) -> dict[str, float]:
    """Microseconds of device idle time in [t0, t1] by the top-level host
    operator that overlaps it; the rest as ``host_between_ops``."""
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    by_name: dict[str, float] = {}
    i = 0
    for gs, ge in gaps:
        covered = 0.0
        while i < len(host_ops) and host_ops[i][1] <= gs:
            i += 1
        j = i
        while j < len(host_ops) and host_ops[j][0] < ge:
            s, e, name = host_ops[j]
            overlap = min(e, ge) - max(s, gs)
            if overlap > 0:
                by_name[name] = by_name.get(name, 0.0) + overlap
                covered += overlap
            j += 1
        rest = (ge - gs) - covered
        if rest > 0:
            by_name["host_between_ops"] = by_name.get("host_between_ops", 0.0) + rest
    return by_name


def summarize(trace_path: str) -> dict:
    """Busy and window seconds, launch and sync counts, device time per
    kernel name (count, microseconds) and the idle gaps by host operator
    (microseconds)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    device, kernels, host_ops = [], {}, []
    launches = syncs = 0
    t0, t1 = float("inf"), float("-inf")
    for ev in events:
        if "ts" not in ev or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        t0, t1 = min(t0, s), max(t1, e)
        if cat in DEVICE_CATS:
            device.append((s, e))
            if cat == "kernel":
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += e - s
        elif cat == "cuda_runtime":
            launches += name.startswith("cudaLaunchKernel")
            syncs += name == "cudaStreamSynchronize"
        elif cat == "cpu_op":
            host_ops.append((s, e, name))
    busy = _union(device)
    busy_us = sum(e - s for s, e in busy)
    window_us = max(t1 - t0, 0.0)
    return dict(
        busy_s=busy_us * 1e-6, window_s=window_us * 1e-6, launch_calls=launches,
        sync_calls=syncs, kernels=kernels,
        idle_gaps=_idle_gaps(busy, _top_level(host_ops), t0, t1) if device else {},
    )


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by host operator, in seconds."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[name[:120], t * 1e-6] for name, (_, t) in ops],
                idle_gaps=[[name[:120], t * 1e-6] for name, t in gaps])
