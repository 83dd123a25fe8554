"""The per-layer readers' arithmetic.  Each metric of ``BENCHMARK.json``
has a file ``metrics/<name>.py`` whose ``read(ctx)`` is one of these;
``ctx`` holds the set-up's packing seconds (``pack_s``), the trace summary
(``trace``, ``trace.summarize``; None in an untraced run), the LM
iterations of the traced window (``lm_iters``), the wtt bucket shapes
(``buckets``, ``run._bucket_shapes``) and the traffic's kernel names
(``kernels``).  A reader that finds nothing to read returns None."""

from __future__ import annotations

from portbench.roofline import pass_least_s

# index_add_'s kernels (indexFuncSmallIndex / indexFuncLargeIndex) and
# scatter kernels, by name in a device trace.
SEGMENT_SUM_NAMES = ("indexFunc", "index_add", "scatter")


def pack_s(ctx):
    """Host seconds of the program's packing in set-up."""
    return ctx["pack_s"]


def syncs_per_lm_iter(ctx):
    """``cudaStreamSynchronize`` calls over the traced LM iterations."""
    if ctx["trace"] is None or not ctx["lm_iters"]:
        return None
    return ctx["trace"]["sync_calls"] / ctx["lm_iters"]


def launches_per_lm_iter(ctx):
    """``cudaLaunchKernel`` calls over the traced LM iterations."""
    if ctx["trace"] is None or not ctx["lm_iters"]:
        return None
    return ctx["trace"]["launch_calls"] / ctx["lm_iters"]


def idle_pct(ctx):
    """The traced window less the union of device intervals, in percent."""
    summary = ctx["trace"]
    if summary is None or summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]


def segment_sum_ms_per_lm_iter(ctx):
    """Device milliseconds of the segment-sum kernels per LM iteration."""
    summary = ctx["trace"]
    if summary is None or not ctx["lm_iters"]:
        return None
    hits = [t for name, (_, t) in summary["kernels"].items()
            if any(n in name for n in SEGMENT_SUM_NAMES)]
    if not hits:
        return None
    return sum(hits) * 1e-3 / ctx["lm_iters"]


def wtt_roofline(ctx):
    """The wtt kernels' least time over their device time, in percent: a
    kernel's passes are its launches over the number of buckets (one launch
    per bucket per pass), each pass's least time from the bucket shapes
    (``roofline.py``)."""
    summary, buckets = ctx["trace"], ctx["buckets"]
    if summary is None or not buckets:
        return None
    least_s = busy_s = 0.0
    for kernel in ctx["kernels"]:
        hits = [(n, t) for name, (n, t) in summary["kernels"].items() if f"::{kernel}<" in name]
        if not hits:
            continue
        busy_s += sum(t for _, t in hits) * 1e-6
        least_s += sum(n for n, _ in hits) / len(buckets) * pass_least_s(kernel, buckets)
    if busy_s <= 0:
        return None
    return 100.0 * least_s / busy_s
