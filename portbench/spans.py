"""Per-layer readers of the program's own spans and counters
(``tpu3drecon_torch.utils.timing``; PERF.md lists the names).  The program
tallies its spans while a ``torch.profiler`` session records, and the
profiler records only in the traced window (set-up and the warm-up solve
run before it, the plain reference after it and outside the program), so
in a traced run the tally holds exactly the window.  Each reader divides
by the tally's own ``lm.iters`` and returns None in an untraced run,
where the program keeps no tally (a tree before the spans) and where the
tally counted no LM iteration; none raises."""

from __future__ import annotations

import sys


def _per_lm_iter_ms(ctx, seconds_of):
    """1e3 * ``seconds_of(spans)`` over the tally's LM iterations, or None."""
    if ctx.get("trace") is None:
        return None
    try:
        from tpu3drecon_torch.utils.timing import tally
    except ImportError:
        return None
    try:
        t = tally()
        iters = t["counts"].get("lm.iters", 0)
        seconds = seconds_of(t["spans"]) if iters else None
        return None if seconds is None else 1e3 * seconds / iters
    except Exception as e:  # a reader reports nothing rather than fail the run
        print(f"portbench: span reader: {e!r}", file=sys.stderr)
        return None


def _span_s(name):
    def seconds_of(spans):
        return spans[name]["s"] if name in spans else None
    return seconds_of


def _sync_wait_s(spans):
    """Host seconds inside the ``sync.*`` spans (outermost ones only)."""
    return sum(v["s"] for k, v in spans.items()
               if k.startswith("sync.") and not (v["parent"] or "").startswith("sync."))


def linearize_ms_per_lm_iter(ctx):
    """Host ms inside ``lm.linearize`` per LM iteration."""
    return _per_lm_iter_ms(ctx, _span_s("lm.linearize"))


def pcg_ms_per_lm_iter(ctx):
    """Host ms inside ``pcg`` (the whole CG solve) per LM iteration."""
    return _per_lm_iter_ms(ctx, _span_s("pcg"))


def sync_wait_ms_per_lm_iter(ctx):
    """Host ms inside every ``sync.*`` span, the host blocked on the card,
    per LM iteration."""
    return _per_lm_iter_ms(ctx, _sync_wait_s)
