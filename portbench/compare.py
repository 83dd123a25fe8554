"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference.py``) on the same inputs.

Numbers (each against the cell's limit in ``limits/<workload>.json``):

- ``cost_gap``: over every solve of the window, the largest
  |reported final cost - the reference's final cost| / the reference's;
- ``cost_eval_gap``: over the sampled solves (the window's first and
  last), |reported cost - the reference's cost of the returned
  parameters| / the latter: the reported cost belongs to the answer;
- ``param_gap``: over the sampled solves and the parameter groups
  (rotations, translations, focal lengths, points, and k1, k2 where the
  traffic optimizes them), the largest |returned - reference| entry over
  the root mean square of the reference's own step in that group;
- ``iters_off``: solves whose LM iteration count is not the traffic's
  ``maxiter`` (limit 0).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import Params

GROUPS = ("rmats", "tvecs", "fx_fy", "points3d")


def param_gaps(got: Params, ref: Params, start: Params, groups=GROUPS) -> dict[str, float]:
    """Per group: max |got - ref| over the RMS of ref - start."""
    out = {}
    for k in groups:
        g, r, s = (getattr(p, k).double() for p in (got, ref, start))
        step = torch.sqrt(torch.mean((r - s) ** 2))
        out[k] = float(torch.max(torch.abs(g - r)) / torch.clamp(step, min=1e-300))
    return out


def numbers(losses, iters, samples, ref, ref_result, maxiter: int) -> tuple[dict, list]:
    """(the compared numbers, each solve's cost gap).  ``samples`` holds
    (Params, reported loss) of the sampled solves; ``losses``/``iters``
    every solve's reported cost and LM iterations."""
    f_ref = ref_result.loss
    per_solve = [abs(x - f_ref) / f_ref if math.isfinite(x) else math.inf for x in losses]
    eval_gap, gap = 0.0, 0.0
    groups = GROUPS + ("dist",) if ref.optimize_dist else GROUPS
    for params, loss in samples:
        f = ref.cost(params)
        eval_gap = max(eval_gap, abs(loss - f) / f if math.isfinite(loss + f) else math.inf)
        pg = param_gaps(params, ref_result.params, ref.start, groups)
        gap = max([gap] + [v if math.isfinite(v) else math.inf for v in pg.values()])
    return dict(
        cost_gap=max(per_solve) if per_solve else math.inf,
        cost_eval_gap=eval_gap,
        param_gap=gap,
        iters_off=float(sum(int(i) != maxiter for i in iters)),
    ), per_solve


def judge(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for every compared number."""
    out = {}
    for name, value in nums.items():
        limit = limits[name]
        out[name] = dict(value=value, limit=limit, ok=bool(value <= limit))
    return out
