"""Where the time of one solve goes on the card.

    python -m tpu3drecon_torch.benchmark.profile_solve [--trace-dir DIR] [--engines A,B]
        [--grid-lanes N]

The Chrome traces are kept in ``--trace-dir`` (default: the ignored
``tpu3drecon_torch/_build/profile/``), one ``<engine>.json`` each;
``--engines`` profiles only the engines or routes named (default: all);
``--grid-lanes`` pins the lanes per thread of the grid engine's B9 and B11
(``ops/cam_normal.grid_lanes``; 1 sums in the first port's order, so a
grid solve then takes the first port's CG iterations).

For each engine (the windowed track table ``ba_solve_wtt``, fully indexed,
the fused-kernel grid engine ``ba_solve_pallas`` and the dense track table
``ba_solve_tt``, fully fused), then for the wtt engine's unfused route
(``wtt_unfused``: ``linearize_kernel=False``, ``matvec_kernel="index"``)
and its one-hot route (``wtt_onehot``: ``linearize_kernel=False``,
``matvec_kernel="fused"``, on the packing with its dense int8 one-hot), on
the medium problem with ``BENCH_CONFIG``; for ``bal_seq_ssor``, the
BAL-scale sequential problem (``benchmark/balscale.py``) solved fully
indexed under the block-SSOR preconditioner, ``bal_seq_tridiag_unfused``,
the same problem with its dense int8 one-hot on the unfused route (B7, B8
with its od rows, B5, B2, B3) under the block-tridiagonal preconditioner,
and ``bal_hub``, the BAL hub problem (``bal_hub_wtt``, global camera
tiles, windows up to W = 1664) solved fully indexed under Schur-Jacobi,
each for 3 LM iterations (``BAL_CONFIG``); and for ``tt_seq1024_ssor``,
a 1024-camera sequential track table (256 points per camera, seed 7, as
``chip_smoke.py`` builds it) on the tt engine's default route
(``kernels=False``, PyTorch products through ``cam_ids``) under block SSOR
for 3 LM iterations; for ``flat``, the flat engine ``ba_solve`` on the
medium problem with ``BENCH_CONFIG``; for ``ba_grid``, the grid engine
``ba_solve_grid`` (plain PyTorch, the JAX CLI's ``--engine grid``) on the
medium problem packed by ``grid_from_flat``, with ``BENCH_CONFIG``; for ``pnp`` and ``tracking``, the
JAX suite's batched PnP (8 cameras of 2300 matches, ``refine_poses``
TRIVIAL with ``PNP_CONFIG``) and tracking (500 frames of 1000
observations, ``TRACKING_CONFIG``) cells on the dense LM
(``benchmark/solver_cells.py``): two warm-up solves, then
``torch.profiler`` (CPU and CUDA activities) over one solve.  The Chrome trace it exports is read
back, and one JSON line per engine or route gives

  - ``wall_s``: host clock around the profiled solve (synchronized);
  - ``busy_s`` and ``busy_share``: the union of device kernel, memcpy and
    memset intervals, and its share of ``wall_s``;
  - ``device_ops``: the number of device kernels, memcpys and memsets;
  - ``launch_calls`` / ``sync_calls``: ``cudaLaunchKernel`` and
    ``cudaStreamSynchronize`` calls on the host;
  - ``top``: the device kernels with the most total time, with their
    launch count, total and mean time;
  - ``port``: the same figures for each of the port's own CUDA kernels
    (``csrc/*.cu``) that ran;
  - ``spans``: for each program span in the trace (``utils/timing.span``,
    a ``user_annotation`` event; PERF.md lists the names), its calls, host
    seconds and share of ``wall_s``, and the ``cudaLaunchKernel`` and
    ``cudaStreamSynchronize`` calls made inside it, its children's
    included, with the device time of what those calls started (linked
    through the runtime events' correlation ids);
  - ``idle_s``: the device's idle seconds by the innermost program span
    open on the host at that moment, on the profiler's clock (``no_span``
    where none is open).

Needs a CUDA device; measures nothing elsewhere.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from tpu3drecon_torch.ops._build import BUILD_DIR

# The port's kernels (csrc/*.cu) as named in a trace: "...::<name><...>(...)"
# (B9 and B11 are grid_cam_normal_kernel and grid_coupling_kernel; an older
# tree's were cam_normal_kernel and a coupling_kernel of grid_kernels.cu).
PORT_KERNELS = ("lin_kernel", "coupling_kernel", "wt_planes_kernel", "cost_kernel",
                "w_rows_kernel", "onehot_coupling_kernel", "cam_planes_kernel",
                "contrib_kernel", "cam_normal_kernel", "grid_cam_normal_kernel",
                "point_normal_rows_kernel", "grid_coupling_kernel",
                "tt_cam_normal_kernel", "tt_coupling_kernel", "tt_wt_times_kernel",
                "tt_w_times_kernel", "tt_cost_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Device idle time while no program span is open on the host.
NO_SPAN = "no_span"


def _merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _intervals_union(spans) -> float:
    """Total length of the union of (start, end) spans."""
    return sum(e - s for s, e in _merge(spans))


def _open_chains(spans, times):
    """For each of the sorted ``times``, the (start, end, name) spans of
    ``spans`` (one thread's, nested, sorted by start and outer first) open
    at it, outermost first."""
    chains, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        chains.append(tuple(stack))
    return chains


def _innermost(spans) -> list[tuple[float, float, str]]:
    """(start, end, name) pieces of the time ``spans`` cover, each named
    after the innermost span open in it."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    mids = [(a + b) / 2 for a, b in zip(bounds, bounds[1:])]
    return [(a, b, chain[-1][2]) for a, b, chain in
            zip(bounds, bounds[1:], _open_chains(spans, mids)) if chain]


def _idle_by_span(busy, pieces, t0: float, t1: float) -> dict[str, float]:
    """Microseconds of device idle time in [t0, t1] by the innermost program
    span open on the host (``NO_SPAN`` where none is)."""
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    out: dict[str, float] = {}
    i = 0
    for gs, ge in gaps:
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            s, e, name = pieces[j]
            overlap = min(e, ge) - max(s, gs)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap
                covered += overlap
            j += 1
        if ge - gs - covered > 0:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + ge - gs - covered
    return out


def summarize(trace_path: str, wall_s: float, top: int = 12) -> dict:
    """Busy time, counts, the top kernels, every program span and the device
    idle time by innermost span from an exported Chrome trace (times in the
    trace are microseconds).  A span's launches, syncs and device time are
    those of the runtime calls made inside it on its thread (its children's
    included), the device time linked through their correlation ids."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    busy_spans, kernels, device_us = [], {}, {}
    runtime = {}  # thread -> [(ts, is launch, is sync, correlation)]
    annotations = {}  # thread -> [(start, end, name)]
    t0, t1 = float("inf"), float("-inf")
    for ev in events:
        if "ts" not in ev or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        t0, t1 = min(t0, start), max(t1, end)
        corr = ev.get("args", {}).get("correlation")
        thread = (ev.get("pid"), ev.get("tid"))
        if cat in DEVICE_CATS:
            busy_spans.append((start, end))
            if corr is not None:
                device_us[corr] = device_us.get(corr, 0.0) + end - start
            if cat == "kernel":
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += end - start
        elif cat == "cuda_runtime":
            runtime.setdefault(thread, []).append(
                (start, name.startswith("cudaLaunchKernel"),
                 name == "cudaStreamSynchronize", corr))
        elif cat == "user_annotation":
            annotations.setdefault(thread, []).append((start, end, name))
    busy = _merge(busy_spans)
    busy_s = _intervals_union(busy) * 1e-6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])

    def row(name, n, t):
        return dict(kernel=name[:90], launches=n, total_ms=t * 1e-3, mean_us=t / n)

    spans: dict[str, dict] = {}
    for thread, anns in annotations.items():
        anns.sort(key=lambda x: (x[0], -x[1]))
        for s, e, name in anns:
            r = spans.setdefault(name, dict(calls=0, host_s=0.0, launch_calls=0,
                                            sync_calls=0, device_ms=0.0))
            r["calls"] += 1
            r["host_s"] += (e - s) * 1e-6
        calls = sorted(runtime.get(thread, []))
        for (_, launch, sync, corr), chain in zip(
                calls, _open_chains(anns, [c[0] for c in calls])):
            for name in {n for _, _, n in chain}:
                r = spans[name]
                r["launch_calls"] += launch
                r["sync_calls"] += sync
                r["device_ms"] += device_us.get(corr, 0.0) * 1e-3
    for r in spans.values():
        r["host_share"] = r["host_s"] / wall_s
    # The idle gaps by the spans of the thread that holds most of them.
    host = max(annotations.values(), key=len, default=[])
    idle = _idle_by_span(busy, _innermost(host), t0, t1) if busy else {}
    return dict(
        wall_s=wall_s, busy_s=busy_s, busy_share=busy_s / wall_s,
        device_ops=len(busy_spans), launch_calls=sum(c[1] for v in runtime.values() for c in v),
        sync_calls=sum(c[2] for v in runtime.values() for c in v),
        top=[row(name, n, t) for name, (n, t) in ranked[:top]],
        port=[row(name, n, t) for name, (n, t) in ranked
              if any(f"::{k}<" in name for k in PORT_KERNELS)],
        spans=spans,
        idle_s={name: t * 1e-6 for name, t in sorted(idle.items(), key=lambda kv: -kv[1])},
    )


def profile(solve, problem, trace_path: str) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(2):
        solve(problem)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(problem)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    return summarize(trace_path, wall_s)


def tt_seq1024():
    """The 1024-camera sequential track table of ``chip_smoke.py`` (f32, on
    the card)."""
    from tpu3drecon_torch.dataset.synthetic import (
        make_sequential_scene,
        perturb_scene,
        scene_to_ba_problem,
    )
    from tpu3drecon_torch.problems.tt import tt_from_flat

    scene = make_sequential_scene(n_cameras=1024, points_per_camera=256, track_span=4,
                                  seed=7)
    flat, _ = scene_to_ba_problem(perturb_scene(scene, seed=8, point2d_noise=0.5),
                                  observed=scene, dtype=torch.float32)
    return tt_from_flat(flat)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=str(BUILD_DIR / "profile"),
                    help="where the Chrome traces are written")
    ap.add_argument("--engines", default="",
                    help="comma-separated engines or routes to profile (default: all)")
    ap.add_argument("--grid-lanes", type=int, default=None,
                    help="pin B9's and B11's lanes per thread (default: grid_lanes' pick)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve measures on a CUDA device; none is available")

    from tpu3drecon_torch.benchmark.balscale import (
        BAL_CONFIG,
        bal_hub_wtt,
        bal_sequential_wtt,
    )
    from tpu3drecon_torch.benchmark.medium_config import (
        BENCH_CONFIG,
        build_grid_problem,
        build_problem,
        build_tt_problem,
    )
    from tpu3drecon_torch.benchmark import solver_cells as cells
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import cam_normal
    from tpu3drecon_torch.problems.grid import grid_from_flat
    from tpu3drecon_torch.problems.wtt import expand_onehots, wtt_from_flat
    from tpu3drecon_torch.solvers.ba_grid import ba_solve_grid
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
    from tpu3drecon_torch.solvers.bundle_adjust import ba_solve
    from tpu3drecon_torch.solvers.pose_refine import refine_poses

    cfg = BENCH_CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
    cfg_a = BENCH_CONFIG._replace(matvec_kernel="index", linearize_kernel=False)
    cfg_c = BENCH_CONFIG._replace(matvec_kernel="fused", linearize_kernel=False)
    cfg_bal = BAL_CONFIG._replace(matvec_kernel="index", linearize_kernel="index",
                                  precond="ssor")
    runs = (
        ("wtt", lambda p: ba_solve_wtt(p, cfg),
         lambda: wtt_from_flat(build_problem(), defer_onehot=True)),
        ("grid", lambda p: ba_solve_pallas(p, BENCH_CONFIG), build_grid_problem),
        ("tt", lambda p: ba_solve_tt(p, BENCH_CONFIG, kernels="full"), build_tt_problem),
        ("wtt_unfused", lambda p: ba_solve_wtt(p, cfg_a),
         lambda: wtt_from_flat(build_problem(), defer_onehot=False)),
        ("wtt_onehot", lambda p: ba_solve_wtt(p, cfg_c),
         lambda: wtt_from_flat(build_problem(), defer_onehot=False)),
        ("bal_seq_ssor", lambda p: ba_solve_wtt(p, cfg_bal),
         lambda: bal_sequential_wtt(verbose=False)),
        ("bal_seq_tridiag_unfused",
         lambda p: ba_solve_wtt(p, cfg_bal._replace(linearize_kernel=False, precond="tridiag")),
         lambda: expand_onehots(bal_sequential_wtt(verbose=False))),
        ("bal_hub", lambda p: ba_solve_wtt(p, cfg_bal._replace(precond="schur_jacobi")),
         lambda: bal_hub_wtt(verbose=False)),
        ("tt_seq1024_ssor", lambda p: ba_solve_tt(p, BAL_CONFIG._replace(precond="ssor")),
         tt_seq1024),
        ("flat", lambda p: ba_solve(p, BENCH_CONFIG), build_problem),
        ("ba_grid", lambda p: ba_solve_grid(p, BENCH_CONFIG),
         lambda: grid_from_flat(build_problem())),
        ("pnp", lambda p: refine_poses(p, loss=RobustLoss.TRIVIAL, config=cells.PNP_CONFIG),
         lambda: cells.pnp_problem()[0]),
        ("tracking", lambda p: refine_poses(p, config=cells.TRACKING_CONFIG),
         lambda: cells.tracking_problem()[0]),
    )
    if args.grid_lanes is not None:
        pinned = args.grid_lanes
        cam_normal.grid_lanes = lambda k, itemsize: pinned
    out_dir = Path(args.trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    wanted = set(filter(None, args.engines.split(",")))
    unknown = wanted - {engine for engine, _, _ in runs}
    if unknown:
        raise SystemExit(f"profile_solve: unknown engines {sorted(unknown)}")
    for engine, solve, build in runs:
        if wanted and engine not in wanted:
            continue
        report = profile(solve, build(), str(out_dir / f"{engine}.json"))
        print(json.dumps(dict(engine=engine, device=torch.cuda.get_device_name(0),
                              grid_lanes=args.grid_lanes, **report)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
