"""Where the time of one solve goes on the card.

    python -m tpu3drecon_torch.benchmark.profile_solve [--trace-dir DIR] [--engines A,B]

The Chrome traces are kept in ``--trace-dir`` (default: the ignored
``tpu3drecon_torch/_build/profile/``), one ``<engine>.json`` each;
``--engines`` profiles only the engines or routes named (default: all).

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
for 3 LM iterations: two warm-up solves, then ``torch.profiler`` (CPU and
CUDA activities) over one solve.  The Chrome trace it exports is read
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
  - ``spans``: for each ``torch.profiler.record_function`` span of the
    solvers (the band preconditioner's ``band_precond_factor`` and
    ``band_precond_apply``), its calls, host time and share of ``wall_s``,
    and the ``cudaLaunchKernel`` calls made inside it.

Needs a CUDA device; measures nothing elsewhere.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from tpu3drecon_torch.ops._build import BUILD_DIR

# The solvers' record_function spans.
SPANS = ("band_precond_factor", "band_precond_apply")
# The port's kernels (csrc/*.cu) as named in a trace: "...::<name><...>(...)".
PORT_KERNELS = ("lin_kernel", "coupling_kernel", "wt_planes_kernel", "cost_kernel",
                "w_rows_kernel", "onehot_coupling_kernel", "cam_planes_kernel",
                "contrib_kernel", "cam_normal_kernel", "point_normal_kernel",
                "tt_cam_normal_kernel", "tt_coupling_kernel", "tt_wt_times_kernel",
                "tt_w_times_kernel", "tt_cost_kernel")


def _intervals_union(spans) -> float:
    """Total length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(trace_path: str, wall_s: float, top: int = 12) -> dict:
    """Busy time, counts and the top kernels from an exported Chrome trace
    (times in the trace are microseconds)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    device, kernels, launch_ts = [], {}, []
    spans = {name: [] for name in SPANS}
    syncs = 0
    for ev in events:
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            device.append((ev["ts"], ev["ts"] + ev["dur"]))
            if cat == "kernel":
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += ev["dur"]
        elif cat == "cuda_runtime":
            if name.startswith("cudaLaunchKernel"):
                launch_ts.append(ev["ts"])
            syncs += name == "cudaStreamSynchronize"
        elif cat == "user_annotation" and name in spans and "dur" in ev:
            spans[name].append((ev["ts"], ev["ts"] + ev["dur"]))
    busy_s = _intervals_union(device) * 1e-6
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])

    def row(name, n, t):
        return dict(kernel=name[:90], launches=n, total_ms=t * 1e-3, mean_us=t / n)

    def span_row(intervals):
        host_s = sum(e - s for s, e in intervals) * 1e-6
        inside = sum(any(s <= t <= e for s, e in intervals) for t in launch_ts)
        return dict(calls=len(intervals), host_s=host_s, host_share=host_s / wall_s,
                    launch_calls=inside)

    return dict(
        wall_s=wall_s, busy_s=busy_s, busy_share=busy_s / wall_s,
        device_ops=len(device), launch_calls=len(launch_ts), sync_calls=syncs,
        top=[row(name, n, t) for name, (n, t) in ranked[:top]],
        port=[row(name, n, t) for name, (n, t) in ranked
              if any(f"::{k}<" in name for k in PORT_KERNELS)],
        spans={name: span_row(iv) for name, iv in spans.items() if iv},
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
    from tpu3drecon_torch.problems.wtt import expand_onehots, wtt_from_flat
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt

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
    )
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
                              **report)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
