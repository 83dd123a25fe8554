#!/usr/bin/env python3
"""Run the PyTorch port's medium bundle-adjustment solves once on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires ``torch.cuda.is_available()``, prints the
   card's ``nvidia-smi`` name and power limit, builds every kernel source
   (``tpu3drecon_torch/csrc/*.cu``, one nvcc per source in parallel) and
   prints each source's compile time.
2. The wtt kernels B1-B4 against their plain PyTorch versions on the card,
   on the actual buckets of the packed medium problem (initial parameters,
   lam = 1e-4), in float32 and float64; B1 and B4 also with the Cauchy and
   Huber losses on the smallest bucket.
3. The wtt path: the medium problem (100 cameras, 100k points, 200,704
   observations, f32) packed with ``wtt_from_flat(defer_onehot=True)`` and
   solved by ``ba_solve_wtt`` (30 LM iterations, fully indexed): one
   warm-up solve and 5 timed solves.
4. The grid kernels B9-B11 against their plain versions on the card, on
   the linearization inputs of the medium problem in bucketed grid layout
   (``build_grid_problem``; initial parameters, lam = 1e-4), in float32 and
   float64, B9 under all three losses.
5. The grid path: ``ba_solve_pallas`` on the same problem with the same
   config: one warm-up solve and 3 timed solves.
6. Prints the kernel table as one JSON line, the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); summed outputs 1e-4 and 1e-10 (B1 rows and B2 rows are
atomic sums whose order varies; B9's U and g and B11's blocks are block
reductions in another order than the plain version's).  Kernel and plain
times (``ms``, ``plain_ms``) are device times (``device_ms``): the median
of 20 calls, each with a cold L2 and timed by a CUDA-event pair that sees
none of the call's host time, summed over one pass of the solve (the five
buckets, or one linearization).  ``ms`` covers all the device work of the
wrapper: the kernel, and for B9 the packing of the camera rows (as in the
JAX function).  Every count is set to 0
just before each path's solves and read just after: each path must launch
each of its kernels and call no plain version.  Each solve must reach a
reprojection RMSE below 1e-3 px and a final loss below the initial one.

``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes the function must move (each input read once, each
output written once, f32, from this run's tensors) over 3.35 TB/s and its
operations (counted per slot or lane from the kernel source, ``FLOPS``)
over 67 TFLOP/s of float32.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time

import torch

WTT_SRC = "tpu3drecon_torch/csrc/wtt_kernels.cu"
GRID_SRC = "tpu3drecon_torch/csrc/grid_kernels.cu"
# (module, counter attribute, kernel name, source, replaced TPU kernel, path)
KERNELS = (
    ("wtt_linearize", "COUNTS", "wtt_linearize_fused_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_linearize.py:554", "wtt"),
    ("wtt_matvec", "COUPLING_COUNTS", "wtt_coupling_rows_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_matvec.py:215", "wtt"),
    ("wtt_matvec", "WT_COUNTS", "wtt_wt_planes_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_matvec.py:405", "wtt"),
    ("wtt_cost", "COUNTS", "wtt_cost_cols_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_cost.py:94", "wtt"),
    ("cam_normal", "COUNTS", "cam_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/cam_normal.py:205", "grid"),
    ("point_normal", "COUNTS", "point_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/point_normal.py:80", "grid"),
    ("coupling", "COUNTS", "coupling_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/coupling.py:65", "grid"),
)
TOL = {  # (per-element, summed) bounds relative to max|plain|
    torch.float32: (1e-5, 1e-4),
    torch.float64: (1e-12, 1e-10),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12
# Float operations per unit of work, counted from csrc/*.cu: per slot
# (Tb * Pc per bucket) for B1-B4, per grid lane (C * K) for B9 and B11,
# per track row (P * T2) plus per point for B10.
FLOPS = {
    "wtt_linearize_fused_idx": 1000, "wtt_coupling_rows_idx": 80,
    "wtt_wt_planes_idx": 44, "wtt_cost_cols_idx": 45,
    "cam_normal_fused": 340, "point_normal_row": 18, "point_normal_point": 60,
    "coupling_fused": 408,
}
CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


def log(msg: str) -> None:
    print(msg, flush=True)


def counters():
    return {
        name: getattr(importlib.import_module(f"tpu3drecon_torch.ops.{mod}"), attr)
        for mod, attr, name, *_ in KERNELS
    }


L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
SPIN_CYCLES_PER_S = 2e9  # at or above the SM clock: a spin lasts at least its time


def device_ms(fn, n: int = 20) -> float:
    """Median device time (ms) of one call of ``fn`` over ``n`` calls.

    Before each call a 128 MB write evicts the L2, so every call reads its
    inputs from HBM, and a spin kernel then holds the stream for twice
    the host time of one call plus 1 ms, so the host has enqueued the whole
    call before its work starts: the CUDA-event pair around the call spans
    its device work back to back, without the host time between launches.
    """
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int((2 * host_s + 1e-3) * SPIN_CYCLES_PER_S)
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


RESULTS = {  # kernel -> measured and counted figures of this run
    name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}
    for _, _, name, *_ in KERNELS
}
WORST = {}  # "kernel dtype [output]" -> largest max|diff| / max|plain|


def compare(kernel: str, tag: str, output: str, got, want, rel: float) -> float:
    """max|got - want|; raises unless <= rel * max|want|."""
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    if not err <= rel * max(scale, 1e-300):
        raise AssertionError(f"{kernel} {tag} {output}: max|diff| {err:.3e} > "
                             f"{rel:.0e} * max|plain| {scale:.3e}")
    key = f"{kernel} {tag} {output}".strip()
    WORST[key] = max(WORST.get(key, 0.0), err / max(scale, 1e-300))
    if tag == "f32":
        r = RESULTS[kernel]
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return err


def account(kernel: str, fn, plain, n_bytes: int, flops: int) -> None:
    """Adds one f32 call of ``kernel`` to its pass: device times and work."""
    r = RESULTS[kernel]
    r["ms"] += device_ms(fn)
    r["plain_ms"] += device_ms(plain)
    r["bytes"] += n_bytes
    r["flops"] += flops


def wtt_kernel_inputs(problem, dtype, lam_value=1e-4):
    """Per-bucket wtt kernel inputs at the initial parameters, cast to dtype."""
    from tpu3drecon_torch.solvers.ba_wtt import (
        _inv_w,
        _padded_table,
        _window_idx,
        _window_rows,
    )

    cams = problem.cameras
    dev = problem.points3d.device
    params = (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew, None)
    table = _padded_table(params, problem.c_pad).to(dtype)
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = []
    for bucket, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, tb, pc = bucket.uv.shape
        widx = _window_idx(bucket)
        pts = problem.points3d[off : off + g * pc].reshape(g, pc, 3)
        x = torch.randn(problem.c_pad, 8, generator=gen, dtype=torch.float64)
        out.append(dict(
            wcam=bucket.wcam,
            tw=_window_rows(table, widx).contiguous(),
            pts=pts.permute(2, 0, 1).contiguous().to(dtype),
            uv=bucket.uv.to(dtype),
            mask=bucket.mask.to(dtype),
            lam=torch.tensor(lam_value, dtype=dtype, device=dev),
            inv_w=_inv_w(problem, dtype),
            xw_t=_window_rows(x.to(dev, dtype), widx).transpose(1, 2).contiguous(),
            shape=(g, tb, pc, bucket.window),
        ))
    return out


def check_wtt_kernels(problem) -> None:
    """Phase 2: B1-B4 against their plain versions, f32 and f64."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import wtt_cost, wtt_linearize, wtt_matvec
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    lin_outs = ("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt")
    for dtype in (torch.float32, torch.float64):
        elem, summed = TOL[dtype]
        tag = "f32" if dtype == torch.float32 else "f64"
        for bi, d in enumerate(wtt_kernel_inputs(problem, dtype)):
            lin_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"],
                        d["lam"], d["inv_w"], BAConfig(), 8, True)
            got = wtt_linearize.wtt_linearize_fused_idx(*lin_args)
            want = wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)
            err_b1 = max(
                compare("wtt_linearize_fused_idx", tag, k, a, b,
                        summed if k == "rows" else elem)
                for k, a, b in zip(lin_outs, got, want)
            )
            _, jc, jp, v_inv, _, _ = want
            mv_args = (d["xw_t"], d["wcam"], jc, jp, v_inv)
            wt_args = (d["xw_t"], d["wcam"], jc, jp)
            cost_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"],
                         RobustLoss.TRIVIAL)
            rows_b2 = wtt_matvec.wtt_coupling_rows_idx(*mv_args)
            planes_b3 = wtt_matvec.wtt_wt_planes_idx(*wt_args)
            cols_b4 = wtt_cost.wtt_cost_cols_idx(*cost_args)
            err_b2 = compare("wtt_coupling_rows_idx", tag, "", rows_b2,
                             wtt_matvec.wtt_coupling_rows_idx_plain(*mv_args), summed)
            err_b3 = compare("wtt_wt_planes_idx", tag, "", planes_b3,
                             wtt_matvec.wtt_wt_planes_idx_plain(*wt_args), elem)
            err_b4 = compare("wtt_cost_cols_idx", tag, "", cols_b4,
                             wtt_cost.wtt_cost_cols_idx_plain(*cost_args), elem)
            g, tb, pc, w = d["shape"]
            log(f"check {tag} wtt bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}): "
                f"B1 {err_b1:.3e} B2 {err_b2:.3e} B3 {err_b3:.3e} B4 {err_b4:.3e}")
            if dtype != torch.float32:
                continue
            slots = g * tb * pc
            account("wtt_linearize_fused_idx",
                    lambda: wtt_linearize.wtt_linearize_fused_idx(*lin_args),
                    lambda: wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args),
                    nbytes(*lin_args[:7], *got),
                    FLOPS["wtt_linearize_fused_idx"] * slots)
            account("wtt_coupling_rows_idx",
                    lambda: wtt_matvec.wtt_coupling_rows_idx(*mv_args),
                    lambda: wtt_matvec.wtt_coupling_rows_idx_plain(*mv_args),
                    nbytes(*mv_args, rows_b2), FLOPS["wtt_coupling_rows_idx"] * slots)
            account("wtt_wt_planes_idx",
                    lambda: wtt_matvec.wtt_wt_planes_idx(*wt_args),
                    lambda: wtt_matvec.wtt_wt_planes_idx_plain(*wt_args),
                    nbytes(*wt_args, planes_b3), FLOPS["wtt_wt_planes_idx"] * slots)
            account("wtt_cost_cols_idx",
                    lambda: wtt_cost.wtt_cost_cols_idx(*cost_args),
                    lambda: wtt_cost.wtt_cost_cols_idx_plain(*cost_args),
                    nbytes(*cost_args[:5], cols_b4), FLOPS["wtt_cost_cols_idx"] * slots)

        # Robust losses on the smallest bucket (B1 and B4).
        d = min(wtt_kernel_inputs(problem, dtype), key=lambda e: e["uv"].numel())
        for loss in (RobustLoss.CAUCHY, RobustLoss.HUBER):
            lin_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"],
                        d["lam"], d["inv_w"], BAConfig(loss=loss), 8, True)
            got = wtt_linearize.wtt_linearize_fused_idx(*lin_args)
            want = wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)
            for k, a, b in zip(lin_outs, got, want):
                compare("wtt_linearize_fused_idx", tag, k, a, b,
                        summed if k == "rows" else elem)
            cost_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], loss)
            compare("wtt_cost_cols_idx", tag, "", wtt_cost.wtt_cost_cols_idx(*cost_args),
                    wtt_cost.wtt_cost_cols_idx_plain(*cost_args), elem)
            log(f"check {tag} {loss.value}: B1 and B4 agree")


def check_grid_kernels(grid) -> None:
    """Phase 4: B9-B11 against their plain versions, f32 and f64."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import cam_normal, coupling, point_normal
    from tpu3drecon_torch.solvers.ba_pallas import (
        _grid_planes,
        _inv_w,
        _track_gather,
        _uv_planes,
        _vinv6,
    )

    cams = grid.cameras
    c, k = grid.mask.shape
    p_num = grid.points3d.shape[0]
    for dtype in (torch.float32, torch.float64):
        elem, summed = TOL[dtype]
        tag = "f32" if dtype == torch.float32 else "f64"
        lam = torch.tensor(1e-4, dtype=dtype, device=grid.points3d.device)
        cam_args = (*(getattr(cams, f).to(dtype) for f in CAM_FIELDS),
                    _grid_planes(grid.points3d.to(dtype), grid.pt_idx),
                    _uv_planes(grid).to(dtype), grid.mask.to(dtype), _inv_w(grid, dtype))
        for loss in (RobustLoss.TRIVIAL, RobustLoss.CAUCHY, RobustLoss.HUBER):
            got = cam_normal.cam_normal_fused(*cam_args, loss=loss)
            plain = cam_normal.cam_normal_fused_plain(*cam_args, loss=loss)
            err = max(compare("cam_normal_fused", tag, name, a, b,
                              summed if name in ("u", "g") else elem)
                      for name, a, b in zip(("r", "jp", "jc", "u", "g"), got, plain))
            log(f"check {tag} grid B9 {loss.value}: {err:.3e}")
            if loss == RobustLoss.TRIVIAL:
                want, out_b9 = plain, got
        if dtype == torch.float32:
            account("cam_normal_fused",
                    lambda: cam_normal.cam_normal_fused(*cam_args),
                    lambda: cam_normal.cam_normal_fused_plain(*cam_args),
                    nbytes(*cam_args[5:], *out_b9)
                    + c * cam_normal.PARAM_WIDTH * cam_args[0].element_size(),
                    FLOPS["cam_normal_fused"] * c * k)

        r, jp, jc, _, _ = want
        v_parts = []
        for bi, (jp_g, r_g) in enumerate(_track_gather(jp, r, grid)):
            got = point_normal.point_normal_fused(jp_g, r_g, lam)
            plain = point_normal.point_normal_fused_plain(jp_g, r_g, lam)
            err = max(compare("point_normal_fused", tag, name, a, b, elem)
                      for name, a, b in zip(("v_inv", "g_pt", "damp_pt"), got, plain))
            log(f"check {tag} grid B10 bucket {bi} (P={jp_g.shape[0]} "
                f"T2={jp_g.shape[1]}): {err:.3e}")
            v_parts.append(plain[0])
            if dtype == torch.float32:
                account("point_normal_fused",
                        lambda: point_normal.point_normal_fused(jp_g, r_g, lam),
                        lambda: point_normal.point_normal_fused_plain(jp_g, r_g, lam),
                        nbytes(jp_g, r_g, lam, *got),
                        FLOPS["point_normal_row"] * r_g.numel()
                        + FLOPS["point_normal_point"] * r_g.shape[0])

        vinv6_g = _grid_planes(_vinv6(torch.cat(v_parts)[:p_num]), grid.pt_idx)
        got = coupling.coupling_fused(jc, jp, vinv6_g)
        err = compare("coupling_fused", tag, "", got,
                      coupling.coupling_fused_plain(jc, jp, vinv6_g), summed)
        log(f"check {tag} grid B11: {err:.3e}")
        if dtype == torch.float32:
            account("coupling_fused",
                    lambda: coupling.coupling_fused(jc, jp, vinv6_g),
                    lambda: coupling.coupling_fused_plain(jc, jp, vinv6_g),
                    nbytes(jc, jp, vinv6_g, got), FLOPS["coupling_fused"] * c * k)


def drive(path: str, solve, problem, flat, repeats: int) -> dict:
    """One path's solves (1 warm-up + ``repeats``) with every count set to 0
    just before and read just after; returns its kernels' launch counts."""
    from tpu3drecon_torch.benchmark.medium_config import timed_solve_stats
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse

    _, _, init = solve(problem, maxiter=0)
    counts = counters()
    for cnt in counts.values():
        cnt.reset()
    warm_s, times, (cams, pts, state) = timed_solve_stats(solve, problem, repeats)
    mine = {name for *_, name, _, _, p in KERNELS if p == path}
    launches = {n: cnt.kernel for n, cnt in counts.items() if n in mine}
    plain = {n: cnt.plain for n, cnt in counts.items() if cnt.plain}
    rmse = float(reprojection_rmse(flat, cams, pts))
    report = dict(
        median_s=statistics.median(times), min_s=min(times), max_s=max(times),
        warmup_s=warm_s, reproj_rmse_px=rmse,
        initial_loss=float(init.loss), final_loss=float(state.loss),
        accepted_steps=int(state.accepted), lm_iters=int(state.iter_num),
        cg_iters_last=int(state.cg_iters),
        launches_per_solve={n: v / (repeats + 1) for n, v in launches.items()},
        plain_calls=plain,
    )
    log(f"solve {path} " + json.dumps(report))
    if not rmse < 1e-3:
        raise AssertionError(f"{path}: final RMSE {rmse:.3e} px is not below 1e-3 px")
    if not float(state.loss) < float(init.loss):
        raise AssertionError(f"{path}: the final loss is not below the initial loss")
    missing = [n for n, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"{path}: kernels not launched during the solves: {missing}")
    if plain:
        raise AssertionError(f"{path}: plain versions ran during the solves: {plain}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from tpu3drecon_torch.benchmark.medium_config import (
        BENCH_CONFIG,
        build_grid_problem,
        build_problem,
    )
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.problems.wtt import wtt_from_flat
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path, compiler_out = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in compiler_out.splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("nvcc ")):
            log("  " + line.strip())

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    flat = build_problem(dev, torch.float32)
    wtt = wtt_from_flat(flat, defer_onehot=True, device=dev)
    log(f"problem: {flat.n_cameras} cameras, {flat.n_points} points, "
        f"{flat.n_obs} observations; wtt packed in {time.perf_counter() - t0:.1f} s; "
        "buckets (G, Tb, Pc, W): "
        + str([(b.uv.shape[0], b.uv.shape[2], b.uv.shape[3], b.window)
               for b in wtt.buckets]))

    check_wtt_kernels(wtt)
    wtt_config = BENCH_CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
    launches = drive(
        "wtt", lambda p, **kw: ba_solve_wtt(p, wtt_config._replace(**kw)), wtt, flat, 5
    )

    t0 = time.perf_counter()
    grid = build_grid_problem(dev, torch.float32)
    log(f"grid problem: (C, K) = {tuple(grid.mask.shape)}, "
        f"P_pad = {grid.points3d.shape[0]}, built and packed in "
        f"{time.perf_counter() - t0:.1f} s; track buckets (Pb, Tb): "
        + str([tuple(b.track_idx.shape) for b in grid.buckets]))
    check_grid_kernels(grid)
    launches.update(drive(
        "grid", lambda p, **kw: ba_solve_pallas(p, BENCH_CONFIG._replace(**kw)),
        grid, flat, 3,
    ))
    log("worst max|diff| / max|plain|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(WORST.items())))

    table = []
    for *_, name, source, replaces, _ in KERNELS:
        r = RESULTS[name]
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        flops_ms = r["flops"] / F32_FLOPS_PER_S * 1e3
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            library_ms=None,
        ))
        log(f"bound {name}: {r['bytes']} B -> {bytes_ms:.6f} ms, "
            f"{r['flops']} flop -> {flops_ms:.6f} ms")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
