#!/usr/bin/env python3
"""Run the PyTorch port's medium bundle-adjustment solve once on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires ``torch.cuda.is_available()``, prints the
   card's ``nvidia-smi`` name and power limit, builds the four wtt kernels
   (``tpu3drecon_torch/csrc/wtt_kernels.cu``) from source with nvcc.
2. Each kernel against its plain PyTorch version on the card, on the
   actual buckets of the packed medium problem (initial parameters,
   lam = 1e-4), in float32 and float64; B1 and B4 also with the Cauchy and
   Huber losses on the smallest bucket.  Tolerances: per-element outputs
   max|diff| <= 1e-5 * max|plain| (f32) / 1e-12 (f64); atomically reduced
   rows (B1 rows, B2) <= 1e-4 / 1e-10, because atomic summation order
   varies.  Times are CUDA-event medians of 20 calls, summed over the
   buckets (one pass of the solve).
3. The slice: the medium problem (100 cameras, 100k points, 200,704
   observations, f32) packed with ``wtt_from_flat(defer_onehot=True)`` and
   solved by ``ba_solve_wtt`` (30 LM iterations, fully indexed) on the card:
   one warm-up solve and 5 timed solves.  Requires final RMSE < 1e-3 px,
   final loss below the initial loss, every kernel launched during the
   solves and no plain version called.
4. Prints the kernel table as one JSON line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# (module attribute of the kernel's counter, kernel name, source, replaced TPU kernel)
KERNELS = (
    ("wtt_linearize", "COUNTS", "wtt_linearize_fused_idx",
     "tpu3drecon/ops/pallas/wtt_linearize.py:554"),
    ("wtt_matvec", "COUPLING_COUNTS", "wtt_coupling_rows_idx",
     "tpu3drecon/ops/pallas/wtt_matvec.py:215"),
    ("wtt_matvec", "WT_COUNTS", "wtt_wt_planes_idx",
     "tpu3drecon/ops/pallas/wtt_matvec.py:405"),
    ("wtt_cost", "COUNTS", "wtt_cost_cols_idx",
     "tpu3drecon/ops/pallas/wtt_cost.py:94"),
)
SOURCE = "tpu3drecon_torch/csrc/wtt_kernels.cu"
TOL = {  # (per-element, atomically reduced) bounds relative to max|plain|
    torch.float32: (1e-5, 1e-4),
    torch.float64: (1e-12, 1e-10),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def counters():
    import importlib

    return {
        name: getattr(importlib.import_module(f"tpu3drecon_torch.ops.{mod}"), attr)
        for mod, attr, name, _ in KERNELS
    }


def cuda_ms(fn, n: int = 20) -> float:
    """Median CUDA-event time of ``n`` calls of ``fn`` (after one warm-up)."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


WORST = {}  # kernel, dtype [, output] -> largest max|diff| / max|plain|


def compare(label: str, got, want, rel: float) -> float:
    """max|got - want|; raises unless <= rel * max|want|."""
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    if not err <= rel * max(scale, 1e-300):
        raise AssertionError(
            f"{label}: max|diff| {err:.3e} > {rel:.0e} * max|plain| {scale:.3e}"
        )
    tokens = label.split()  # kernel, dtype, ..., output name for B1
    key = " ".join(tokens[:2] + (tokens[-1:] if tokens[0] == "B1" else []))
    WORST[key] = max(WORST.get(key, 0.0), err / max(scale, 1e-300))
    return err


def kernel_inputs(problem, dtype, lam_value=1e-4):
    """Per-bucket kernel inputs at the initial parameters, cast to dtype."""
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


def check_kernels(problem):
    """Phase 2: every kernel against its plain version, f32 and f64."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import wtt_cost, wtt_linearize, wtt_matvec
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for _, _, name, _ in KERNELS}
    lin_outs = ("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt")
    for dtype in (torch.float32, torch.float64):
        elem, reduced = TOL[dtype]
        tag = "f32" if dtype == torch.float32 else "f64"
        for bi, d in enumerate(kernel_inputs(problem, dtype)):
            cfg = BAConfig()
            lin_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"],
                        d["lam"], d["inv_w"], cfg, 8, True)
            got = wtt_linearize.wtt_linearize_fused_idx(*lin_args)
            want = wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)
            errs = [compare(f"B1 {tag} bucket {bi} {k}", a, b,
                            reduced if k == "rows" else elem)
                    for k, a, b in zip(lin_outs, got, want)]
            _, jc, jp, v_inv, _, _ = want
            mv_args = (d["xw_t"], d["wcam"], jc, jp, v_inv)
            wt_args = (d["xw_t"], d["wcam"], jc, jp)
            cost_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"],
                         RobustLoss.TRIVIAL)
            errs_b2 = compare(f"B2 {tag} bucket {bi}",
                              wtt_matvec.wtt_coupling_rows_idx(*mv_args),
                              wtt_matvec.wtt_coupling_rows_idx_plain(*mv_args),
                              reduced)
            errs_b3 = compare(f"B3 {tag} bucket {bi}",
                              wtt_matvec.wtt_wt_planes_idx(*wt_args),
                              wtt_matvec.wtt_wt_planes_idx_plain(*wt_args), elem)
            errs_b4 = compare(f"B4 {tag} bucket {bi}",
                              wtt_cost.wtt_cost_cols_idx(*cost_args),
                              wtt_cost.wtt_cost_cols_idx_plain(*cost_args), elem)
            g, tb, pc, w = d["shape"]
            log(f"check {tag} bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}): "
                f"B1 {max(errs):.3e} B2 {errs_b2:.3e} B3 {errs_b3:.3e} "
                f"B4 {errs_b4:.3e}")
            if dtype != torch.float32:
                continue
            for name, err, fn, plain in (
                ("wtt_linearize_fused_idx", max(errs),
                 lambda: wtt_linearize.wtt_linearize_fused_idx(*lin_args),
                 lambda: wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)),
                ("wtt_coupling_rows_idx", errs_b2,
                 lambda: wtt_matvec.wtt_coupling_rows_idx(*mv_args),
                 lambda: wtt_matvec.wtt_coupling_rows_idx_plain(*mv_args)),
                ("wtt_wt_planes_idx", errs_b3,
                 lambda: wtt_matvec.wtt_wt_planes_idx(*wt_args),
                 lambda: wtt_matvec.wtt_wt_planes_idx_plain(*wt_args)),
                ("wtt_cost_cols_idx", errs_b4,
                 lambda: wtt_cost.wtt_cost_cols_idx(*cost_args),
                 lambda: wtt_cost.wtt_cost_cols_idx_plain(*cost_args)),
            ):
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ms"] += cuda_ms(fn)
                r["plain_ms"] += cuda_ms(plain)

        # Robust losses on the smallest bucket (B1 and B4).
        d = min(kernel_inputs(problem, dtype), key=lambda e: e["uv"].numel())
        for loss in (RobustLoss.CAUCHY, RobustLoss.HUBER):
            cfg = BAConfig(loss=loss)
            lin_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"],
                        d["lam"], d["inv_w"], cfg, 8, True)
            got = wtt_linearize.wtt_linearize_fused_idx(*lin_args)
            want = wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)
            for k, a, b in zip(lin_outs, got, want):
                compare(f"B1 {tag} {loss.value} {k}", a, b,
                        reduced if k == "rows" else elem)
            cost_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], loss)
            compare(f"B4 {tag} {loss.value}",
                    wtt_cost.wtt_cost_cols_idx(*cost_args),
                    wtt_cost.wtt_cost_cols_idx_plain(*cost_args), elem)
            log(f"check {tag} {loss.value}: B1 and B4 agree")
    return results


def solve_slice(flat, wtt):
    """Phase 3: the medium solve through the kernels; returns the report."""
    from tpu3drecon_torch.benchmark.medium_config import BENCH_CONFIG, timed_solve_stats
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse

    config = BENCH_CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
    _, _, init = ba_solve_wtt(wtt, config._replace(maxiter=0))
    counts = counters()
    for c in counts.values():
        c.reset()
    warm_s, times, (cams, pts, state) = timed_solve_stats(
        lambda p: ba_solve_wtt(p, config), wtt, repeats=5
    )
    launches = {name: c.kernel for name, c in counts.items()}
    plain = {name: c.plain for name, c in counts.items()}
    rmse = float(reprojection_rmse(flat, cams, pts))
    report = dict(
        median_s=statistics.median(times), min_s=min(times), max_s=max(times),
        warmup_s=warm_s, reproj_rmse_px=rmse,
        initial_loss=float(init.loss), final_loss=float(state.loss),
        accepted_steps=int(state.accepted), lm_iters=int(state.iter_num),
        cg_iters_last=int(state.cg_iters), launches=launches, plain_calls=plain,
    )
    log("solve " + json.dumps(report))
    if not rmse < 1e-3:
        raise AssertionError(f"final RMSE {rmse:.3e} px is not below 1e-3 px")
    if not float(state.loss) < float(init.loss):
        raise AssertionError("the final loss is not below the initial loss")
    missing = [n for n, k in launches.items() if k == 0]
    if missing:
        raise AssertionError(f"kernels not launched during the solve: {missing}")
    used_plain = [n for n, k in plain.items() if k != 0]
    if used_plain:
        raise AssertionError(f"plain versions ran during the solve: {used_plain}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from tpu3drecon_torch.benchmark.medium_config import build_problem
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.problems.wtt import wtt_from_flat

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
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  " + line.strip())

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    flat = build_problem(dev, torch.float32)
    wtt = wtt_from_flat(flat, defer_onehot=True, device=dev)
    log(f"problem: {flat.n_cameras} cameras, {flat.n_points} points, "
        f"{flat.n_obs} observations; packed in {time.perf_counter() - t0:.1f} s; "
        "buckets (G, Tb, Pc, W): "
        + str([(b.uv.shape[0], b.uv.shape[2], b.uv.shape[3], b.window)
               for b in wtt.buckets]))

    results = check_kernels(wtt)
    log("worst max|diff| / max|plain|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(WORST.items())))
    launches = solve_slice(flat, wtt)

    table = [
        dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
             launches=launches[name], **results[name])
        for _, _, name, replaces in KERNELS
    ]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
