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
4. The wtt route kernels B5-B8 against their plain versions on the same
   buckets packed with their dense int8 one-hot
   (``wtt_from_flat(defer_onehot=False)``), in float32 and float64: B7
   bit-equal, B8 with and without the Schur-Jacobi columns, B6 with the
   int8 one-hot and in float64 also with a float64 one-hot; then on the
   first bucket with window row 0 set to NaN and used by padded slots only
   (and NaN jc/jp/r on padded slots for B5 and B8), which must read exact
   zeros.
5. The wtt_unfused path (``linearize_kernel=False``,
   ``matvec_kernel="index"``: B7, B8, B5, B2, B3) and the wtt_onehot path
   (``linearize_kernel=False``, ``matvec_kernel="fused"``: B7, B8, B6) on
   the one-hot packing: one warm-up solve and 3 timed solves each.
6. The grid kernels B9-B11 against their plain versions on the card, on
   the linearization inputs of the medium problem in bucketed grid layout
   (``build_grid_problem``; initial parameters, lam = 1e-4), in float32 and
   float64, B9 under all three losses.
7. The grid path: ``ba_solve_pallas`` on the same problem with the same
   config: one warm-up solve and 3 timed solves.
8. The dense track-table kernels B12-B16 against their plain versions on
   the card, on the five buckets of the medium problem in track-table
   layout (``build_tt_problem``; initial parameters, lam = 1e-4), in
   float32 and float64, B12 and B16 under all three losses.
9. The tt path: ``ba_solve_tt`` (fully fused, kernels B12-B16) on the same
   problem with the same config: one warm-up solve and 3 timed solves.
10. Prints the kernel table as one JSON line, the ``nvidia-smi`` line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); summed outputs 1e-4 and 1e-10 (B1, B2, B5, B6 and B8 rows,
B12's U|g columns, B13 and B15 are atomic sums whose order varies; B9's U
and g and B11's blocks are block reductions in another order than the
plain version's); B7 (a selection) exactly.  Kernel and plain
times (``ms``, ``plain_ms``) are device times (``device_ms``): the median
of 20 calls, each with a cold L2 and timed by a CUDA-event pair that sees
none of the call's host time, summed over one pass of the solve (the five
buckets, or one linearization).  ``ms`` covers all the device work of the
wrapper: the kernel, and for B9 the packing of the camera rows (as in the
JAX function), for B16 the sum of its per-point partials.  B7's
``library_ms`` is the same device time of the one ``torch.gather`` that
computes its function; no other kernel has such a call.  Every count is
set to 0 just before each path's solves and read just after: each path
must launch each of its kernels and call no plain version.  A kernel on
several paths takes its table ``launches`` from the first; every path's
counts are on its ``solve`` line.  Each solve must reach a reprojection
RMSE below 1e-3 px and a final loss below the initial one.

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
ROUTE_SRC = "tpu3drecon_torch/csrc/wtt_route_kernels.cu"
GRID_SRC = "tpu3drecon_torch/csrc/grid_kernels.cu"
TT_SRC = "tpu3drecon_torch/csrc/tt_kernels.cu"
LIN_PY = "tpu3drecon/ops/pallas/wtt_linearize.py"
MV_PY = "tpu3drecon/ops/pallas/wtt_matvec.py"
TT_PY = "tpu3drecon/ops/pallas/tt_linearize.py"
# The paths: wtt's fully indexed route, its unfused route (a) and its
# one-hot route (c), the grid engine, the dense track table.
WTT, UNFUSED, ONEHOT = "wtt", "wtt_unfused", "wtt_onehot"
# (module, counter attribute, kernel name, source, replaced TPU kernel, paths)
KERNELS = (
    ("wtt_linearize", "COUNTS", "wtt_linearize_fused_idx", WTT_SRC, f"{LIN_PY}:554",
     {WTT}),
    ("wtt_matvec", "COUPLING_COUNTS", "wtt_coupling_rows_idx", WTT_SRC, f"{MV_PY}:215",
     {WTT, UNFUSED}),
    ("wtt_matvec", "WT_COUNTS", "wtt_wt_planes_idx", WTT_SRC, f"{MV_PY}:405",
     {WTT, UNFUSED}),
    ("wtt_cost", "COUNTS", "wtt_cost_cols_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_cost.py:94", {WTT}),
    ("wtt_matvec", "W_ROWS_COUNTS", "wtt_w_rows_idx", ROUTE_SRC, f"{MV_PY}:468",
     {UNFUSED}),
    ("wtt_matvec", "FUSED_COUNTS", "wtt_coupling_rows_fused", ROUTE_SRC, f"{MV_PY}:526",
     {ONEHOT}),
    ("wtt_linearize", "CAM_PLANES_COUNTS", "wtt_cam_planes_idx", ROUTE_SRC,
     f"{LIN_PY}:229", {UNFUSED, ONEHOT}),
    ("wtt_linearize", "CONTRIB_COUNTS", "wtt_contrib_rows_idx", ROUTE_SRC,
     f"{LIN_PY}:286", {UNFUSED, ONEHOT}),
    ("cam_normal", "COUNTS", "cam_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/cam_normal.py:205", {"grid"}),
    ("point_normal", "COUNTS", "point_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/point_normal.py:80", {"grid"}),
    ("coupling", "COUNTS", "coupling_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/coupling.py:65", {"grid"}),
    ("tt_linearize", "CAM_COUNTS", "tt_cam_normal_fused", TT_SRC, f"{TT_PY}:221", {"tt"}),
    ("tt_linearize", "COUPLING_COUNTS", "tt_coupling_fused", TT_SRC, f"{TT_PY}:297", {"tt"}),
    ("tt_linearize", "WT_COUNTS", "tt_wt_times_fused", TT_SRC, f"{TT_PY}:436", {"tt"}),
    ("tt_linearize", "W_COUNTS", "tt_w_times_fused", TT_SRC, f"{TT_PY}:475", {"tt"}),
    ("tt_linearize", "COST_COUNTS", "tt_cost_fused", TT_SRC, f"{TT_PY}:512", {"tt"}),
)
TOL = {  # (per-element, summed) bounds relative to max|plain|
    torch.float32: (1e-5, 1e-4),
    torch.float64: (1e-12, 1e-10),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12
# Float operations per unit of work, counted from csrc/*.cu: per slot
# (Tb * Pc per bucket) for B1-B8 and B12-B16 (np = 8, atomic adds
# included; B8 with the Schur-Jacobi columns: 108 u + 24 g + 72 W + 120 WV
# + 180 coupling + 80 adds; B7 is a copy; B6's one-hot scan compares bytes,
# no float operation), per grid lane (C * K) for B9 and B11, per track row
# (P * T2) plus per point for B10.
FLOPS = {
    "wtt_linearize_fused_idx": 1000, "wtt_coupling_rows_idx": 80,
    "wtt_wt_planes_idx": 44, "wtt_cost_cols_idx": 45,
    "wtt_w_rows_idx": 42, "wtt_coupling_rows_fused": 80, "wtt_cam_planes_idx": 0,
    "wtt_contrib_rows_idx": 584,
    "cam_normal_fused": 340, "point_normal_row": 18, "point_normal_point": 60,
    "coupling_fused": 408,
    "tt_cam_normal_fused": 370, "tt_coupling_fused": 408, "tt_wt_times_fused": 44,
    "tt_w_times_fused": 42, "tt_cost_fused": 51,
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
    name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0,
           "library_ms": None}
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


def account(kernel: str, fn, plain, n_bytes: int, flops: int, library=None) -> None:
    """Adds one f32 call of ``kernel`` to its pass: device times and work
    (and the time of ``library``, one PyTorch call of the same function)."""
    r = RESULTS[kernel]
    r["ms"] += device_ms(fn)
    r["plain_ms"] += device_ms(plain)
    r["bytes"] += n_bytes
    r["flops"] += flops
    if library is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + device_ms(library)


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


def route_planes(d, planes, cfg):
    """jc, jp, r (Jacobian planes) and v_inv, g_pt (point normal) of one
    bucket from its camera planes, as the unfused linearization forms them."""
    from tpu3drecon_torch.ops.wtt_linearize import point_normal
    from tpu3drecon_torch.solvers.ba_tt import _tt_blocks

    blocks = _tt_blocks(planes.transpose(0, 1), d["pts"][:, :, None, :],
                        d["uv"].transpose(0, 1), d["mask"], d["inv_w"], cfg)
    v_inv, g_pt, _ = point_normal(blocks.jp, blocks.r, d["lam"])
    return blocks.jc, blocks.jp, blocks.r, v_inv, g_pt


def check_route_kernels(problem) -> None:
    """Phase 4: B5-B8 against their plain versions, f32 and f64, on the
    buckets with their dense one-hot; then padded slots against NaN."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.ops._wtt_common import slot_index
    from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cfg = BAConfig()
    for dtype in (torch.float32, torch.float64):
        summed = TOL[dtype][1]
        tag = "f32" if dtype == torch.float32 else "f64"
        for bi, (d, bucket) in enumerate(zip(wtt_kernel_inputs(problem, dtype),
                                             problem.buckets)):
            g, tb, pc, w = d["shape"]
            b7 = (d["wcam"], d["tw"], tb)
            planes = lin.wtt_cam_planes_idx(*b7)
            errs = {"B7": compare("wtt_cam_planes_idx", tag, "", planes,
                                  lin.wtt_cam_planes_idx_plain(*b7), 0.0)}
            jc, jp, r, v_inv, g_pt = route_planes(d, planes, cfg)
            for use_sj in (True, False):
                b8 = (d["wcam"], jc, jp, r, v_inv, 8, w, use_sj)
                rows = lin.wtt_contrib_rows_idx(*b8)
                errs[f"B8 sj={int(use_sj)}"] = compare(
                    "wtt_contrib_rows_idx", tag, f"sj={int(use_sj)}", rows,
                    lin.wtt_contrib_rows_idx_plain(*b8), summed)
                if use_sj:
                    b8_sj, rows_sj = b8, rows
            b5 = (_sym3_matvec(v_inv, g_pt).contiguous(), d["wcam"], jc, jp, w)
            rows_b5 = mv.wtt_w_rows_idx(*b5)
            errs["B5"] = compare("wtt_w_rows_idx", tag, "", rows_b5,
                                 mv.wtt_w_rows_idx_plain(*b5), summed)
            onehots = [bucket.onehot] + ([bucket.onehot.to(dtype)] if tag == "f64" else [])
            for oh in onehots:
                b6 = (d["xw_t"], oh, jc, jp, v_inv)
                out_b6 = mv.wtt_coupling_rows_fused(*b6)
                errs[f"B6 {oh.dtype}"] = compare(
                    "wtt_coupling_rows_fused", tag, str(oh.dtype), out_b6,
                    mv.wtt_coupling_rows_fused_plain(*b6), summed)
            log(f"check {tag} wtt route bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}): "
                + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            if dtype != torch.float32:
                continue
            slots = g * tb * pc
            b6 = (d["xw_t"], bucket.onehot, jc, jp, v_inv)
            tw_t = torch.cat([d["tw"], d["tw"].new_zeros(g, 1, 19)], dim=1)
            tw_t = tw_t.transpose(1, 2).contiguous()
            idx = slot_index(d["wcam"], w)[:, None, :].expand(g, 19, tb * pc)
            account("wtt_cam_planes_idx", lambda: lin.wtt_cam_planes_idx(*b7),
                    lambda: lin.wtt_cam_planes_idx_plain(*b7),
                    nbytes(d["wcam"], d["tw"], planes), 0,
                    library=lambda: torch.gather(tw_t, 2, idx))
            account("wtt_contrib_rows_idx", lambda: lin.wtt_contrib_rows_idx(*b8_sj),
                    lambda: lin.wtt_contrib_rows_idx_plain(*b8_sj),
                    nbytes(*b8_sj[:5], rows_sj), FLOPS["wtt_contrib_rows_idx"] * slots)
            account("wtt_w_rows_idx", lambda: mv.wtt_w_rows_idx(*b5),
                    lambda: mv.wtt_w_rows_idx_plain(*b5),
                    nbytes(*b5[:4], rows_b5), FLOPS["wtt_w_rows_idx"] * slots)
            account("wtt_coupling_rows_fused", lambda: mv.wtt_coupling_rows_fused(*b6),
                    lambda: mv.wtt_coupling_rows_fused_plain(*b6),
                    nbytes(*b6, out_b6), FLOPS["wtt_coupling_rows_fused"] * slots)

        # Padded slots read exact zeros: window row 0 is NaN and only padded
        # slots point at it; jc/jp/r of padded slots are NaN for B5 and B8.
        d = wtt_kernel_inputs(problem, dtype)[0]
        g, tb, pc, w = d["shape"]
        wcam = torch.where(d["wcam"] == 0, torch.full_like(d["wcam"], -1), d["wcam"])
        pad = (wcam < 0).reshape(g, tb, pc)
        d = {**d, "wcam": wcam, "mask": d["mask"] * ~pad, "tw": d["tw"].clone()}
        d["tw"][:, 0] = float("nan")
        b7 = (wcam, d["tw"], tb)
        planes = lin.wtt_cam_planes_idx(*b7)
        compare("wtt_cam_planes_idx", tag, "poisoned", planes,
                lin.wtt_cam_planes_idx_plain(*b7), 0.0)
        jc, jp, r, v_inv, g_pt = (x.clone() for x in route_planes(d, planes, cfg))
        for x in (jc, jp, r):
            x[:, pad] = float("nan")
        b8 = (wcam, jc, jp, r, v_inv, 8, w, True)
        rows = lin.wtt_contrib_rows_idx(*b8)
        compare("wtt_contrib_rows_idx", tag, "poisoned", rows,
                lin.wtt_contrib_rows_idx_plain(*b8), summed)
        b5 = (_sym3_matvec(v_inv, g_pt).contiguous(), wcam, jc, jp, w)
        compare("wtt_w_rows_idx", tag, "poisoned", mv.wtt_w_rows_idx(*b5),
                mv.wtt_w_rows_idx_plain(*b5), summed)
        if not (torch.isfinite(planes).all() and torch.isfinite(rows).all()):
            raise AssertionError(f"{tag}: a poisoned padded slot reached an output")
        log(f"check {tag} wtt route: padded slots read exact zeros "
            f"({int(pad.sum())} padded slots, window row 0 NaN)")


def check_grid_kernels(grid) -> None:
    """Phase 6: B9-B11 against their plain versions, f32 and f64."""
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


def tt_kernel_inputs(problem, dtype, lam_value=1e-4):
    """Per-bucket tt kernel inputs at the initial parameters, cast to dtype."""
    from tpu3drecon_torch.solvers.ba_tt import _cam_table, _inv_w

    cams = problem.cameras
    dev = problem.points3d.device
    table = _cam_table(*(getattr(cams, f) for f in CAM_FIELDS)).to(dtype).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(problem.n_cameras, 8, generator=gen, dtype=torch.float64)
    out = []
    for bucket, off in zip(problem.buckets, problem.bucket_offsets):
        pb = bucket.mask.shape[1]
        out.append(dict(
            table=table, cam_ids=bucket.cam_ids,
            pts=problem.points3d[off : off + pb].T.contiguous().to(dtype),
            uv=bucket.uv.to(dtype), mask=bucket.mask.to(dtype),
            inv_w=_inv_w(problem, dtype),
            lam=torch.tensor(lam_value, dtype=dtype, device=dev),
            x=x.to(dev, dtype),
        ))
    return out


def check_tt_kernels(problem) -> None:
    """Phase 8: B12-B16 against their plain versions, f32 and f64."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import tt_linearize as tt
    from tpu3drecon_torch.solvers.ba_tt import _sym3_inv_planes, _sym3_matvec
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    c = problem.n_cameras
    for dtype in (torch.float32, torch.float64):
        elem, summed = TOL[dtype]
        tag = "f32" if dtype == torch.float32 else "f64"
        for bi, d in enumerate(tt_kernel_inputs(problem, dtype)):
            tb, pb = d["mask"].shape
            errs = {}
            for loss in (RobustLoss.TRIVIAL, RobustLoss.CAUCHY, RobustLoss.HUBER):
                cfg = BAConfig(loss=loss)
                b12_args = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"],
                            d["inv_w"], cfg, 8)
                got = tt.tt_cam_normal_fused(*b12_args)
                plain = tt.tt_cam_normal_fused_plain(*b12_args)
                errs[f"B12 {loss.value}"] = max(
                    compare("tt_cam_normal_fused", tag, name, a, b,
                            summed if name == "ug" else elem)
                    for name, a, b in zip(("jc", "jp", "v6", "g_pt", "ug"), got, plain))
                b16_args = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"],
                            d["inv_w"], cfg)
                cost = tt.tt_cost_fused(*b16_args)
                errs[f"B16 {loss.value}"] = compare(
                    "tt_cost_fused", tag, "", cost, tt.tt_cost_fused_plain(*b16_args), elem)
                if loss == RobustLoss.TRIVIAL:
                    b12_cfg, out_b12, want, cost_b16 = b12_args, got, plain, cost
            jc, jp, v6 = want[:3]
            damp = torch.stack([d["lam"] * torch.clamp(v6[k], min=1e-8) for k in (0, 3, 5)])
            v_inv = _sym3_inv_planes(torch.stack(
                [v6[0] + damp[0], v6[1], v6[2], v6[3] + damp[1], v6[4], v6[5] + damp[2]]))
            b13_args = (d["cam_ids"], d["mask"], jc, jp, v_inv, c)
            b14_args = (d["x"], d["cam_ids"], d["mask"], jc, jp)
            coup = tt.tt_coupling_fused(*b13_args)
            errs["B13"] = compare("tt_coupling_fused", tag, "", coup,
                                  tt.tt_coupling_fused_plain(*b13_args), summed)
            wtx = tt.tt_wt_times_fused(*b14_args)
            wtx_plain = tt.tt_wt_times_fused_plain(*b14_args)
            errs["B14"] = compare("tt_wt_times_fused", tag, "", wtx, wtx_plain, elem)
            b15_args = (_sym3_matvec(v_inv, wtx_plain).contiguous(), d["cam_ids"], d["mask"],
                        jc, jp, c)
            wy = tt.tt_w_times_fused(*b15_args)
            errs["B15"] = compare("tt_w_times_fused", tag, "", wy,
                                  tt.tt_w_times_fused_plain(*b15_args), summed)
            log(f"check {tag} tt bucket {bi} (Tb={tb} Pb={pb}): "
                + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            if dtype != torch.float32:
                continue
            slots = tb * pb
            account("tt_cam_normal_fused",
                    lambda: tt.tt_cam_normal_fused(*b12_cfg),
                    lambda: tt.tt_cam_normal_fused_plain(*b12_cfg),
                    nbytes(*b12_cfg[:6], *out_b12), FLOPS["tt_cam_normal_fused"] * slots)
            account("tt_coupling_fused",
                    lambda: tt.tt_coupling_fused(*b13_args),
                    lambda: tt.tt_coupling_fused_plain(*b13_args),
                    nbytes(*b13_args[:5], coup), FLOPS["tt_coupling_fused"] * slots)
            account("tt_wt_times_fused",
                    lambda: tt.tt_wt_times_fused(*b14_args),
                    lambda: tt.tt_wt_times_fused_plain(*b14_args),
                    nbytes(*b14_args, wtx), FLOPS["tt_wt_times_fused"] * slots)
            account("tt_w_times_fused",
                    lambda: tt.tt_w_times_fused(*b15_args),
                    lambda: tt.tt_w_times_fused_plain(*b15_args),
                    nbytes(*b15_args[:5], wy), FLOPS["tt_w_times_fused"] * slots)
            b16_args = b12_cfg[:7]
            account("tt_cost_fused",
                    lambda: tt.tt_cost_fused(*b16_args),
                    lambda: tt.tt_cost_fused_plain(*b16_args),
                    nbytes(*b16_args[:6], cost_b16), FLOPS["tt_cost_fused"] * slots)


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
    mine = {name for *_, name, _, _, paths in KERNELS if path in paths}
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
        build_tt_problem,
    )
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.problems.wtt import wtt_from_flat
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt
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
        WTT, lambda p, **kw: ba_solve_wtt(p, wtt_config._replace(**kw)), wtt, flat, 5
    )

    def first_path(counts):
        for name, n in counts.items():
            launches.setdefault(name, n)

    t0 = time.perf_counter()
    wtt_oh = wtt_from_flat(flat, defer_onehot=False, device=dev)
    log(f"wtt packed with its int8 one-hot in {time.perf_counter() - t0:.1f} s: "
        + str([tuple(b.onehot.shape) for b in wtt_oh.buckets]))
    check_route_kernels(wtt_oh)
    for route, matvec in ((UNFUSED, "index"), (ONEHOT, "fused")):
        cfg = BENCH_CONFIG._replace(matvec_kernel=matvec, linearize_kernel=False)
        first_path(drive(
            route, lambda p, cfg=cfg, **kw: ba_solve_wtt(p, cfg._replace(**kw)),
            wtt_oh, flat, 3,
        ))
    del wtt_oh

    t0 = time.perf_counter()
    grid = build_grid_problem(dev, torch.float32)
    log(f"grid problem: (C, K) = {tuple(grid.mask.shape)}, "
        f"P_pad = {grid.points3d.shape[0]}, built and packed in "
        f"{time.perf_counter() - t0:.1f} s; track buckets (Pb, Tb): "
        + str([tuple(b.track_idx.shape) for b in grid.buckets]))
    check_grid_kernels(grid)
    first_path(drive(
        "grid", lambda p, **kw: ba_solve_pallas(p, BENCH_CONFIG._replace(**kw)),
        grid, flat, 3,
    ))

    t0 = time.perf_counter()
    tt = build_tt_problem(dev, torch.float32)
    log(f"tt problem: C = {tt.n_cameras}, P_pad = {tt.points3d.shape[0]}, built and "
        f"packed in {time.perf_counter() - t0:.1f} s; buckets (Tb, Pb): "
        + str([tuple(b.mask.shape) for b in tt.buckets]))
    check_tt_kernels(tt)
    first_path(drive(
        "tt", lambda p, **kw: ba_solve_tt(p, BENCH_CONFIG._replace(**kw)), tt, flat, 3,
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
            library_ms=r["library_ms"],
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
