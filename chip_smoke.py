#!/usr/bin/env python3
"""Run the PyTorch port's medium and BAL-scale bundle-adjustment solves once on
one CUDA GPU.

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
   int8 one-hot and with the same one-hot in the data's float type; then on the
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
9. The tt path: ``ba_solve_tt(kernels="full")`` (kernels B12-B16) on the
   same problem with the same config: one warm-up solve and 3 timed solves.
10. Padded slots and the global-memory mode: every kernel that reads
    camera rows or x by index or reduces into rows (B1, B1 od, B2-B6, B8,
    B8 od, B12-B16) against its plain version on the medium wtt and tt
    buckets, in float32 and float64, with the padded slots poisoned (window
    row 0 NaN and only padded slots on it, NaN jc/jp/r on padded slots for
    B5 and B8, an extra NaN camera carried only by padded tt slots); B15,
    which keeps a block-shared tile at small camera counts, also with the
    global-memory mode forced (``_mode``), whose f32 time is its
    ``global_ms``.
11. The BAL-scale sequential problem: ``bal_sequential_wtt`` (1712
    cameras, 999,808 points, 3,808,166 observations, f32) built on the
    card, its build time and buckets logged.
12. B1 and B8 with ``want_od`` against their plain versions on the BAL
    buckets: f32, where they are timed beside B1 and B8 without od, and f64
    with window row 0 and the padded slots' planes NaN.  Then the
    reduced-fidelity kernels against their plain versions at the same
    terms, f32, with window row 0 of the camera rows and of x NaN: B2 at
    terms 1 and 2 and B1 at terms 2 on the medium buckets (timed there
    beside the exact B2 and B1), B2 at terms 1 and 2 and B1 at terms 2 with
    and without od on the BAL buckets (B1 od timed there).
13. The BAL paths, with the JAX suite's BAL solver config (8 CG
    iterations, ``cg_rtol`` 0, f32): ``bal_seq`` (fully indexed,
    Schur-Jacobi) and ``bal_seq_ssor`` (fully indexed, block SSOR, B1 od)
    at 3 and 12 LM iterations, one warm-up solve and 3 timed solves each,
    with the marginal s/LM-iter (w12 - w3) / 9; ``bal_seq_tridiag_unfused``
    (``linearize_kernel=False``, ``matvec_kernel="index"``, block
    tridiagonal, B8 od) on the packing with its dense int8 one-hot, at 6
    LM iterations (its first three steps are rejected), one warm-up and 2
    timed solves; then B1 od, B2 and B3 at np = 10 (``optimize_dist``)
    checked on the BAL buckets and ``bal_seq_ssor_np10`` (block SSOR with
    ``optimize_dist``) at 3 LM iterations, one warm-up and 2 timed solves.
    The probes E2 (``experiments.index_matvec3``: B2 at terms 3, 2 and 1
    and the PyTorch plane matvec against float64 rows, device ms per
    matvec) and E1 (``experiments.index_matvec2``: B2's copy at 128, 256
    and 512 threads per block, without the gather, without the atomics)
    run on these buckets.
14. The split-window packing of the same problem
    (``bal_sequential_wtt(split_windows=True)``, the JAX suite's TPU BAL
    cell), its build time and buckets (G, Tb, Pc, W, global tiles,
    global_tile0) logged: ``bal_seq_split`` (fully indexed),
    ``bal_seq_split_index2`` (matvec and linearize ``index2``) and
    ``bal_seq_split_index1`` (matvec ``index1``, linearize ``index``) at 3
    and 12 LM iterations, one warm-up and 3 timed solves each, with their
    marginals; ``bal_seq_split_index2_ssor`` (``index2``/``index2`` under
    block SSOR: B1 od at 2 terms) at 3 iterations, one warm-up and 1 timed.
15. The BAL hub problem: ``bal_hub_wtt`` (1712 cameras, 5 % hubs of 4000
    observations, packed with global camera tiles) built on the card, its
    buckets (G, Tb, Pc, W, global tiles) logged; the band preconditioners
    must raise JAX's hub ``ValueError``; B1 and B4 checked on its buckets
    (f32), each mode and time printed;
    ``bal_hub`` (fully indexed, Schur-Jacobi, the BAL config) at 3 and 12
    LM iterations, one warm-up and 3 timed solves each, and its marginal.
    Then its split packing (``bal_hub_wtt(split_windows=True)``), buckets
    and build time logged, the band preconditioners must raise there too,
    and ``bal_hub_split`` (fully indexed) at 3 and 12 iterations, 1 + 3.
16. ``tt_seq1024``: a sequential scene of 1024 cameras and 256 points per
    camera (seed 7, perturbed with seed 8 and 0.5 px noise) packed by
    ``tt_from_flat`` (f32), its counts logged; B12-B16 checked on its
    buckets, each mode printed; solved with the BAL config at 3 LM
    iterations on ``kernels="full"`` (Schur-Jacobi) and on JAX's default
    route ``kernels=False`` under block SSOR (``tt_seq1024_ssor``, no port
    kernel), one warm-up and 2 timed solves each.
    Each BAL, hub and tt_seq1024 solve must end finite and below its
    initial loss with at least one accepted step.
17. The probes E3 (``experiments.term_stack``: B2 against its plain
    version at terms 3 and 1 on E3's random inputs) and E4
    (``experiments.bits_expand``: both unpack layouts against numpy; its
    counts set to 0 before and read after, as a path's).
18. Prints the kernel table as one JSON line, the ``nvidia-smi`` line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); summed outputs 1e-4 and 1e-10 (B1, B2, B5, B6 and B8 rows,
B12's U|g columns, B13 and B15 are atomic sums whose order varies; B9's U
and g and B11's blocks are block reductions in another order than the
plain version's); B7 (a selection) exactly.  Each row of the kernel table
gives its ``mode``: the memory mode its wrapper counted during the timed
calls of its ``ms`` (``global``; ``shared`` for B15 on the medium buckets,
whose (C, np) tile has at most 2,048 entries; none for B7, B9-B11 and E4,
which have no mode), which must match the row's label; B15's row adds
``global_ms``, the same inputs' time with the global-memory mode forced.
The rows ``B1 [hub]`` (the hub buckets), ``B1 od [np=10]`` (the BAL buckets
with ``optimize_dist``), ``B12 [C=1024]``, ``B13 [C=1024]``, ``B14
[C=1024]`` and ``B15 [C=1024]`` (tt_seq1024, B15 there in its global mode)
time those kernels
at the widths that a shared tile could not hold or does not serve, and
count their launches on those paths.  The
rows ``B2 [terms 1]``, ``B2 [terms 2]`` and ``B1 [terms 2]`` (medium
buckets) and ``B1 od [terms 2]`` (BAL buckets) time the reduced-fidelity
kernels and count their launches on the split paths that run them; ``E4
A`` / ``E4 B`` count theirs in the E4 phase.
Kernel and plain
times (``ms``, ``plain_ms``) are device times
(``tpu3drecon_torch.benchmark.timing.device_ms``): the median
of 20 calls, each with a cold L2 and timed by a CUDA-event pair that sees
none of the call's host time, summed over one pass of the solve (the five
buckets, or one linearization).  ``ms`` covers all the device work of the
wrapper: the kernel, and for B9 the packing of the camera rows (as in the
JAX function), for B16 the sum of its per-point partials.  B7's
``library_ms`` is the same device time of the one ``torch.gather`` that
computes its function; no other kernel has such a call.  Every count is
set to 0 just before each path's solves (each of its iteration counts)
and read just after: each path must launch each of its kernels and call no
plain version.  A kernel on several paths takes its table ``launches``
from the first; every path's counts are on its ``solve`` lines.  Each
medium solve must reach a reprojection RMSE below 1e-3 px and a final
loss below the initial one; a BAL solve (3 or 12 LM iterations from a
perturbation of the whole scene) only the latter, and its RMSE is printed.

``bound_ms`` is the least time the card could take for the same work: the
larger of the bytes the function must move (each input read once, each
output written once, f32, from this run's tensors) over 3.35 TB/s and its
operations (counted per slot or lane from the kernel source, ``FLOPS``;
for the od rows also per adjacent slot pair of this run's data) over 67
TFLOP/s of float32.
"""

from __future__ import annotations

import importlib
import json
import statistics
import sys
import time

import torch

from tpu3drecon_torch.benchmark.timing import HBM_BYTES_PER_S, card_line, device_ms, nbytes

WTT_SRC = "tpu3drecon_torch/csrc/wtt_kernels.cu"
TERMS_SRC = "tpu3drecon_torch/csrc/wtt_terms_kernels.cu"
ROUTE_SRC = "tpu3drecon_torch/csrc/wtt_route_kernels.cu"
GRID_SRC = "tpu3drecon_torch/csrc/grid_kernels.cu"
TT_SRC = "tpu3drecon_torch/csrc/tt_kernels.cu"
PROBE_SRC = "tpu3drecon_torch/csrc/probe_kernels.cu"
LIN_PY = "tpu3drecon/ops/pallas/wtt_linearize.py"
MV_PY = "tpu3drecon/ops/pallas/wtt_matvec.py"
TT_PY = "tpu3drecon/ops/pallas/tt_linearize.py"
# The paths: wtt's fully indexed route, its unfused route (a) and its
# one-hot route (c), the grid engine, the dense track table; at BAL scale
# wtt fully indexed under Schur-Jacobi and block SSOR, and the unfused
# route under the block-tridiagonal preconditioner.
WTT, UNFUSED, ONEHOT = "wtt", "wtt_unfused", "wtt_onehot"
BAL, BAL_SSOR, BAL_TRI = "bal_seq", "bal_seq_ssor", "bal_seq_tridiag_unfused"
# The inputs that a shared-memory tile could not hold: the BAL hub problem
# (fully indexed, Schur-Jacobi), the BAL sequential problem with
# optimize_dist under block SSOR (np = 10), and a 1024-camera track table on
# both tt routes (fully fused, and JAX's default XLA route under block SSOR).
HUB, NP10 = "bal_hub", "bal_seq_ssor_np10"
TT1024, TT1024_SSOR = "tt_seq1024", "tt_seq1024_ssor"
# The split-window BAL packings (the JAX suite's TPU BAL cell packs this
# way): fully indexed, the reduced-fidelity modes (matvec index2 with
# linearize index2, matvec index1 with linearize index, and index2/index2
# under block SSOR, whose B1 od rows run at 2 terms), and the split hub.
SPLIT, SPLIT2, SPLIT1 = "bal_seq_split", "bal_seq_split_index2", "bal_seq_split_index1"
SPLIT2_SSOR, HUB_SPLIT = "bal_seq_split_index2_ssor", "bal_hub_split"
E4 = "E4 probe"
SHARED, GLOBAL = "shared", "global"  # tpu3drecon_torch.ops._build's modes
# (module under tpu3drecon_torch, counter attribute, kernel name, source,
# replaced TPU kernel, paths, the memory mode of its ms: the kernels read
# camera rows from device memory and reduce into the output rows directly,
# B15 into a block-shared tile at small camera counts, B7, B9-B11 and E4
# have no mode)
ALL_SPLIT = {SPLIT, SPLIT2, SPLIT1, SPLIT2_SSOR, HUB_SPLIT}
KERNELS = (
    ("ops.wtt_linearize", "COUNTS", "wtt_linearize_fused_idx", WTT_SRC, f"{LIN_PY}:554",
     {WTT, BAL, HUB, SPLIT, SPLIT1, HUB_SPLIT}, GLOBAL),
    ("ops.wtt_matvec", "COUPLING_COUNTS", "wtt_coupling_rows_idx", WTT_SRC, f"{MV_PY}:215",
     {WTT, UNFUSED, BAL, BAL_SSOR, BAL_TRI, HUB, NP10, SPLIT, HUB_SPLIT}, GLOBAL),
    ("ops.wtt_matvec", "WT_COUNTS", "wtt_wt_planes_idx", WTT_SRC, f"{MV_PY}:405",
     {WTT, UNFUSED, BAL, BAL_SSOR, BAL_TRI, HUB, NP10} | ALL_SPLIT, GLOBAL),
    ("ops.wtt_cost", "COUNTS", "wtt_cost_cols_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_cost.py:94", {WTT, BAL, BAL_SSOR, HUB, NP10} | ALL_SPLIT,
     GLOBAL),
    ("ops.wtt_matvec", "W_ROWS_COUNTS", "wtt_w_rows_idx", ROUTE_SRC, f"{MV_PY}:468",
     {UNFUSED, BAL_TRI}, GLOBAL),
    ("ops.wtt_matvec", "FUSED_COUNTS", "wtt_coupling_rows_fused", ROUTE_SRC, f"{MV_PY}:526",
     {ONEHOT}, GLOBAL),
    ("ops.wtt_linearize", "CAM_PLANES_COUNTS", "wtt_cam_planes_idx", ROUTE_SRC,
     f"{LIN_PY}:229", {UNFUSED, ONEHOT, BAL_TRI}, None),
    ("ops.wtt_linearize", "CONTRIB_COUNTS", "wtt_contrib_rows_idx", ROUTE_SRC,
     f"{LIN_PY}:286", {UNFUSED, ONEHOT}, GLOBAL),
    ("ops.cam_normal", "COUNTS", "cam_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/cam_normal.py:205", {"grid"}, None),
    ("ops.point_normal", "COUNTS", "point_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/point_normal.py:80", {"grid"}, None),
    ("ops.coupling", "COUNTS", "coupling_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/coupling.py:65", {"grid"}, None),
    ("ops.tt_linearize", "CAM_COUNTS", "tt_cam_normal_fused", TT_SRC, f"{TT_PY}:221",
     {"tt", TT1024}, GLOBAL),
    ("ops.tt_linearize", "COUPLING_COUNTS", "tt_coupling_fused", TT_SRC, f"{TT_PY}:297",
     {"tt", TT1024}, GLOBAL),
    ("ops.tt_linearize", "WT_COUNTS", "tt_wt_times_fused", TT_SRC, f"{TT_PY}:436",
     {"tt", TT1024}, GLOBAL),
    ("ops.tt_linearize", "W_COUNTS", "tt_w_times_fused", TT_SRC, f"{TT_PY}:475",
     {"tt", TT1024}, SHARED),
    ("ops.tt_linearize", "COST_COUNTS", "tt_cost_fused", TT_SRC, f"{TT_PY}:512",
     {"tt", TT1024}, GLOBAL),
    # B1's and B8's want_od branches (the band pair rows of ssor/tridiag).
    ("ops.wtt_linearize", "OD_COUNTS", "B1 od", WTT_SRC, f"{LIN_PY}:515", {BAL_SSOR, NP10},
     GLOBAL),
    ("ops.wtt_linearize", "CONTRIB_OD_COUNTS", "B8 od", ROUTE_SRC, f"{LIN_PY}:163",
     {BAL_TRI}, GLOBAL),
    # B1, B1 od, B12 and B13 at the widths that a shared tile could not
    # hold, B14 on the same 1024-camera track table, and B15 at the camera
    # count where it takes its global mode.
    ("ops.wtt_linearize", "COUNTS", "B1 [hub]", WTT_SRC, f"{LIN_PY}:554", {HUB}, GLOBAL),
    ("ops.wtt_linearize", "OD_COUNTS", "B1 od [np=10]", WTT_SRC, f"{LIN_PY}:515", {NP10},
     GLOBAL),
    ("ops.tt_linearize", "CAM_COUNTS", "B12 [C=1024]", TT_SRC, f"{TT_PY}:221", {TT1024},
     GLOBAL),
    ("ops.tt_linearize", "COUPLING_COUNTS", "B13 [C=1024]", TT_SRC, f"{TT_PY}:297", {TT1024},
     GLOBAL),
    ("ops.tt_linearize", "WT_COUNTS", "B14 [C=1024]", TT_SRC, f"{TT_PY}:436", {TT1024},
     GLOBAL),
    ("ops.tt_linearize", "W_COUNTS", "B15 [C=1024]", TT_SRC, f"{TT_PY}:475", {TT1024},
     GLOBAL),
    # The reduced-fidelity branches: B2 at terms 1 and 2, B1 (and B1 od) at
    # terms 2, on the split BAL paths that run them.
    ("ops.wtt_matvec", "COUPLING1_COUNTS", "B2 [terms 1]", TERMS_SRC, f"{MV_PY}:215",
     {SPLIT1}, GLOBAL),
    ("ops.wtt_matvec", "COUPLING2_COUNTS", "B2 [terms 2]", TERMS_SRC, f"{MV_PY}:215",
     {SPLIT2, SPLIT2_SSOR}, GLOBAL),
    ("ops.wtt_linearize", "TERMS2_COUNTS", "B1 [terms 2]", TERMS_SRC, f"{LIN_PY}:554",
     {SPLIT2}, GLOBAL),
    ("ops.wtt_linearize", "TERMS2_OD_COUNTS", "B1 od [terms 2]", TERMS_SRC, f"{LIN_PY}:515",
     {SPLIT2_SSOR}, GLOBAL),
    # E4's two unpack kernels, launched by the E4 probe phase.
    ("experiments.bits_expand", "LAYOUT_A_COUNTS", "E4 A", PROBE_SRC,
     "experiments/tpu_bits_expand_probe.py:51", {E4}, None),
    ("experiments.bits_expand", "LAYOUT_B_COUNTS", "E4 B", PROBE_SRC,
     "experiments/tpu_bits_expand_probe.py:51", {E4}, None),
)
# The kernel that keeps a shared-memory mode beside the global one: its row
# adds global_ms, the time of the same inputs with the global mode forced.
TWO_MODES = ("tt_w_times_fused",)
TOL = {  # (per-element, summed) bounds relative to max|plain|
    torch.float32: (1e-5, 1e-4),
    torch.float64: (1e-12, 1e-10),
}
F32_FLOPS_PER_S = 67e12
# Float operations per unit of work, counted from csrc/*.cu: per slot
# (Tb * Pc per bucket) for B1-B8 and B12-B16 (np = 8, atomic adds
# included; B8 with the Schur-Jacobi columns: 108 u + 24 g + 72 W + 120 WV
# + 180 coupling + 80 adds; B7 is a copy; B6's one-hot scan compares bytes,
# no float operation), per grid lane (C * K) for B9 and B11, per track row
# (P * T2) plus per point for B10.  The od rows add, per adjacent slot
# pair, np^2 outputs of 3 multiplies and 2 adds and their atomic adds.
FLOPS = {
    "wtt_linearize_fused_idx": 1000, "wtt_coupling_rows_idx": 80,
    "wtt_wt_planes_idx": 44, "wtt_cost_cols_idx": 45,
    "wtt_w_rows_idx": 42, "wtt_coupling_rows_fused": 80, "wtt_cam_planes_idx": 0,
    "wtt_contrib_rows_idx": 584,
    "cam_normal_fused": 340, "point_normal_row": 18, "point_normal_point": 60,
    "coupling_fused": 408,
    "tt_cam_normal_fused": 370, "tt_coupling_fused": 408, "tt_wt_times_fused": 44,
    "tt_w_times_fused": 42, "tt_cost_fused": 51,
    "od_pair": 64 * 6,
    # split_round at 2 terms: 3 float operations per rounded value (np x and
    # np z values per slot for B2, the 80 u | g | coupling values per slot and
    # the 64 od values per pair for B1); at 1 term none.
    "B2 [terms 1]": 80, "B2 [terms 2]": 80 + 16 * 3, "B1 [terms 2]": 1000 + 80 * 3,
    "od_pair_terms2": 64 * 6 + 64 * 3,
}
CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


def log(msg: str) -> None:
    print(msg, flush=True)


def counters():
    """kernel name -> its wrapper's launch counter."""
    return {
        name: getattr(importlib.import_module(f"tpu3drecon_torch.{mod}"), attr)
        for mod, attr, name, *_ in KERNELS
    }


def mode_of(counter, before: dict) -> str:
    """The memory modes of a wrapper's launches since ``before`` (a copy
    of its ``modes``)."""
    return "+".join(sorted(m for m, n in counter.modes.items() if n > before.get(m, 0)))


RESULTS = {  # kernel -> measured and counted figures of this run
    name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0,
           "library_ms": None, "global_ms": 0.0, "modes": set()}
    for _, _, name, *_ in KERNELS
}


def timed(kernel: str, fn) -> float:
    """``device_ms(fn)``, where ``fn`` calls the wrapper of row ``kernel``;
    the memory modes that wrapper counted meanwhile join the row's
    ``modes``."""
    counter = counters()[kernel]
    before = dict(counter.modes)
    ms = device_ms(fn)
    mode = mode_of(counter, before)
    if mode:
        RESULTS[kernel]["modes"].add(mode)
    return ms


def time_global_ms(kernel: str, fn) -> None:
    """Adds the device time of ``fn(_mode=GLOBAL)`` (B15 forced into its
    global-memory mode) to the row's ``global_ms``."""
    counter = counters()[kernel]
    before = dict(counter.modes)
    RESULTS[kernel]["global_ms"] += device_ms(lambda: fn(_mode=GLOBAL))
    if mode_of(counter, before) != GLOBAL:
        raise AssertionError(f"{kernel}: the forced calls ran in {mode_of(counter, before)}")
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
    r["ms"] += timed(kernel, fn)
    r["plain_ms"] += device_ms(plain)
    r["bytes"] += n_bytes
    r["flops"] += flops
    if library is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + device_ms(library)


def wtt_kernel_inputs(problem, dtype, lam_value=1e-4, np_cam=8):
    """Per-bucket wtt kernel inputs at the initial parameters, cast to dtype
    (x with ``np_cam`` columns)."""
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
        x = torch.randn(problem.c_pad, np_cam, generator=gen, dtype=torch.float64)
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


def poisoned(d):
    """``d`` (one bucket of ``wtt_kernel_inputs``) with every slot on window
    row 0 made a padded slot (-1, mask 0) and row 0 set to NaN: a kernel that
    read row 0 for a padded slot would give NaN where the plain version
    gives exact zeros.  Returns (inputs, padded-slot mask (G, Tb, Pc))."""
    g, tb, pc, _ = d["shape"]
    wcam = torch.where(d["wcam"] == 0, torch.full_like(d["wcam"], -1), d["wcam"])
    pad = (wcam < 0).reshape(g, tb, pc)
    d = {**d, "wcam": wcam, "mask": d["mask"] * ~pad, "tw": d["tw"].clone()}
    d["tw"][:, 0] = float("nan")
    return d, pad


def nan_on(pad, *planes):
    """Copies of (K, G, Tb, Pc) planes with the padded slots set to NaN."""
    out = tuple(x.clone() for x in planes)
    for x in out:
        x[:, pad] = float("nan")
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
            for oh in (bucket.onehot, bucket.onehot.to(dtype)):
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
        d, pad = poisoned(wtt_kernel_inputs(problem, dtype)[0])
        g, tb, pc, w = d["shape"]
        wcam = d["wcam"]
        b7 = (wcam, d["tw"], tb)
        planes = lin.wtt_cam_planes_idx(*b7)
        compare("wtt_cam_planes_idx", tag, "poisoned", planes,
                lin.wtt_cam_planes_idx_plain(*b7), 0.0)
        jc, jp, r, v_inv, g_pt = route_planes(d, planes, cfg)
        jc, jp, r = nan_on(pad, jc, jp, r)
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


def adjacent_pairs(wcam, g: int, tb: int, pc: int) -> int:
    """Slot pairs (t-1, t) of one track on window rows (w, w + 1): the od
    rows' work in this run's data."""
    w = wcam.reshape(g, tb, pc).long()
    return int(((w[:, :-1] >= 0) & (w[:, 1:] == w[:, :-1] + 1)).sum())


def check_od_kernels(bal) -> None:
    """Phase 12: B1 and B8 with want_od against their plain versions on the
    BAL buckets: f32 (timed there, beside B1 and B8 without od), and f64
    with NaN where only padded slots read (rows of 350,360 and 294,912
    bytes per group, which no shared tile of the card could hold)."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cfg = BAConfig()
    lin_outs = ("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt")
    elem, summed = TOL[torch.float32]
    plain_od = {"B1": 0.0, "B8": 0.0}  # device ms per pass without the od rows
    for bi, d in enumerate(wtt_kernel_inputs(bal, torch.float32)):
        g, tb, pc, w = d["shape"]
        lin_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"],
                    d["inv_w"], cfg, 8, True, True)
        got = lin.wtt_linearize_fused_idx(*lin_args)
        err_b1 = max(compare("B1 od", "f32", k, a, b, summed if k == "rows" else elem)
                     for k, a, b in zip(lin_outs, got,
                                        lin.wtt_linearize_fused_idx_plain(*lin_args)))
        jc, jp, r, v_inv, _ = route_planes(d, lin.wtt_cam_planes_idx(d["wcam"], d["tw"], tb),
                                           cfg)
        b8 = (d["wcam"], jc, jp, r, v_inv, 8, w, True, True)
        rows = lin.wtt_contrib_rows_idx(*b8)
        err_b8 = compare("B8 od", "f32", "", rows, lin.wtt_contrib_rows_idx_plain(*b8), summed)
        pairs = adjacent_pairs(d["wcam"], g, tb, pc)
        log(f"check f32 od BAL bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, {pairs} pairs): "
            f"B1 od {err_b1:.3e} B8 od {err_b8:.3e}")
        slots = g * tb * pc
        account("B1 od", lambda: lin.wtt_linearize_fused_idx(*lin_args),
                lambda: lin.wtt_linearize_fused_idx_plain(*lin_args),
                nbytes(*lin_args[:7], *got),
                FLOPS["wtt_linearize_fused_idx"] * slots + FLOPS["od_pair"] * pairs)
        account("B8 od", lambda: lin.wtt_contrib_rows_idx(*b8),
                lambda: lin.wtt_contrib_rows_idx_plain(*b8), nbytes(*b8[:5], rows),
                FLOPS["wtt_contrib_rows_idx"] * slots + FLOPS["od_pair"] * pairs)
        plain_od["B1"] += device_ms(lambda: lin.wtt_linearize_fused_idx(*lin_args[:-1]))
        plain_od["B8"] += device_ms(lambda: lin.wtt_contrib_rows_idx(*b8[:-1]))
    log(f"od rows on the BAL buckets, device ms per pass (f32, cold L2): "
        f"B1 {plain_od['B1']:.6f} -> B1 od {RESULTS['B1 od']['ms']:.6f}, "
        f"B8 {plain_od['B8']:.6f} -> B8 od {RESULTS['B8 od']['ms']:.6f}")

    elem, summed = TOL[torch.float64]
    for bi, d in enumerate(wtt_kernel_inputs(bal, torch.float64)):
        d, pad = poisoned(d)
        g, tb, pc, w = d["shape"]
        wcam = d["wcam"]
        lin_args = (wcam, d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"], cfg,
                    8, True, True)
        got = lin.wtt_linearize_fused_idx(*lin_args)
        err_b1 = max(compare("B1 od", "f64", k, a, b, summed if k == "rows" else elem)
                     for k, a, b in zip(lin_outs, got,
                                        lin.wtt_linearize_fused_idx_plain(*lin_args)))
        planes = lin.wtt_cam_planes_idx(wcam, d["tw"], tb)
        jc, jp, r, v_inv, _ = route_planes(d, planes, cfg)
        jc, jp, r = nan_on(pad, jc, jp, r)
        b8 = (wcam, jc, jp, r, v_inv, 8, w, True, True)
        rows = lin.wtt_contrib_rows_idx(*b8)
        err_b8 = compare("B8 od", "f64", "poisoned", rows,
                         lin.wtt_contrib_rows_idx_plain(*b8), summed)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(rows).all()):
            raise AssertionError("f64 od: a poisoned padded slot reached an output")
        log(f"check f64 od BAL bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, "
            f"{adjacent_pairs(wcam, g, tb, pc)} pairs, {int(pad.sum())} padded slots, "
            f"window row 0 NaN): B1 od {err_b1:.3e} B8 od {err_b8:.3e}")


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


def tt_follower_args(d, b12_plain, n_cams: int):
    """The arguments of B13, B14 and B15 on one tt bucket ``d`` (of
    ``tt_kernel_inputs``), from B12's plain outputs there: damped V^-1 at
    the bucket's lam, B14 on its x, B15 on V^-1 W^T x."""
    from tpu3drecon_torch.ops import tt_linearize as tt
    from tpu3drecon_torch.solvers.ba_tt import _sym3_inv_planes, _sym3_matvec

    jc, jp, v6 = b12_plain[:3]
    damp = torch.stack([d["lam"] * torch.clamp(v6[k], min=1e-8) for k in (0, 3, 5)])
    v_inv = _sym3_inv_planes(torch.stack(
        [v6[0] + damp[0], v6[1], v6[2], v6[3] + damp[1], v6[4], v6[5] + damp[2]]))
    b13 = (d["cam_ids"], d["mask"], jc, jp, v_inv, n_cams)
    b14 = (d["x"], d["cam_ids"], d["mask"], jc, jp)
    y = _sym3_matvec(v_inv, tt.tt_wt_times_fused_plain(*b14)).contiguous()
    return b13, b14, (y, d["cam_ids"], d["mask"], jc, jp, n_cams)


def check_tt_followers(tag: str, output: str, b13, b14, b15, errs: dict):
    """B13, B14 and B15 against their plain versions (errors into
    ``errs``); returns their outputs."""
    from tpu3drecon_torch.ops import tt_linearize as tt

    elem, summed = TOL[b14[0].dtype]
    coup = tt.tt_coupling_fused(*b13)
    errs["B13"] = compare("tt_coupling_fused", tag, output, coup,
                          tt.tt_coupling_fused_plain(*b13), summed)
    wtx = tt.tt_wt_times_fused(*b14)
    errs["B14"] = compare("tt_wt_times_fused", tag, output, wtx,
                          tt.tt_wt_times_fused_plain(*b14), elem)
    wy = tt.tt_w_times_fused(*b15)
    errs["B15"] = compare("tt_w_times_fused", tag, output, wy,
                          tt.tt_w_times_fused_plain(*b15), summed)
    return coup, wtx, wy


def check_tt_kernels(problem) -> None:
    """Phase 8: B12-B16 against their plain versions, f32 and f64."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import tt_linearize as tt
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
            b13_args, b14_args, b15_args = tt_follower_args(d, want, c)
            coup, wtx, wy = check_tt_followers(tag, "", b13_args, b14_args, b15_args, errs)
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


def check_poisoned(kernel: str, tag: str, output: str, fn, plain, rel,
                   time_global: bool = False) -> float:
    """``fn()`` against ``plain()`` on inputs with poisoned padded slots:
    outputs finite and within ``rel``.  For B15 also
    ``fn(_mode=GLOBAL)``, and with ``time_global`` that call's device time
    is added to the kernel's ``global_ms``.  Returns the largest
    max|diff|."""
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    calls = [("", fn)]
    if kernel in TWO_MODES:
        calls.append((" global", lambda: fn(_mode=GLOBAL)))
    err = 0.0
    for label, call in calls:
        got = call()
        got = got if isinstance(got, tuple) else (got,)
        for name, a, b in zip(output.split(","), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{kernel} {tag}{label} {name}: a non-finite output")
            err = max(err, compare(kernel, f"{tag} poisoned{label}", name, a, b,
                                   rel[name] if isinstance(rel, dict) else rel))
    if time_global:
        time_global_ms(kernel, fn)
    return err


def check_padded_slots(wtt, tt) -> None:
    """Phase 10: every kernel that reads camera rows or x by index or
    reduces into rows against its plain version on the medium buckets, f32
    and f64, with the padded slots poisoned (window row 0 NaN and only
    padded slots on it; NaN jc/jp/r on padded slots for B5 and B8; for the
    tt kernels an extra NaN camera that only padded slots carry); B15 also
    in its forced global-memory mode, whose f32 device time per pass is its
    ``global_ms``."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.ops import tt_linearize as tt_ops
    from tpu3drecon_torch.ops import wtt_cost
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    assert (SHARED, GLOBAL) == (_build.SHARED, _build.GLOBAL)
    cfg = BAConfig()
    lin_outs = "rows,jc,jp,v_inv,g_pt,damp_pt"
    for dtype in (torch.float32, torch.float64):
        elem, summed = TOL[dtype]
        lin_tol = {k: summed if k == "rows" else elem for k in lin_outs.split(",")}
        tag = "f32" if dtype == torch.float32 else "f64"
        t = dtype == torch.float32
        for bi, d in enumerate(wtt_kernel_inputs(wtt, dtype)):
            d, pad = poisoned(d)
            g, tb, pc, w = d["shape"]
            wcam, errs = d["wcam"], {}
            for od, name in ((False, "wtt_linearize_fused_idx"), (True, "B1 od")):
                args = (wcam, d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
                        cfg, 8, True, od)
                errs[name] = check_poisoned(
                    name, tag, lin_outs, lambda args=args: lin.wtt_linearize_fused_idx(*args),
                    lambda args=args: lin.wtt_linearize_fused_idx_plain(*args), lin_tol)
            _, jc, jp, v_inv, g_pt, _ = lin.wtt_linearize_fused_idx_plain(*args)
            b2 = (d["xw_t"], wcam, jc, jp, v_inv)
            errs["B2"] = check_poisoned(
                "wtt_coupling_rows_idx", tag, "rows", lambda: mv.wtt_coupling_rows_idx(*b2),
                lambda: mv.wtt_coupling_rows_idx_plain(*b2), summed)
            errs["B3"] = check_poisoned(
                "wtt_wt_planes_idx", tag, "planes", lambda: mv.wtt_wt_planes_idx(*b2[:4]),
                lambda: mv.wtt_wt_planes_idx_plain(*b2[:4]), elem)
            b4 = (wcam, d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.TRIVIAL)
            errs["B4"] = check_poisoned(
                "wtt_cost_cols_idx", tag, "cols", lambda: wtt_cost.wtt_cost_cols_idx(*b4),
                lambda: wtt_cost.wtt_cost_cols_idx_plain(*b4), elem)
            onehot = (wcam[:, None, :] == torch.arange(w, device=wcam.device)[None, :, None])
            b6 = (d["xw_t"], onehot.to(torch.int8), jc, jp, v_inv)
            errs["B6"] = check_poisoned(
                "wtt_coupling_rows_fused", tag, "rows",
                lambda: mv.wtt_coupling_rows_fused(*b6),
                lambda: mv.wtt_coupling_rows_fused_plain(*b6), summed)
            r = torch.randn(2, g, tb, pc, generator=torch.Generator().manual_seed(bi),
                            dtype=torch.float64).to(jc.device, dtype)
            jc_n, jp_n, r_n = nan_on(pad, jc, jp, r)
            b5 = (_sym3_matvec(v_inv, g_pt).contiguous(), wcam, jc_n, jp_n, w)
            errs["B5"] = check_poisoned(
                "wtt_w_rows_idx", tag, "rows", lambda: mv.wtt_w_rows_idx(*b5),
                lambda: mv.wtt_w_rows_idx_plain(*b5), summed)
            for od, name in ((False, "wtt_contrib_rows_idx"), (True, "B8 od")):
                b8 = (wcam, jc_n, jp_n, r_n, v_inv, 8, w, True, od)
                errs[name] = check_poisoned(
                    name, tag, "rows", lambda b8=b8: lin.wtt_contrib_rows_idx(*b8),
                    lambda b8=b8: lin.wtt_contrib_rows_idx_plain(*b8), summed)
            log(f"check {tag} padded slots, wtt bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, "
                f"{int(pad.sum())} padded slots poisoned): "
                + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))

        for bi, d in enumerate(tt_kernel_inputs(tt, dtype)):
            c = tt.n_cameras
            mask = d["mask"]
            cam_ids = torch.where(mask > 0, d["cam_ids"], torch.full_like(d["cam_ids"], c))
            nan_row = torch.full((1, 19), float("nan"), dtype=dtype, device=mask.device)
            table = torch.cat([d["table"], nan_row]).contiguous()
            x = torch.cat([d["x"], nan_row[:, :8]]).contiguous()
            b12 = (table, cam_ids, d["pts"], d["uv"], mask, d["inv_w"], cfg, 8)
            errs = {"B12": check_poisoned(
                "tt_cam_normal_fused", tag, "jc,jp,v6,g_pt,ug",
                lambda: tt_ops.tt_cam_normal_fused(*b12),
                lambda: tt_ops.tt_cam_normal_fused_plain(*b12),
                {"jc": elem, "jp": elem, "v6": elem, "g_pt": elem, "ug": summed})}
            b13, b14, b15 = tt_follower_args(
                {**d, "table": table, "cam_ids": cam_ids, "x": x},
                tt_ops.tt_cam_normal_fused_plain(*b12), c + 1)
            errs["B13"] = check_poisoned(
                "tt_coupling_fused", tag, "cols", lambda: tt_ops.tt_coupling_fused(*b13),
                lambda: tt_ops.tt_coupling_fused_plain(*b13), summed)
            errs["B14"] = check_poisoned(
                "tt_wt_times_fused", tag, "wtx", lambda: tt_ops.tt_wt_times_fused(*b14),
                lambda: tt_ops.tt_wt_times_fused_plain(*b14), elem)
            errs["B15"] = check_poisoned(
                "tt_w_times_fused", tag, "wy",
                lambda **kw: tt_ops.tt_w_times_fused(*b15, **kw),
                lambda: tt_ops.tt_w_times_fused_plain(*b15), summed, time_global=t)
            errs["B16"] = check_poisoned(
                "tt_cost_fused", tag, "cost", lambda: tt_ops.tt_cost_fused(*b12[:7]),
                lambda: tt_ops.tt_cost_fused_plain(*b12[:7]), elem)
            log(f"check {tag} padded slots, tt bucket {bi} (Tb={mask.shape[0]} "
                f"Pb={mask.shape[1]}, {int((mask == 0).sum())} padded slots on a NaN "
                "camera; B15 also global): "
                + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log("B15, device ms per pass (f32, cold L2), shared -> global mode forced: "
        + ", ".join(f"{k} {RESULTS[k]['ms']:.6f} -> {RESULTS[k]['global_ms']:.6f}"
                    for k in TWO_MODES))


def check_hub_kernels(hub) -> None:
    """B1 and B4 on the BAL hub buckets (f32), each mode and time printed;
    B1 timed as the ``B1 [hub]`` row."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import wtt_cost
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    elem, summed = TOL[torch.float32]
    row = "B1 [hub]"
    for bi, d in enumerate(wtt_kernel_inputs(hub, torch.float32)):
        g, tb, pc, w = d["shape"]
        args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
                BAConfig(), 8, True)
        before = (dict(lin.COUNTS.modes), dict(wtt_cost.COUNTS.modes))
        got = lin.wtt_linearize_fused_idx(*args)
        err_b1 = max(compare(row, "f32", k, a, b, summed if k == "rows" else elem)
                     for k, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"),
                                        got, lin.wtt_linearize_fused_idx_plain(*args)))
        b4 = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.TRIVIAL)
        err_b4 = compare("wtt_cost_cols_idx", "f32 hub", "", wtt_cost.wtt_cost_cols_idx(*b4),
                         wtt_cost.wtt_cost_cols_idx_plain(*b4), elem)
        modes = (mode_of(lin.COUNTS, before[0]), mode_of(wtt_cost.COUNTS, before[1]))
        b1_ms = timed(row, lambda: lin.wtt_linearize_fused_idx(*args))
        b4_ms = device_ms(lambda: wtt_cost.wtt_cost_cols_idx(*b4))
        log(f"check f32 hub bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, global tiles "
            f"{hub.buckets[bi].global_tiles}, rows {got[0].numel() * 4} bytes): "
            f"B1 {err_b1:.3e} [{modes[0]}, {b1_ms:.6f} ms] "
            f"B4 {err_b4:.3e} [{modes[1]}, {b4_ms:.6f} ms]")
        RESULTS[row]["ms"] += b1_ms
        RESULTS[row]["plain_ms"] += device_ms(lambda: lin.wtt_linearize_fused_idx_plain(*args))
        RESULTS[row]["bytes"] += nbytes(*args[:7], *got)
        RESULTS[row]["flops"] += FLOPS["wtt_linearize_fused_idx"] * g * tb * pc


def check_np10_od(bal) -> None:
    """B1 od, B2 and B3 at np = 10 (``optimize_dist``) on the BAL buckets
    (f32): B1 od timed as the ``B1 od [np=10]`` row (rows of 255,052 bytes
    per group at W = 256, which no shared tile of the card could hold)."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cfg = BAConfig(optimize_dist=True)
    elem, summed = TOL[torch.float32]
    row = "B1 od [np=10]"
    # Operations scale with the row columns K (np = 10 against np = 8).
    k_ratio = lin.n_rows_cols(10, True, True) / lin.n_rows_cols(8, True, True)
    for bi, d in enumerate(wtt_kernel_inputs(bal, torch.float32, np_cam=10)):
        g, tb, pc, w = d["shape"]
        args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
                cfg, 10, True, True)
        before = dict(lin.OD_COUNTS.modes)
        got = lin.wtt_linearize_fused_idx(*args)
        want = lin.wtt_linearize_fused_idx_plain(*args)
        err = max(compare(row, "f32", k, a, b, summed if k == "rows" else elem)
                  for k, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got,
                                     want))
        mode = mode_of(lin.OD_COUNTS, before)
        _, jc, jp, v_inv, _, _ = want
        b2 = (d["xw_t"], d["wcam"], jc, jp, v_inv)
        err_b2 = compare("wtt_coupling_rows_idx", "f32 np=10", "",
                         mv.wtt_coupling_rows_idx(*b2), mv.wtt_coupling_rows_idx_plain(*b2),
                         summed)
        err_b3 = compare("wtt_wt_planes_idx", "f32 np=10", "", mv.wtt_wt_planes_idx(*b2[:4]),
                         mv.wtt_wt_planes_idx_plain(*b2[:4]), elem)
        pairs = adjacent_pairs(d["wcam"], g, tb, pc)
        ms = timed(row, lambda: lin.wtt_linearize_fused_idx(*args))
        log(f"check f32 np=10 BAL bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}): "
            f"B1 od {err:.3e} [{mode}, {ms:.6f} ms] B2 {err_b2:.3e} B3 {err_b3:.3e}")
        RESULTS[row]["ms"] += ms
        RESULTS[row]["plain_ms"] += device_ms(lambda: lin.wtt_linearize_fused_idx_plain(*args))
        RESULTS[row]["bytes"] += nbytes(*args[:7], *got)
        RESULTS[row]["flops"] += int(k_ratio * (FLOPS["wtt_linearize_fused_idx"] * g * tb * pc
                                                + FLOPS["od_pair"] * pairs))


def check_terms_kernels(wtt, bal) -> None:
    """B2 at terms 1 and 2 and B1 at terms 2 (with and without od) against
    their plain versions at the same terms (f32), with window row 0 of the
    camera rows and of x NaN and only padded slots on it: B2 and B1 on the
    medium buckets, timed there as the ``B2 [terms 1|2]`` and ``B1 [terms
    2]`` rows beside the exact kernels' rows; B2, B1 and B1 od on the BAL
    buckets, B1 od timed there as the ``B1 od [terms 2]`` row."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cfg = BAConfig()
    elem, summed = TOL[torch.float32]
    lin_outs = ("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt")
    for label, problem in (("medium", wtt), ("BAL", bal)):
        for bi, d in enumerate(wtt_kernel_inputs(problem, torch.float32)):
            d, pad = poisoned(d)
            d["xw_t"] = d["xw_t"].clone()
            d["xw_t"][:, :, 0] = float("nan")
            g, tb, pc, w = d["shape"]
            slots = g * tb * pc
            base = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
                    cfg, 8, True)
            errs = {}
            for od in (False, True) if label == "BAL" else (False,):
                name = "B1 od [terms 2]" if od else "B1 [terms 2]"
                args = (*base, od)
                got = lin.wtt_linearize_fused_idx(*args, terms=2)
                want = lin.wtt_linearize_fused_idx_plain(*args, terms=2)
                for k, a, b in zip(lin_outs, got, want):
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"{name} {label}: non-finite {k}")
                errs[name] = max(compare(name, "f32", k, a, b, summed if k == "rows" else elem)
                                 for k, a, b in zip(lin_outs, got, want))
                if od and label == "BAL":
                    pairs = adjacent_pairs(d["wcam"], g, tb, pc)
                    account(name, lambda args=args: lin.wtt_linearize_fused_idx(*args, terms=2),
                            lambda args=args: lin.wtt_linearize_fused_idx_plain(*args, terms=2),
                            nbytes(*args[:7], *got), FLOPS["B1 [terms 2]"] * slots
                            + FLOPS["od_pair_terms2"] * pairs)
                elif not od and label == "medium":
                    account(name, lambda args=args: lin.wtt_linearize_fused_idx(*args, terms=2),
                            lambda args=args: lin.wtt_linearize_fused_idx_plain(*args, terms=2),
                            nbytes(*args[:7], *got), FLOPS[name] * slots)
            _, jc, jp, v_inv, _, _ = want
            b2 = (d["xw_t"], d["wcam"], jc, jp, v_inv)
            for terms in (1, 2):
                name = f"B2 [terms {terms}]"
                rows = mv.wtt_coupling_rows_idx(*b2, terms=terms)
                if not torch.isfinite(rows).all():
                    raise AssertionError(f"{name} {label}: a poisoned padded slot reached a row")
                errs[name] = compare(name, "f32", "", rows,
                                     mv.wtt_coupling_rows_idx_plain(*b2, terms=terms), summed)
                if label == "medium":
                    account(name, lambda terms=terms: mv.wtt_coupling_rows_idx(*b2, terms=terms),
                            lambda terms=terms: mv.wtt_coupling_rows_idx_plain(*b2, terms=terms),
                            nbytes(*b2, rows), FLOPS[name] * slots)
            log(f"check f32 terms, {label} bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, "
                f"{int(pad.sum())} padded slots poisoned): "
                + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log("reduced terms, device ms per pass (f32, cold L2): medium B2 "
        f"{RESULTS['wtt_coupling_rows_idx']['ms']:.6f} (terms 3) -> "
        f"{RESULTS['B2 [terms 2]']['ms']:.6f} (terms 2), {RESULTS['B2 [terms 1]']['ms']:.6f} "
        f"(terms 1); medium B1 {RESULTS['wtt_linearize_fused_idx']['ms']:.6f} -> "
        f"{RESULTS['B1 [terms 2]']['ms']:.6f}; BAL B1 od {RESULTS['B1 od']['ms']:.6f} -> "
        f"{RESULTS['B1 od [terms 2]']['ms']:.6f}")


def buckets_line(problem) -> str:
    """The buckets (G, Tb, Pc, W, global tiles, global_tile0) of a wtt packing."""
    return str([(b.uv.shape[0], b.uv.shape[2], b.uv.shape[3], b.window, b.global_tiles,
                 b.global_tile0) for b in problem.buckets])


def run_probes_bal(bal) -> None:
    """E2 and E1 on the unsplit BAL buckets, their tables logged."""
    from tpu3drecon_torch.experiments import index_matvec2, index_matvec3

    t0 = time.perf_counter()
    index_matvec3.run(bal, log=log)
    index_matvec2.run(bal, log=log)
    log(f"probes E2 and E1: {time.perf_counter() - t0:.1f} s")


def run_probe_e4(launches: dict) -> None:
    """E4 as a path: its counts set to 0 just before its run and read just
    after; its device times are the ``E4 A`` / ``E4 B`` rows."""
    from tpu3drecon_torch.experiments import bits_expand

    counts = counters()
    for name in ("E4 A", "E4 B"):
        counts[name].reset()
    res = bits_expand.run(log=log)
    for layout in bits_expand.LAYOUTS:
        name = f"E4 {layout}"
        if counts[name].kernel == 0 or counts[name].plain == 0:
            raise AssertionError(f"{name}: kernel or plain version not run")
        r = RESULTS[name]
        r["ms"], r["plain_ms"], r["bytes"] = (res[layout]["ms"], res[layout]["plain_ms"],
                                              res[layout]["bytes"])
        launches[name] = counts[name].kernel


def check_tt1024_kernels(tt) -> None:
    """B12-B16 on the 1024-camera track table (f32), each mode printed:
    B12 and B13 timed as the ``B12 [C=1024]`` and ``B13 [C=1024]`` rows
    (camera columns that no shared tile of the card could hold), B14 as
    ``B14 [C=1024]``, B15 as ``B15 [C=1024]`` (its global mode: a (C, np)
    tile of 8,192 entries measured slower)."""
    from tpu3drecon_torch.ops import tt_linearize as tt_ops
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    elem, summed = TOL[torch.float32]
    row, row13 = "B12 [C=1024]", "B13 [C=1024]"
    row14, row15 = "B14 [C=1024]", "B15 [C=1024]"
    c = tt.n_cameras
    for bi, d in enumerate(tt_kernel_inputs(tt, torch.float32)):
        tb, pb = d["mask"].shape
        args = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"],
                BAConfig(), 8)
        before = {n: dict(cnt.modes) for n, cnt in counters().items()}
        got = tt_ops.tt_cam_normal_fused(*args)
        want = tt_ops.tt_cam_normal_fused_plain(*args)
        errs = {"B12": max(compare(row, "f32", k, a, b, summed if k == "ug" else elem)
                           for k, a, b in zip(("jc", "jp", "v6", "g_pt", "ug"), got, want))}
        b13, b14, b15 = tt_follower_args(d, want, c)
        coup, wtx, wy = check_tt_followers("f32 C=1024", "", b13, b14, b15, errs)
        compare(row13, "f32", "", coup, tt_ops.tt_coupling_fused_plain(*b13), summed)
        compare(row14, "f32", "", wtx, tt_ops.tt_wt_times_fused_plain(*b14), elem)
        compare(row15, "f32", "", wy, tt_ops.tt_w_times_fused_plain(*b15), summed)
        errs["B16"] = compare("tt_cost_fused", "f32 C=1024", "",
                              tt_ops.tt_cost_fused(*args[:7]),
                              tt_ops.tt_cost_fused_plain(*args[:7]), elem)
        modes = {k: mode_of(counters()[n], before[n]) for k, n in (
            ("B12", "tt_cam_normal_fused"), ("B13", "tt_coupling_fused"),
            ("B14", "tt_wt_times_fused"), ("B15", "tt_w_times_fused"),
            ("B16", "tt_cost_fused"))}
        ms = timed(row, lambda: tt_ops.tt_cam_normal_fused(*args))
        ms13, ms14, ms15 = (RESULTS[r]["ms"] for r in (row13, row14, row15))
        account(row13, lambda: tt_ops.tt_coupling_fused(*b13),
                lambda: tt_ops.tt_coupling_fused_plain(*b13), nbytes(*b13[:5], coup),
                FLOPS["tt_coupling_fused"] * tb * pb)
        account(row14, lambda: tt_ops.tt_wt_times_fused(*b14),
                lambda: tt_ops.tt_wt_times_fused_plain(*b14), nbytes(*b14, wtx),
                FLOPS["tt_wt_times_fused"] * tb * pb)
        account(row15, lambda: tt_ops.tt_w_times_fused(*b15),
                lambda: tt_ops.tt_w_times_fused_plain(*b15), nbytes(*b15[:5], wy),
                FLOPS["tt_w_times_fused"] * tb * pb)
        log(f"check f32 tt_seq1024 bucket {bi} (C={c} Tb={tb} Pb={pb}): "
            + " ".join(f"{k} {v:.3e} [{modes[k]}]" for k, v in errs.items())
            + f"; B12 {ms:.6f} ms, B13 {RESULTS[row13]['ms'] - ms13:.6f} ms, "
            f"B14 {RESULTS[row14]['ms'] - ms14:.6f} ms, "
            f"B15 {RESULTS[row15]['ms'] - ms15:.6f} ms")
        RESULTS[row]["ms"] += ms
        RESULTS[row]["plain_ms"] += device_ms(lambda: tt_ops.tt_cam_normal_fused_plain(*args))
        RESULTS[row]["bytes"] += nbytes(*args[:6], *got)
        RESULTS[row]["flops"] += FLOPS["tt_cam_normal_fused"] * tb * pb


def drive(path: str, solve, problem, flat, repeats: int, maxiters=(None,),
          rmse_limit=1e-3) -> dict:
    """One path's solves (1 warm-up + ``repeats``) at each of ``maxiters``
    (None: the config's), every count set to 0 just before each group and
    read just after; returns its kernels' launch counts over all groups.
    Two groups also give the marginal s/LM-iter of the medians."""
    from tpu3drecon_torch.benchmark.medium_config import timed_solve_stats
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse

    _, _, init = solve(problem, maxiter=0)
    counts = counters()
    mine = {name for _, _, name, _, _, paths, *_ in KERNELS if path in paths}
    launches = dict.fromkeys(mine, 0)
    medians = []
    for maxiter in maxiters:
        kw = {} if maxiter is None else {"maxiter": maxiter}
        for cnt in counts.values():
            cnt.reset()
        warm_s, times, (cams, pts, state) = timed_solve_stats(
            lambda p: solve(p, **kw), problem, repeats)
        group = {n: counts[n].kernel for n in mine}
        modes = {n: dict(counts[n].modes) for n in mine if counts[n].modes}
        plain = {n: cnt.plain for n, cnt in counts.items() if cnt.plain}
        rmse = float(reprojection_rmse(flat, cams, pts))
        medians.append(statistics.median(times))
        report = dict(
            median_s=medians[-1], min_s=min(times), max_s=max(times),
            warmup_s=warm_s, reproj_rmse_px=rmse,
            initial_loss=float(init.loss), final_loss=float(state.loss),
            accepted_steps=int(state.accepted), lm_iters=int(state.iter_num),
            cg_iters_last=int(state.cg_iters),
            launches_per_solve={n: v / (repeats + 1) for n, v in group.items()},
            launches_by_mode=modes, plain_calls=plain,
        )
        log(f"solve {path}" + ("" if maxiter is None else f" maxiter={maxiter}") + " "
            + json.dumps(report))
        if rmse_limit is not None and not rmse < rmse_limit:
            raise AssertionError(f"{path}: final RMSE {rmse:.3e} px is not below "
                                 f"{rmse_limit:.0e} px")
        if not float(state.loss) < float(init.loss):
            raise AssertionError(f"{path}: the final loss is not finite and below the "
                                 "initial loss")
        if int(state.accepted) < 1:
            raise AssertionError(f"{path}: no step was accepted")
        missing = [n for n, v in group.items() if v == 0]
        if missing:
            raise AssertionError(f"{path}: kernels not launched during the solves: {missing}")
        if plain:
            raise AssertionError(f"{path}: plain versions ran during the solves: {plain}")
        for n, v in group.items():
            launches[n] += v
    if len(maxiters) == 2:
        lo, hi = maxiters
        log(f"marginal {path}: ({medians[1]:.6f} s - {medians[0]:.6f} s) / {hi - lo} = "
            f"{(medians[1] - medians[0]) / (hi - lo):.6f} s/LM-iter")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from tpu3drecon_torch.benchmark.balscale import (
        BAL_CONFIG,
        bal_hub_flat,
        bal_hub_wtt,
        bal_sequential_flat,
        bal_sequential_wtt,
    )
    from tpu3drecon_torch.benchmark.medium_config import (
        BENCH_CONFIG,
        build_grid_problem,
        build_problem,
        build_tt_problem,
    )
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.problems.wtt import expand_onehots, wtt_from_flat
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt

    smi = card_line()
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
        return counts

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
        "tt", lambda p, **kw: ba_solve_tt(p, BENCH_CONFIG._replace(**kw), kernels="full"),
        tt, flat, 3,
    ))
    check_padded_slots(wtt, tt)
    del tt, grid

    t0 = time.perf_counter()
    bal = bal_sequential_wtt(device=dev, verbose=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bal_flat = bal_sequential_flat(device=dev)
    log(f"BAL problem: {bal_flat.n_cameras} cameras, {bal_flat.n_points} points, "
        f"{int(bal_flat.mask.sum())} observations, c_pad {bal.c_pad}; "
        f"bal_sequential_wtt built in {build_s:.1f} s; buckets (G, Tb, Pc, W): "
        + str([(b.uv.shape[0], b.uv.shape[2], b.uv.shape[3], b.window)
               for b in bal.buckets]))
    check_od_kernels(bal)
    check_terms_kernels(wtt, bal)
    for path, precond in ((BAL, "schur_jacobi"), (BAL_SSOR, "ssor")):
        cfg = BAL_CONFIG._replace(matvec_kernel="index", linearize_kernel="index",
                                  precond=precond)
        first_path(drive(
            path, lambda p, cfg=cfg, **kw: ba_solve_wtt(p, cfg._replace(**kw)),
            bal, bal_flat, 3, maxiters=(3, 12), rmse_limit=None,
        ))
    t0 = time.perf_counter()
    bal_oh = expand_onehots(bal)
    torch.cuda.synchronize()
    log(f"BAL int8 one-hot: {sum(b.onehot.numel() for b in bal_oh.buckets)} bytes in "
        f"{time.perf_counter() - t0:.1f} s")
    # 6 LM iterations, not 3: on this scene family the block-tridiagonal
    # preconditioner's first three proposals are all rejected (JAX's too).
    cfg = BAL_CONFIG._replace(matvec_kernel="index", linearize_kernel=False,
                              precond="tridiag")
    first_path(drive(
        BAL_TRI, lambda p, **kw: ba_solve_wtt(p, cfg._replace(**kw)), bal_oh, bal_flat, 2,
        maxiters=(6,), rmse_limit=None,
    ))
    del bal_oh

    # C1's second input: optimize_dist (np = 10) under block SSOR, B1 od's
    # rows wider than a shared tile could hold.
    check_np10_od(bal)
    cfg = BAL_CONFIG._replace(matvec_kernel="index", linearize_kernel="index",
                              precond="ssor", optimize_dist=True)
    first_path(drive(
        NP10, lambda p, **kw: ba_solve_wtt(p, cfg._replace(**kw)), bal, bal_flat, 2,
        maxiters=(3,), rmse_limit=None,
    ))
    run_probes_bal(bal)
    del bal

    # The split-window packing of the same problem (the JAX suite's TPU BAL
    # cell), fully indexed and in the reduced-fidelity modes.
    t0 = time.perf_counter()
    split = bal_sequential_wtt(split_windows=True, device=dev, verbose=False)
    torch.cuda.synchronize()
    log(f"BAL split packing: bal_sequential_wtt(split_windows=True) built in "
        f"{time.perf_counter() - t0:.1f} s; buckets (G, Tb, Pc, W, global tiles, "
        f"global_tile0): {buckets_line(split)}")
    for path, matvec, linearize, precond, maxiters, repeats in (
            (SPLIT, "index", "index", "schur_jacobi", (3, 12), 3),
            (SPLIT2, "index2", "index2", "schur_jacobi", (3, 12), 3),
            (SPLIT1, "index1", "index", "schur_jacobi", (3, 12), 3),
            (SPLIT2_SSOR, "index2", "index2", "ssor", (3,), 1)):
        cfg = BAL_CONFIG._replace(matvec_kernel=matvec, linearize_kernel=linearize,
                                  precond=precond)
        first_path(drive(
            path, lambda p, cfg=cfg, **kw: ba_solve_wtt(p, cfg._replace(**kw)), split,
            bal_flat, repeats, maxiters=maxiters, rmse_limit=None,
        ))
    del split, bal_flat

    # The hub-structured BAL problem: global camera tiles widen the windows.
    t0 = time.perf_counter()
    hub = bal_hub_wtt(device=dev, verbose=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hub_flat = bal_hub_flat(device=dev)
    log(f"BAL hub problem: {hub_flat.n_cameras} cameras, {hub_flat.n_points} points, "
        f"{int(hub_flat.mask.sum())} observations, c_pad {hub.c_pad}; bal_hub_wtt built "
        f"in {build_s:.1f} s; buckets (G, Tb, Pc, W, global_tiles): "
        + str([(b.uv.shape[0], b.uv.shape[2], b.uv.shape[3], b.window, b.global_tiles)
               for b in hub.buckets])
        + f"; B1 rows {sum(b.uv.shape[0] * b.window * 88 * 4 for b in hub.buckets)} bytes")
    cfg = BAL_CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
    for precond in ("ssor", "tridiag"):
        try:
            ba_solve_wtt(hub, cfg._replace(precond=precond))
        except ValueError as e:
            if "hub/global camera tiles" not in str(e):
                raise
            log(f"bal_hub under {precond}: ValueError as in JAX ({e})")
        else:
            raise AssertionError(f"bal_hub under {precond} did not raise")
    check_hub_kernels(hub)
    first_path(drive(
        HUB, lambda p, **kw: ba_solve_wtt(p, cfg._replace(**kw)), hub, hub_flat, 3,
        maxiters=(3, 12), rmse_limit=None,
    ))
    del hub

    t0 = time.perf_counter()
    hub_split = bal_hub_wtt(split_windows=True, device=dev, verbose=False)
    torch.cuda.synchronize()
    log(f"BAL hub split packing: bal_hub_wtt(split_windows=True) built in "
        f"{time.perf_counter() - t0:.1f} s; buckets (G, Tb, Pc, W, global tiles, "
        f"global_tile0): {buckets_line(hub_split)}")
    for precond in ("ssor", "tridiag"):
        try:
            ba_solve_wtt(hub_split, cfg._replace(precond=precond))
        except ValueError as e:
            if "hub/global camera tiles" not in str(e):
                raise
            log(f"bal_hub_split under {precond}: ValueError as in JAX")
        else:
            raise AssertionError(f"bal_hub_split under {precond} did not raise")
    first_path(drive(
        HUB_SPLIT, lambda p, **kw: ba_solve_wtt(p, cfg._replace(**kw)), hub_split, hub_flat,
        3, maxiters=(3, 12), rmse_limit=None,
    ))
    del hub_split, hub_flat

    # C2 and C3: a 1024-camera track table (more camera columns than a
    # shared tile of B12 could hold above 922 cameras in f32) on the fully
    # fused route and on JAX's default route under block SSOR, the CLI's
    # pick at 1000 cameras or more.
    from tpu3drecon_torch.dataset.synthetic import (
        make_sequential_scene,
        perturb_scene,
        scene_to_ba_problem,
    )
    from tpu3drecon_torch.problems.tt import tt_from_flat

    t0 = time.perf_counter()
    scene = make_sequential_scene(n_cameras=1024, points_per_camera=256, track_span=4,
                                  seed=7)
    seq_flat, _ = scene_to_ba_problem(perturb_scene(scene, seed=8, point2d_noise=0.5),
                                      observed=scene, dtype=torch.float32, device=dev)
    tt1024 = tt_from_flat(seq_flat, device=dev)
    torch.cuda.synchronize()
    slots = sum(b.mask.numel() for b in tt1024.buckets)
    log(f"tt_seq1024 problem: {seq_flat.n_cameras} cameras, {seq_flat.n_points} points, "
        f"{int(seq_flat.mask.sum())} observations, {slots} slots (JAX's int8 one-hot "
        f"{tt1024.n_cameras * slots} bytes), built and packed in "
        f"{time.perf_counter() - t0:.1f} s; buckets (Tb, Pb): "
        + str([tuple(b.mask.shape) for b in tt1024.buckets]))
    check_tt1024_kernels(tt1024)
    first_path(drive(
        TT1024, lambda p, **kw: ba_solve_tt(p, BAL_CONFIG._replace(**kw), kernels="full"),
        tt1024, seq_flat, 2, rmse_limit=None,
    ))
    cfg = BAL_CONFIG._replace(precond="ssor")
    drive(TT1024_SSOR, lambda p, **kw: ba_solve_tt(p, cfg._replace(**kw)),
          tt1024, seq_flat, 2, rmse_limit=None)
    del tt1024, seq_flat

    from tpu3drecon_torch.experiments import term_stack

    term_stack.run(log=log)
    run_probe_e4(launches)
    log("worst max|diff| / max|plain|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(WORST.items())))

    table = []
    for _, _, name, source, replaces, _, label in KERNELS:
        r = RESULTS[name]
        mode = "+".join(sorted(r["modes"])) or None
        if mode != label:
            raise AssertionError(f"{name}: timed in memory mode {mode}, expected {label}")
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        flops_ms = r["flops"] / F32_FLOPS_PER_S * 1e3
        row = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            library_ms=r["library_ms"], mode=mode,
        )
        if name in TWO_MODES:
            row["global_ms"] = r["global_ms"]
        table.append(row)
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
