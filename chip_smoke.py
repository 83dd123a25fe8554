#!/usr/bin/env python3
"""Run the PyTorch port's medium and BAL-scale bundle-adjustment solves, its
dense-LM solvers and its tool surface (suite, harness, compat, CLI) once on
one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device and build: requires ``torch.cuda.is_available()``, prints the
   card's ``nvidia-smi`` name and power limit, builds every kernel source
   (``tpu3drecon_torch/csrc/*.cu``, one nvcc per source in parallel) and
   prints each source's compile time.
2. The wtt kernels B1-B4 against their plain PyTorch versions on the card,
   on the actual buckets of the packed medium problem (initial parameters,
   lam = 1e-4), in float32 and float64, B3 and B4 also bit for bit against
   their plain versions summed in slot order (``_wt_planes_ordered``,
   ``_cost_cols_ordered``); B1 and B4 also with the Cauchy and Huber losses
   on the smallest bucket.
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
   float64: B9 under all three losses and B11, each in both forms (the
   indexed ``cam_normal_idx`` / ``coupling_idx`` the grid solve calls, and
   the plane forms of JAX's signature), B9's r, jp and jc bit for bit, the
   indexed forms bit-equal to the plane forms and two calls bit-equal; B10
   as the grid solve calls it, one grouped call over the five track
   buckets (``point_normal_buckets``), bit for bit (v_inv, g_pt and
   damp_pt; one log line per bucket).
7. The grid path: ``ba_solve_pallas`` on the same problem with the same
   config: one warm-up solve and 3 timed solves.
8. The dense track-table kernels B12-B16 against their plain versions on
   the card, on the five buckets of the medium problem in track-table
   layout (``build_tt_problem``; initial parameters, lam = 1e-4), in
   float32 and float64, B12 and B16 under all three losses, B16's
   per-point partials bit for bit.
9. The tt path: ``ba_solve_tt(kernels="full")`` (kernels B12-B16) on the
   same problem with the same config: one warm-up solve and 3 timed solves.
10. Padded slots and the global-memory mode: every kernel that reads
    camera rows or x by index or reduces into rows (B1, B1 od, B2-B6, B8,
    B8 od, B12-B16) against its plain version on the medium wtt and tt
    buckets, in float32 and float64, with the padded slots poisoned (window
    row 0 NaN and only padded slots on it, NaN jc/jp/r on padded slots for
    B3, B5 and B8 and window row 0 of x NaN for B3, which must equal its
    ordered plain form bit for bit, as B4 must, an extra NaN camera carried
    only by padded tt slots); B15
    and B5, which keep a block-shared tile at small camera counts and
    narrow windows, also with the global-memory mode forced (``_mode``),
    whose f32 time is their ``global_ms``.
10b. The flat kernels (``ops/flat_linearize.py``, ``csrc/flat_kernels.cu``;
    they replace no TPU kernel) against their plain versions on the card:
    ``linearize`` (U, V, g_c, g_p, W) and its ``coupling`` (on the V^-1 of
    the plain sums, damped with lam 1e-4) on the medium problem, the
    trivial loss in f32 and f64 and the Cauchy and Huber losses in f64,
    each at 8 camera columns and at 10 (``optimize_dist``, k1, k2 drawn
    for every camera), and at the benchmark's flat shapes (Venice-1778,
    Final-13682 and Final-13682 with BAL's radial camera at 10 columns,
    from ``portbench/generator.py``, seed ``FLAT_SEED``, f32, trivial loss,
    as its ``flat_fixed3`` and ``flat_fixed3_dist`` cells run them), each
    8-column medium f32 pass and each shape timed (the rows
    ``flat_lin_kernel``, ``flat_coupling_kernel`` and their
    ``[Venice-1778]``, ``[Final-13682]`` and ``[Final-radial]`` rows) with a
    log line of the errors and each kernel alone (the profiler's mean).
11. The solvers that reach no kernel of the TPU port (in JAX they are
    plain XLA): the flat ``ba_solve`` on the medium problem with the same
    config (f32, reprojection RMSE below 1e-3 px; its linearization must
    launch the flat kernels, one of each per LM iteration, and no plain
    version, all at 8 camera columns by the program's counters), then
    ``flat radial``, the same solve with ``optimize_dist`` (1 warm-up and
    3 timed, RMSE below 1e-3 px, every flat launch at 10 columns); batched PnP, the JAX suite's config
    #1 (8 cameras of 2300 matches, seed 5, ``refine_poses`` TRIVIAL with
    ``PNP_CONFIG``, f32), held against the in-run scipy ``least_squares``
    oracle (rotation below 1e-4 rad, tvec below 2e-3); tracking, config
    #4 (500 frames of 1000 observations, seed 81, ``TRACKING_CONFIG``, f32;
    median |tvec - truth| below 1e-3, ms per frame printed); intrinsics,
    ``refine_intrinsics`` on the tracking scene with distortion (-0.15,
    0.03), focal perturbed by up to 2 % and distortion zeroed (f64; fx/fy
    to rtol 1e-6, dist to atol 1e-6); and calib,
    ``ba_with_intrinsics_calibration(rounds=8)`` on the calibration scene
    of tests/test_intrinsics_refine.py (f64; every k1 in (-0.14, -0.06),
    RMSE below 0.06 px; its flat solves must launch the flat kernels).
    Each: one warm-up and 3 timed solves, a ``solve <path>`` line, no plain
    version counted and no port kernel but the flat ones on the flat and
    calib paths (``benchmark/solver_cells.py`` builds them).
12. Files: the grid engine and the paths from file to solve to file
    (the JAX CLI's ``solve-colmap`` and ``solve-bal``, plain PyTorch, no
    port kernel), each solve 1 warm-up and 3 timed, its read, pack, solve
    and write seconds logged beside the card's name and power limit, every
    count set to 0 just before its solves and read just after (no port
    kernel and no plain version may run).  (a) ``ba_grid``:
    ``ba_solve_grid`` (the CLI's ``--engine grid``) on the medium problem
    packed by ``grid_from_flat``, ``BENCH_CONFIG``: RMSE below 1e-3 px,
    loss below the initial loss, at least one accepted step.  (b) The
    medium scene's perturbed cameras and points with its clean
    observations (as ``build_problem`` pairs them) as a PINHOLE COLMAP
    model (``scene_to_colmap_model``), written binary and read back: the
    native reader must have parsed both files and equal the numpy reader
    bit for bit; then ``ba_problem_from_colmap`` -> ``ba_solve_grid`` ->
    ``colmap_model_with_solution`` -> ``write_model`` -> ``read_model`` ->
    repack: RMSE below 1e-3 px, the re-read model's within 1e-3 px of the
    solve's.  (c) A BAL file of Ladybug problem-49's shape (49 cameras,
    7,776 points, BAL's camera model with k1/k2, seed 49,
    ``benchmark/file_cells.py``): ``ba_problem_from_bal`` (the native
    tokenizer must have run) -> ``ba_solve_grid`` with
    ``examples/bal_pipeline.py``'s config (50 LM, ``gtol`` 1e-10, 30 CG,
    ``cg_rtol`` 1e-6, fixed focal) -> ``export_bal`` -> reload: the RMSE
    must fall, the reloaded RMSE within 1e-3 px of the solve's.  (d) The
    dataset path: ``load_colmap_dataset`` of (b)'s model ->
    ``ba_problem_from_dataset`` (the same observations as (b)'s problem,
    compared sorted) -> ``ba_solve_grid``: RMSE below 1e-3 px, and the
    solved camera centres, aligned to the scene's true centres by
    ``umeyama_alignment`` (float64), within a median of 1e-6 of the true
    centres' extent (their bounding-box diagonal).
12b. The command line (``tpu3drecon_torch/cli.py``) on phase 12's files,
    on the card: ``main([...])`` in process for ``solve-colmap`` on the
    medium COLMAP model with each engine (flat, grid, pallas, tt, wtt;
    ``--maxiter 30 --cg-maxiter 8``; the pallas run must launch B9-B11, the
    wtt run, fully indexed on split windows by the card's auto rules,
    B1-B4, the flat run the flat kernels, and no run a plain version),
    ``solve-bal`` on the Ladybug-shaped BAL file (50 LM, fixed focal; the
    flat kernels), a checkpointed ``solve-bal`` (``--checkpoint-every 10``)
    run twice, the first launching the flat kernels, the second resuming
    complete and launching none; then ``python -m tpu3drecon_torch info`` (the card,
    the native reader) and ``solve-bal`` as subprocesses.  Every written
    file is read back: its RMSE within 1e-3 px of the solve's.
12c. The parallel layer (``tpu3drecon_torch/parallel/``): an NCCL process
    group of world size 1 (the machine has one card), then on the medium
    problem, each beside its single-device engine in this call (1 warm-up
    + 3 timed each, the walls and the all_reduce / all_gather calls per
    solve logged): sharded wtt (fully indexed: B1-B4), sharded grid (the
    kernel route: B9 and B11 in their plane forms), sharded tt (JAX's
    sharded route, ``kernels=False``: no kernel) and sharded flat (the flat
    kernels); sharded
    pose on the tracking cell (500 frames).  wtt and tt: the same
    ``accepted``, ``iter_num`` and ``cg_iters`` and the same loss bits as
    the single-device solve where that solve repeats its own bits; where
    its float atomics (B1/B2, ``index_add_``) make it vary from run to
    run, both at the float32 rounding floor (below) or, together, the
    same most common step counts, the median sharded loss within 50 % of
    the median single-device loss (``bal_hub_split`` at 3 LM iterations
    varies by ~35 % between identical float32 solves: 1 + 5 solves each
    there) and the median RMSE of the returned cameras and points within
    10 % of the single-device solves'; grid, flat and pose: the loss
    within 1e-3 relative; any of them also passes with both solves at the
    float32 rounding floor (RMSE below 1e-4 px); RMSE below 1e-3 px.  At the end of phase 17, ``bal_hub_split`` at 3 LM iterations on
    sharded wtt on the same packing, held as wtt is.
13. The BAL-scale sequential problem: ``bal_sequential_wtt`` (1712
    cameras, 999,808 points, 3,808,166 observations, f32) built on the
    card, its build time and buckets logged.
14. B1 and B8 with ``want_od``, and B3, B4, B5 and B7, against their
    plain versions on the BAL buckets (B3 and B4 also bit for bit against
    their ordered plain forms, B7 bit for bit): f32, where they are timed
    (B1 od and B8 od beside B1 and B8 without od, B3, B4, B5 and B7 as ``B3
    [BAL]``, ``B4 [BAL]``, ``B5 [BAL]`` and ``B7 [BAL]``), and f64 with
    window row 0 and the padded slots' planes NaN.  Then the
    reduced-fidelity kernels against their plain versions at the same
    terms, f32, with window row 0 of the camera rows and of x NaN: B2 at
    terms 1 and 2 and B1 at terms 2 on the medium buckets (timed there
    beside the exact B2 and B1), B2 at terms 1 and 2 and B1 at terms 2 with
    and without od on the BAL buckets (B1 od timed there).
15. The BAL paths, with the JAX suite's BAL solver config (8 CG
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
16. The split-window packing of the same problem
    (``bal_sequential_wtt(split_windows=True)``, the JAX suite's TPU BAL
    cell), its build time and buckets (G, Tb, Pc, W, global tiles,
    global_tile0) logged: ``bal_seq_split`` (fully indexed),
    ``bal_seq_split_index2`` (matvec and linearize ``index2``) and
    ``bal_seq_split_index1`` (matvec ``index1``, linearize ``index``) at 3
    and 12 LM iterations, one warm-up and 3 timed solves each, with their
    marginals; ``bal_seq_split_index2_ssor`` (``index2``/``index2`` under
    block SSOR: B1 od at 2 terms) at 3 iterations, one warm-up and 1 timed.
17. The BAL hub problem: ``bal_hub_wtt`` (1712 cameras, 5 % hubs of 4000
    observations, packed with global camera tiles) built on the card, its
    buckets (G, Tb, Pc, W, global tiles) logged; the band preconditioners
    must raise JAX's hub ``ValueError``; B1 and B4 checked on its buckets
    (f32), each mode and time printed;
    ``bal_hub`` (fully indexed, Schur-Jacobi, the BAL config) at 3 and 12
    LM iterations, one warm-up and 3 timed solves each, and its marginal.
    Then its split packing (``bal_hub_wtt(split_windows=True)``), buckets
    and build time logged, the band preconditioners must raise there too,
    and ``bal_hub_split`` (fully indexed) at 3 and 12 iterations, 1 + 3.
18. ``tt_seq1024``: a sequential scene of 1024 cameras and 256 points per
    camera (seed 7, perturbed with seed 8 and 0.5 px noise) packed by
    ``tt_from_flat`` (f32), its counts logged; B12-B16 checked on its
    buckets, each mode printed, B16's per-point partials bit for bit and
    its kernel alone timed; solved with the BAL config at 3 LM
    iterations on ``kernels="full"`` (Schur-Jacobi) and on JAX's default
    route ``kernels=False`` under block SSOR (``tt_seq1024_ssor``, no port
    kernel), one warm-up and 2 timed solves each.  The same scene in
    bucketed grid layout (``grid_bucketed_from_flat``, (C, K) = (1024,
    1024)): B9 and B11 checked in both forms as in phase 6 (f32) and timed
    as the ``B9 [C=1024]`` and ``B11 [C=1024]`` rows (one lane a thread at
    K = 1024, the first port's lane order); ``grid_seq1024``, ``ba_solve_pallas`` with the BAL
    config at 3 LM iterations, one warm-up and 2 timed solves.
    Each BAL, hub, tt_seq1024 and grid_seq1024 solve must end finite and
    below its initial loss with at least one accepted step.
19. The probes E3 (``experiments.term_stack``: B2 against its plain
    version at terms 3 and 1 on E3's random inputs) and E4
    (``experiments.bits_expand``: both unpack layouts against numpy; its
    counts set to 0 before and read after, as a path's).
20. The tool surface (``run_tools``).  The problem cache: every BAL build
    above went through it in a directory of this run's own, so the split
    build of step 16 was a miss; the same build again must be a hit, bit for
    bit the miss's problem (miss and hit seconds logged).  The suite
    (``benchmark/suite.py run_suite``) at its defaults, one ``suite`` JSON
    line per config, each checked as it comes, its counts set to 0 before
    it: PnP (8 x 2300) within the parity bounds against scipy (rotation
    below 1e-4 rad, tvec below 2e-3), small BA (10 x 5000, the tt engine's
    PyTorch route) and medium (the wtt engine, B1-B4) RMSE below 1e-3 px,
    tracking (500 x 1000) median tvec error below 1e-3, BAL (1712 cameras,
    split windows, B1-B4, its problem a cache hit) finite, below its
    initial loss, with an accepted step; B1-B4 must launch on the medium and
    BAL lines and no port kernel elsewhere, no plain version anywhere.  The
    harness (``run_harness``): ``benchmark_bundle_adjustment`` and
    ``benchmark_single_pose`` on the registry's synthetic_medium_noised (30
    cameras, 3000 points) with scipy, the gated COLMAP and GTSAM baselines
    skipped, saved and loaded back; the torch adapter must lower the mean
    reprojection error and both BA adapters end below 1.0 px^2; one
    ``subprocess_benchmark(device="cuda")``, its mean squared error within
    1e-4 (relative) of the in-process one's; the in-process BA adapter
    must launch the flat kernels.  ``compat`` (``run_compat``, f64):
    ``JaxPoseOptimizer`` and ``JaxBundleAdjustment`` on the card, the
    latter launching the flat kernels.  ``export_scene`` of the medium
    scene (seconds, bytes).  ``bench`` in process (B1-B4 counted, path ``cli
    bench``) and ``python -m tpu3drecon_torch bench`` as a subprocess, each
    line's RMSE below 1e-3 px.  The phase's seconds are logged.
21. Prints the kernel table as one JSON line, the ``nvidia-smi`` line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); summed outputs 1e-4 and 1e-10 (B1, B2, B5, B6 and B8 rows,
B12's U|g columns, B13 and B15 are atomic sums whose order varies; B9's U
and g and B11's blocks are block reductions in another order than the
plain version's); B7 (a selection) and B9's r, jp and jc (the
same operations, each rounded alone) exactly, B10, which sums each point's
rows in the plain version's order, exactly, and B3 and B4, which sum each
point's slots in slot order with no atomics, exactly against their ordered
plain forms.  Each row of the kernel table
gives its ``mode``: the memory mode its wrapper counted during the timed
calls of its ``ms`` (``global``; ``shared`` for B15 on the medium buckets,
whose (C, np) tile has at most 2,048 entries; ``global+shared`` for B5
there, whose (np, W) tile of 1,024 entries serves every medium bucket but
the last, of 6 slots per entry; none for B7, B9-B11 and E4, which have no
mode), which must match the row's label; B15's and B5's rows add
``global_ms``, the time of the same (poisoned) inputs with the
global-memory mode forced.
The rows ``B1 [hub]`` (the hub buckets), ``B1 od [np=10]`` (the BAL buckets
with ``optimize_dist``), ``B3 [BAL]``, ``B4 [BAL]``, ``B5 [BAL]`` and ``B7
[BAL]`` (the BAL buckets), ``B12 [C=1024]``,
``B13 [C=1024]``, ``B14 [C=1024]``, ``B15 [C=1024]`` (tt_seq1024, B15
there in its global mode), ``B16 [C=1024]``, ``B9 [C=1024]`` and ``B11
[C=1024]`` (grid_seq1024) time those kernels
at the widths that a shared tile could not hold or does not serve (B5,
B7 and B16 on their second path), and count their launches on those
paths.  The
rows ``B2 [terms 1]``, ``B2 [terms 2]`` and ``B1 [terms 2]`` (medium
buckets) and ``B1 od [terms 2]`` (BAL buckets) time the reduced-fidelity
kernels and count their launches on the split paths that run them; ``E4
A`` / ``E4 B`` count theirs in the E4 phase.  The rows ``flat_lin_kernel
[Venice-1778]``, ``flat_coupling_kernel [Venice-1778]`` and their
``[Final-13682]`` rows time the flat kernels at the benchmark's flat
shapes and take their launches from the medium flat path.  The flat rows'
``ms`` cover each wrapper's device work: its kernel, the zeroed output and
the unpacking of the upper triangles into full blocks.
Kernel and plain
times (``ms``, ``plain_ms``) are device times
(``tpu3drecon_torch.benchmark.timing.device_ms``): the median
of 20 calls, each with a cold L2 and timed by a CUDA-event pair that sees
none of the call's host time, summed over one pass of the solve (the five
buckets, or one linearization; B10's pass is its one grouped call).
``ms`` covers all the device work of the wrapper: the kernel, and for B16
the sum of its per-point partials and the product by 0.5 (two PyTorch
launches per bucket; a log line gives B16's kernel alone beside it, on the
medium buckets and on tt_seq1024).  The rows of B9 and B11 time what the
grid solve calls, the indexed forms; a log line per grid gives their
kernels alone (the profiler's mean), the plane forms' times and both
forms' bounds.  B7's
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
output written once, f32, from this run's tensors; B9's and B11's indexed
forms read points3d or V^-1 once per point and pt_idx once per lane) over
3.35 TB/s and its operations (counted per slot, lane or observation from the kernel
source, ``FLOPS``;
for the od rows also per adjacent slot pair of this run's data) over 67
TFLOP/s of float32.  B3 and B5 read no planes of a padded slot, so their
jc/jp bytes and operations count the slots that have a window row only.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
import types

import torch

from tpu3drecon_torch.benchmark.timing import HBM_BYTES_PER_S, card_line, device_ms, nbytes

WTT_SRC = "tpu3drecon_torch/csrc/wtt_kernels.cu"
TERMS_SRC = "tpu3drecon_torch/csrc/wtt_terms_kernels.cu"
ROUTE_SRC = "tpu3drecon_torch/csrc/wtt_route_kernels.cu"
GRID_SRC = "tpu3drecon_torch/csrc/grid_kernels.cu"
TT_SRC = "tpu3drecon_torch/csrc/tt_kernels.cu"
PROBE_SRC = "tpu3drecon_torch/csrc/probe_kernels.cu"
FLAT_SRC = "tpu3drecon_torch/csrc/flat_kernels.cu"
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
GRID1024 = "grid_seq1024"  # the same 1024-camera scene in grid layout
# The split-window BAL packings (the JAX suite's TPU BAL cell packs this
# way): fully indexed, the reduced-fidelity modes (matvec index2 with
# linearize index2, matvec index1 with linearize index, and index2/index2
# under block SSOR, whose B1 od rows run at 2 terms), and the split hub.
SPLIT, SPLIT2, SPLIT1 = "bal_seq_split", "bal_seq_split_index2", "bal_seq_split_index1"
SPLIT2_SSOR, HUB_SPLIT = "bal_seq_split_index2_ssor", "bal_hub_split"
E4 = "E4 probe"
# The parallel layer at world size 1 over NCCL: sharded wtt (fully indexed)
# on the medium problem and on the BAL hub split, sharded grid on its kernel
# route; and the command line's wtt (fully indexed, split windows) and
# pallas engines on the medium COLMAP model.
SHARDED_WTT, SHARDED_HUB, SHARDED_GRID = "sharded_wtt", "sharded_bal_hub_split", "sharded_grid"
CLI_WTT, CLI_PALLAS = "cli wtt", "cli pallas"
# The tool surface: the suite's medium and BAL lines (the wtt engine fully
# indexed) and the command line's bench, in process.
SUITE_MEDIUM, SUITE_BAL, CLI_BENCH = "suite ba_medium", "suite bal_lm_iter", "cli bench"
SHARED, GLOBAL = "shared", "global"  # tpu3drecon_torch.ops._build's modes
# The flat engine (``ba_solve``, whose linearization is the flat kernels on
# the card): the medium problem, the calibration alternation, world size 1
# over NCCL, the command line's flat solve-colmap, solve-bal and its first
# checkpointed run, the harness's BA adapter and the reference-API class.
# The benchmark's flat shapes time the kernels again (portbench's generator),
# the radial one at 10 camera columns (``optimize_dist``, the kernels' NP =
# 10 instances), as ``flat radial``, the medium solve with k1, k2, runs them.
FLAT, CALIB, SHARDED_FLAT, FLAT_DIST = "flat", "calib", "sharded_flat", "flat radial"
FLAT_PATHS = {FLAT, CALIB, SHARDED_FLAT, FLAT_DIST, "cli flat", "cli bal",
              "cli bal checkpointed first", "harness", "compat"}
FLAT_SHAPES = (  # (portbench configuration, row label, optimize_dist)
    ("bal_venice1778", "Venice-1778", False), ("bal_final13682", "Final-13682", False),
    ("bal_final13682_radial", "Final-radial", True))
FLAT_SEED = 2147483711  # the inputs' seed at those shapes
# (module under tpu3drecon_torch, counter attribute, kernel name, source,
# replaced TPU kernel, paths, the memory mode of its ms: the kernels read
# camera rows from device memory and reduce into the output rows directly,
# B15 and B5 into a block-shared tile at small camera counts and narrow
# windows (B5 on buckets of many slots: both modes in one pass), B7, B9-B11
# and E4 have no mode)
ALL_SPLIT = {SPLIT, SPLIT2, SPLIT1, SPLIT2_SSOR, HUB_SPLIT}
# B1-B4: the fully indexed wtt paths
INDEXED = {SHARDED_WTT, SHARDED_HUB, CLI_WTT, SUITE_MEDIUM, SUITE_BAL, CLI_BENCH}
KERNELS = (
    ("ops.wtt_linearize", "COUNTS", "wtt_linearize_fused_idx", WTT_SRC, f"{LIN_PY}:554",
     {WTT, BAL, HUB, SPLIT, SPLIT1, HUB_SPLIT} | INDEXED, GLOBAL),
    ("ops.wtt_matvec", "COUPLING_COUNTS", "wtt_coupling_rows_idx", WTT_SRC, f"{MV_PY}:215",
     {WTT, UNFUSED, BAL, BAL_SSOR, BAL_TRI, HUB, NP10, SPLIT, HUB_SPLIT} | INDEXED, GLOBAL),
    ("ops.wtt_matvec", "WT_COUNTS", "wtt_wt_planes_idx", WTT_SRC, f"{MV_PY}:405",
     {WTT, UNFUSED, BAL, BAL_SSOR, BAL_TRI, HUB, NP10} | ALL_SPLIT | INDEXED, GLOBAL),
    ("ops.wtt_cost", "COUNTS", "wtt_cost_cols_idx", WTT_SRC,
     "tpu3drecon/ops/pallas/wtt_cost.py:94",
     {WTT, BAL, BAL_SSOR, HUB, NP10} | ALL_SPLIT | INDEXED, GLOBAL),
    ("ops.wtt_matvec", "W_ROWS_COUNTS", "wtt_w_rows_idx", ROUTE_SRC, f"{MV_PY}:468",
     {UNFUSED, BAL_TRI}, f"{GLOBAL}+{SHARED}"),
    ("ops.wtt_matvec", "FUSED_COUNTS", "wtt_coupling_rows_fused", ROUTE_SRC, f"{MV_PY}:526",
     {ONEHOT}, GLOBAL),
    ("ops.wtt_linearize", "CAM_PLANES_COUNTS", "wtt_cam_planes_idx", ROUTE_SRC,
     f"{LIN_PY}:229", {UNFUSED, ONEHOT, BAL_TRI}, None),
    ("ops.wtt_linearize", "CONTRIB_COUNTS", "wtt_contrib_rows_idx", ROUTE_SRC,
     f"{LIN_PY}:286", {UNFUSED, ONEHOT}, GLOBAL),
    ("ops.cam_normal", "COUNTS", "cam_normal_idx", GRID_SRC,
     "tpu3drecon/ops/pallas/cam_normal.py:205", {"grid", SHARDED_GRID, CLI_PALLAS}, None),
    ("ops.point_normal", "COUNTS", "point_normal_fused", GRID_SRC,
     "tpu3drecon/ops/pallas/point_normal.py:80", {"grid", CLI_PALLAS}, None),
    ("ops.coupling", "COUNTS", "coupling_idx", GRID_SRC,
     "tpu3drecon/ops/pallas/coupling.py:65", {"grid", SHARDED_GRID, CLI_PALLAS}, None),
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
    # B3, B4 (the bal_seq path), B5 and B7 (its bal_seq_tridiag_unfused
    # path) on the BAL buckets, and B16 on the 1024-camera track table.
    ("ops.wtt_matvec", "WT_COUNTS", "B3 [BAL]", WTT_SRC, f"{MV_PY}:405", {BAL}, GLOBAL),
    ("ops.wtt_cost", "COUNTS", "B4 [BAL]", WTT_SRC, "tpu3drecon/ops/pallas/wtt_cost.py:94",
     {BAL}, GLOBAL),
    ("ops.wtt_matvec", "W_ROWS_COUNTS", "B5 [BAL]", ROUTE_SRC, f"{MV_PY}:468", {BAL_TRI},
     GLOBAL),
    ("ops.wtt_linearize", "CAM_PLANES_COUNTS", "B7 [BAL]", ROUTE_SRC, f"{LIN_PY}:229",
     {BAL_TRI}, None),
    ("ops.tt_linearize", "COST_COUNTS", "B16 [C=1024]", TT_SRC, f"{TT_PY}:512", {TT1024},
     GLOBAL),
    # B9 and B11 on the grid packing of the same 1024-camera scene, K =
    # 1024: one lane a thread.
    ("ops.cam_normal", "COUNTS", "B9 [C=1024]", GRID_SRC,
     "tpu3drecon/ops/pallas/cam_normal.py:205", {GRID1024}, None),
    ("ops.coupling", "COUNTS", "B11 [C=1024]", GRID_SRC,
     "tpu3drecon/ops/pallas/coupling.py:65", {GRID1024}, None),
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
    # The flat engine's linearization, which replaces no TPU kernel (XLA's
    # in JAX), on the medium problem and at the benchmark's flat shapes.
    ("ops.flat_linearize", "COUNTS", "flat_lin_kernel", FLAT_SRC, "none", FLAT_PATHS, None),
    ("ops.flat_linearize", "COUPLING_COUNTS", "flat_coupling_kernel", FLAT_SRC, "none",
     FLAT_PATHS, None),
) + tuple(
    ("ops.flat_linearize", attr, f"{name} [{label}]", FLAT_SRC, "none", {FLAT}, None)
    for _, label, _ in FLAT_SHAPES
    for attr, name in (("COUNTS", "flat_lin_kernel"), ("COUPLING_COUNTS", "flat_coupling_kernel"))
)
# The kernels that keep a shared-memory mode beside the global one: their
# rows add global_ms, the time of the same inputs with the global mode forced.
TWO_MODES = ("tt_w_times_fused", "wtt_w_rows_idx")
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
    # The flat kernels' bytes and operations come from portbench/flat_roofline.py.
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
    """Adds the device time of ``fn(_mode=GLOBAL)`` (B15 or B5 forced into
    its global-memory mode) to the row's ``global_ms``."""
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


def live_slot_work(kernel: str, x, wcam, jc, jp, out) -> tuple[int, int]:
    """B3's or B5's bytes and float operations on this bucket's data: x
    (B3's window rows of x, B5's y), wcam and the output, and the jc/jp
    planes and work of the slots that have a window row only (the kernels
    read no planes of a padded slot)."""
    live = int((wcam >= 0).sum())
    plane_bytes = (jc.shape[0] + jp.shape[0]) * jc.element_size()
    return nbytes(x, wcam, out) + live * plane_bytes, FLOPS[kernel] * live


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
    """Phase 2: B1-B4 against their plain versions, f32 and f64; B3 and B4
    also bit for bit against their ordered plain forms."""
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
            err_b3, err_b4 = ordered_errs("wtt_wt_planes_idx", "wtt_cost_cols_idx", tag,
                                          planes_b3, wt_args, cols_b4, cost_args)
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
                    *live_slot_work("wtt_wt_planes_idx", *wt_args, planes_b3))
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
            cols = wtt_cost.wtt_cost_cols_idx(*cost_args)
            compare("wtt_cost_cols_idx", tag, "", cols,
                    wtt_cost.wtt_cost_cols_idx_plain(*cost_args), elem)
            compare("wtt_cost_cols_idx", tag, "ordered", cols,
                    wtt_cost._cost_cols_ordered(*cost_args), 0.0)
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


def cam_planes_gather(d):
    """B7's function as one PyTorch call on bucket ``d`` (its
    ``library_ms``): ``torch.gather`` of the (G, 19, W + 1) window table,
    its last row zero, by each slot's row (W for padding)."""
    from tpu3drecon_torch.ops._wtt_common import slot_index

    g, tb, pc, w = d["shape"]
    tw_t = torch.cat([d["tw"], d["tw"].new_zeros(g, 1, 19)], dim=1)
    tw_t = tw_t.transpose(1, 2).contiguous()
    idx = slot_index(d["wcam"], w)[:, None, :].expand(g, 19, tb * pc)
    return lambda: torch.gather(tw_t, 2, idx)


def check_route_kernels(problem) -> None:
    """Phase 4: B5-B8 against their plain versions, f32 and f64, on the
    buckets with their dense one-hot; then padded slots against NaN."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
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
            account("wtt_cam_planes_idx", lambda: lin.wtt_cam_planes_idx(*b7),
                    lambda: lin.wtt_cam_planes_idx_plain(*b7),
                    nbytes(d["wcam"], d["tw"], planes), 0, library=cam_planes_gather(d))
            account("wtt_contrib_rows_idx", lambda: lin.wtt_contrib_rows_idx(*b8_sj),
                    lambda: lin.wtt_contrib_rows_idx_plain(*b8_sj),
                    nbytes(*b8_sj[:5], rows_sj), FLOPS["wtt_contrib_rows_idx"] * slots)
            account("wtt_w_rows_idx", lambda: mv.wtt_w_rows_idx(*b5),
                    lambda: mv.wtt_w_rows_idx_plain(*b5),
                    *live_slot_work("wtt_w_rows_idx", *b5[:4], rows_b5))
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


def ordered_errs(row3: str, row4: str, tag: str, planes, b3, cols, b4) -> tuple[float, float]:
    """B3's planes ``planes`` on ``b3`` and B4's columns ``cols`` on ``b4``
    against their plain versions (per-element tolerance) and, exactly,
    against their ordered plain forms; returns the two plain errors."""
    from tpu3drecon_torch.ops import wtt_cost
    from tpu3drecon_torch.ops import wtt_matvec as mv

    elem = TOL[planes.dtype][0]
    err_b3 = compare(row3, tag, "", planes, mv.wtt_wt_planes_idx_plain(*b3), elem)
    err_b4 = compare(row4, tag, "", cols, wtt_cost.wtt_cost_cols_idx_plain(*b4), elem)
    compare(row3, tag, "ordered", planes, mv._wt_planes_ordered(*b3), 0.0)
    compare(row4, tag, "ordered", cols, wtt_cost._cost_cols_ordered(*b4), 0.0)
    return err_b3, err_b4


def adjacent_pairs(wcam, g: int, tb: int, pc: int) -> int:
    """Slot pairs (t-1, t) of one track on window rows (w, w + 1): the od
    rows' work in this run's data."""
    w = wcam.reshape(g, tb, pc).long()
    return int(((w[:, :-1] >= 0) & (w[:, 1:] == w[:, :-1] + 1)).sum())


def check_od_kernels(bal) -> None:
    """Phase 14: B1 and B8 with want_od, B5 and B7 (the W y rows and the
    camera planes of the same tridiag path), and B3 and B4 (the
    back-substitution and cost of the bal_seq path; also bit for bit
    against their ordered plain forms), against their plain versions on the
    BAL buckets: f32 (timed there, B1 od and B8 od beside B1 and B8 without
    od, B3, B4, B5 and B7 as the ``B3 [BAL]``, ``B4 [BAL]``, ``B5 [BAL]``
    and ``B7 [BAL]`` rows), and f64 with NaN where only padded slots read
    (rows of 350,360 and 294,912 bytes per group, which no shared tile of
    the card could hold); B7 bit for bit."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import wtt_cost
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec
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
        b7 = (d["wcam"], d["tw"], tb)
        planes = lin.wtt_cam_planes_idx(*b7)
        err_b7 = compare("B7 [BAL]", "f32", "", planes, lin.wtt_cam_planes_idx_plain(*b7), 0.0)
        jc, jp, r, v_inv, g_pt = route_planes(d, planes, cfg)
        b8 = (d["wcam"], jc, jp, r, v_inv, 8, w, True, True)
        rows = lin.wtt_contrib_rows_idx(*b8)
        err_b8 = compare("B8 od", "f32", "", rows, lin.wtt_contrib_rows_idx_plain(*b8), summed)
        b5 = (_sym3_matvec(v_inv, g_pt).contiguous(), d["wcam"], jc, jp, w)
        rows_b5 = mv.wtt_w_rows_idx(*b5)
        err_b5 = compare("B5 [BAL]", "f32", "", rows_b5, mv.wtt_w_rows_idx_plain(*b5), summed)
        b3 = (d["xw_t"], d["wcam"], got[1], got[2])
        b4 = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.TRIVIAL)
        planes_b3, cols_b4 = mv.wtt_wt_planes_idx(*b3), wtt_cost.wtt_cost_cols_idx(*b4)
        err_b3, err_b4 = ordered_errs("B3 [BAL]", "B4 [BAL]", "f32", planes_b3, b3, cols_b4, b4)
        pairs = adjacent_pairs(d["wcam"], g, tb, pc)
        log(f"check f32 od BAL bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, {pairs} pairs): "
            f"B1 od {err_b1:.3e} B8 od {err_b8:.3e} B5 {err_b5:.3e} B3 {err_b3:.3e} "
            f"B4 {err_b4:.3e} B7 {err_b7:.3e}")
        slots = g * tb * pc
        account("B7 [BAL]", lambda: lin.wtt_cam_planes_idx(*b7),
                lambda: lin.wtt_cam_planes_idx_plain(*b7), nbytes(d["wcam"], d["tw"], planes),
                0, library=cam_planes_gather(d))
        account("B1 od", lambda: lin.wtt_linearize_fused_idx(*lin_args),
                lambda: lin.wtt_linearize_fused_idx_plain(*lin_args),
                nbytes(*lin_args[:7], *got),
                FLOPS["wtt_linearize_fused_idx"] * slots + FLOPS["od_pair"] * pairs)
        account("B8 od", lambda: lin.wtt_contrib_rows_idx(*b8),
                lambda: lin.wtt_contrib_rows_idx_plain(*b8), nbytes(*b8[:5], rows),
                FLOPS["wtt_contrib_rows_idx"] * slots + FLOPS["od_pair"] * pairs)
        account("B5 [BAL]", lambda: mv.wtt_w_rows_idx(*b5),
                lambda: mv.wtt_w_rows_idx_plain(*b5),
                *live_slot_work("wtt_w_rows_idx", *b5[:4], rows_b5))
        account("B3 [BAL]", lambda: mv.wtt_wt_planes_idx(*b3),
                lambda: mv.wtt_wt_planes_idx_plain(*b3),
                *live_slot_work("wtt_wt_planes_idx", *b3, planes_b3))
        account("B4 [BAL]", lambda: wtt_cost.wtt_cost_cols_idx(*b4),
                lambda: wtt_cost.wtt_cost_cols_idx_plain(*b4), nbytes(*b4[:5], cols_b4),
                FLOPS["wtt_cost_cols_idx"] * slots)
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
        err_b7 = compare("B7 [BAL]", "f64", "poisoned", planes,
                         lin.wtt_cam_planes_idx_plain(wcam, d["tw"], tb), 0.0)
        jc, jp, r, v_inv, g_pt = route_planes(d, planes, cfg)
        jc, jp, r = nan_on(pad, jc, jp, r)
        b8 = (wcam, jc, jp, r, v_inv, 8, w, True, True)
        rows = lin.wtt_contrib_rows_idx(*b8)
        err_b8 = compare("B8 od", "f64", "poisoned", rows,
                         lin.wtt_contrib_rows_idx_plain(*b8), summed)
        b5 = (_sym3_matvec(v_inv, g_pt).contiguous(), wcam, jc, jp, w)
        rows_b5 = mv.wtt_w_rows_idx(*b5)
        err_b5 = compare("B5 [BAL]", "f64", "poisoned", rows_b5, mv.wtt_w_rows_idx_plain(*b5),
                         summed)
        b3 = (d["xw_t"], wcam, got[1], got[2])
        b4 = (wcam, d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.TRIVIAL)
        planes_b3 = mv.wtt_wt_planes_idx(d["xw_t"], wcam, *nan_on(pad, got[1], got[2]))
        err_b3, err_b4 = ordered_errs("B3 [BAL]", "B4 [BAL]", "f64 poisoned", planes_b3, b3,
                                      wtt_cost.wtt_cost_cols_idx(*b4), b4)
        if not all(torch.isfinite(x).all()
                   for x in (got[0], rows, rows_b5, planes_b3, planes)):
            raise AssertionError("f64 od: a poisoned padded slot reached an output")
        log(f"check f64 od BAL bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}, "
            f"{adjacent_pairs(wcam, g, tb, pc)} pairs, {int(pad.sum())} padded slots, "
            f"window row 0 NaN): B1 od {err_b1:.3e} B8 od {err_b8:.3e} B5 {err_b5:.3e} "
            f"B3 {err_b3:.3e} B4 {err_b4:.3e} B7 {err_b7:.3e}")


def grid_camera_inputs(grid, dtype):
    """B9's arguments on a grid problem at its initial parameters, cast to
    dtype: the plane form's (x_w gathered onto the grid) and the indexed
    form's (points3d and pt_idx), which the grid solve passes."""
    from tpu3drecon_torch.solvers.ba_pallas import _grid_planes, _inv_w, _uv_planes

    cam = tuple(getattr(grid.cameras, f).to(dtype) for f in CAM_FIELDS)
    pts = grid.points3d.to(dtype)
    tail = (_uv_planes(grid).to(dtype), grid.mask.to(dtype), _inv_w(grid, dtype))
    return (*cam, _grid_planes(pts, grid.pt_idx), *tail), (*cam, pts, grid.pt_idx, *tail)


def bit_equal(what: str, got, want) -> None:
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs")


def check_grid_cameras(row9: str, row11: str, tag: str, planes, idx, v_inv, losses):
    """B9 and B11 in both forms against their plain versions (B9's r, jp
    and jc bit for bit, U and g and B11's blocks to the summed tolerance),
    the indexed forms bit-equal to the plane forms and two calls bit-equal.
    Returns B9's trivial-loss kernel and plain outputs and B11's indexed
    arguments."""
    from tpu3drecon_torch.ops import cam_normal, coupling
    from tpu3drecon_torch.solvers.ba_pallas import _grid_planes, _vinv6

    summed = TOL[planes[0].dtype][1]
    pt_idx = idx[6]
    for loss in losses:
        got = cam_normal.cam_normal_idx(*idx, loss=loss)
        plain = cam_normal.cam_normal_idx_plain(*idx, loss=loss)
        err = max(compare(row9, tag, name, a, b, summed if name in ("u", "g") else 0.0)
                  for name, a, b in zip(("r", "jp", "jc", "u", "g"), got, plain))
        bit_equal(f"{row9} {tag} {loss.value} planes", got,
                  cam_normal.cam_normal_fused(*planes, loss=loss))
        bit_equal(f"{row9} {tag} {loss.value} again", got,
                  cam_normal.cam_normal_idx(*idx, loss=loss))
        log(f"check {tag} {row9} {loss.value}: {err:.3e} (planes and indexed bit-equal)")
        if loss == losses[0]:
            out_b9, plain_b9 = got, plain
    _, jp, jc, _, _ = plain_b9
    b11 = (jc, jp, v_inv, pt_idx)
    got = coupling.coupling_idx(*b11)
    err = compare(row11, tag, "", got, coupling.coupling_idx_plain(*b11), summed)
    bit_equal(f"{row11} {tag} planes", [got],
              [coupling.coupling_fused(jc, jp, _grid_planes(_vinv6(v_inv), pt_idx))])
    bit_equal(f"{row11} {tag} again", [got], [coupling.coupling_idx(*b11)])
    log(f"check {tag} {row11}: {err:.3e} (planes and indexed bit-equal)")
    return out_b9, plain_b9, b11, got


def account_grid_cameras(row9: str, row11: str, label: str, planes, idx, out_b9, b11,
                         out_b11) -> None:
    """Times the rows of B9 and B11 (f32, the indexed forms, what the grid
    solve calls) and logs beside them their lanes per thread, B9's and
    B11's kernels alone, the plane forms' times and both forms' bounds."""
    from tpu3drecon_torch.benchmark.wtt_bucket_times import kernel_alone_ms
    from tpu3drecon_torch.ops import cam_normal, coupling
    from tpu3drecon_torch.solvers.ba_pallas import _grid_planes, _vinv6

    c, k = idx[8].shape
    log(f"{label} grid (C, K) = ({c}, {k}): {c} blocks, "
        f"LPT = {cam_normal.grid_lanes(k, idx[8].element_size())}")
    flops9, flops11 = FLOPS["cam_normal_fused"] * c * k, FLOPS["coupling_fused"] * c * k
    account(row9, lambda: cam_normal.cam_normal_idx(*idx),
            lambda: cam_normal.cam_normal_idx_plain(*idx), nbytes(*idx, *out_b9), flops9)
    account(row11, lambda: coupling.coupling_idx(*b11),
            lambda: coupling.coupling_idx_plain(*b11), nbytes(*b11, out_b11), flops11)
    jc, jp, v_inv, pt_idx = b11
    vinv6_g = _grid_planes(_vinv6(v_inv), pt_idx)
    ms9 = device_ms(lambda: cam_normal.cam_normal_fused(*planes))
    ms11 = device_ms(lambda: coupling.coupling_fused(jc, jp, vinv6_g))
    alone9 = kernel_alone_ms(lambda: cam_normal.cam_normal_idx(*idx), "grid_cam_normal_kernel")
    alone11 = kernel_alone_ms(lambda: coupling.coupling_idx(*b11), "grid_coupling_kernel")
    bound9 = nbytes(*planes, *out_b9) / HBM_BYTES_PER_S * 1e3
    bound11 = nbytes(jc, jp, vinv6_g, out_b11) / HBM_BYTES_PER_S * 1e3
    log(f"B9 per {label} pass (f32, cold L2): cam_normal_idx {RESULTS[row9]['ms']:.6f} ms, "
        f"its kernel alone (profiler) {alone9:.6f} ms; plane form cam_normal_fused "
        f"{ms9:.6f} ms, bound {bound9:.6f} ms")
    log(f"B11 per {label} pass (f32, cold L2): coupling_idx {RESULTS[row11]['ms']:.6f} ms, "
        f"its kernel alone (profiler) {alone11:.6f} ms; plane form coupling_fused "
        f"{ms11:.6f} ms, bound {bound11:.6f} ms")


def check_grid_kernels(grid) -> None:
    """Phase 6: B9 and B11 in both forms against their plain versions, f32
    and f64 (``check_grid_cameras``), B9 under all three losses; B10 as the
    grid solve calls it, one grouped call over the track buckets, bit for
    bit; the f32 rows timed."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import cam_normal, point_normal
    from tpu3drecon_torch.solvers.ba_pallas import _track_gather

    p_num = grid.points3d.shape[0]
    losses = (RobustLoss.TRIVIAL, RobustLoss.CAUCHY, RobustLoss.HUBER)
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        lam = torch.tensor(1e-4, dtype=dtype, device=grid.points3d.device)
        planes, idx = grid_camera_inputs(grid, dtype)
        r, jp, _, _, _ = cam_normal.cam_normal_idx_plain(*idx)
        gathered = _track_gather(jp, r, grid)
        jp_gs, r_gs = [x for x, _ in gathered], [y for _, y in gathered]
        got = point_normal.point_normal_buckets(jp_gs, r_gs, lam)
        plain = point_normal.point_normal_buckets_plain(jp_gs, r_gs, lam)
        row = 0
        for bi, (jp_g, r_g) in enumerate(gathered):
            p, t2 = jp_g.shape[:2]
            err = max(compare("point_normal_fused", tag, name, a[row:row + p], b[row:row + p],
                              0.0)
                      for name, a, b in zip(("v_inv", "g_pt", "damp_pt"), got, plain))
            geo = point_normal.point_geometry(p, t2, jp_g.element_size(),
                                              point_normal.card_sms(jp_g.device))
            log(f"check {tag} grid B10 bucket {bi} (P={p} T2={t2}, {geo.blocks} blocks): "
                f"{err:.3e}")
            row += p
        if dtype == torch.float32:
            account("point_normal_fused",
                    lambda: point_normal.point_normal_buckets(jp_gs, r_gs, lam),
                    lambda: point_normal.point_normal_buckets_plain(jp_gs, r_gs, lam),
                    nbytes(*jp_gs, *r_gs, lam, *got),
                    sum(FLOPS["point_normal_row"] * r_g.numel()
                        + FLOPS["point_normal_point"] * r_g.shape[0] for r_g in r_gs))

        out_b9, _, b11, out_b11 = check_grid_cameras(
            "cam_normal_idx", "coupling_idx", tag, planes, idx, plain[0][:p_num], losses)
        if dtype == torch.float32:
            account_grid_cameras("cam_normal_idx", "coupling_idx", "medium", planes, idx,
                                 out_b9, b11, out_b11)


def check_grid1024_kernels(grid) -> None:
    """B9 and B11 on the grid packing of tt_seq1024 (f32), (C, K) = (1024,
    1024), one lane a thread: both forms checked as in phase 6, with V^-1 of
    B10's plain version, and timed as the ``B9 [C=1024]`` and ``B11
    [C=1024]`` rows."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import point_normal
    from tpu3drecon_torch.ops.cam_normal import cam_normal_idx_plain
    from tpu3drecon_torch.solvers.ba_pallas import _track_gather

    row9, row11 = "B9 [C=1024]", "B11 [C=1024]"
    planes, idx = grid_camera_inputs(grid, torch.float32)
    r, jp, _, _, _ = cam_normal_idx_plain(*idx)
    gathered = _track_gather(jp, r, grid)
    v_inv = point_normal.point_normal_buckets_plain(
        [x for x, _ in gathered], [y for _, y in gathered],
        torch.tensor(1e-4, device=jp.device))[0][:grid.points3d.shape[0]]
    out_b9, _, b11, out_b11 = check_grid_cameras(
        row9, row11, "f32", planes, idx, v_inv,
        (RobustLoss.TRIVIAL, RobustLoss.CAUCHY, RobustLoss.HUBER))
    account_grid_cameras(row9, row11, "C=1024", planes, idx, out_b9, b11, out_b11)


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
    """Phase 8: B12-B16 against their plain versions, f32 and f64, B16's
    per-point partials bit for bit; B16's kernel alone (its partials,
    without the wrapper's sum and product) timed beside its function."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import tt_linearize as tt
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    c = problem.n_cameras
    alone = 0.0
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
                compare("tt_cost_fused", tag, "partials", tt._cost_lanes(*b16_args),
                        tt._cost_lanes_plain(*b16_args), 0.0)
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
            alone += device_ms(lambda: tt._cost_lanes(*b16_args))
    log(f"B16 per medium pass (f32, cold L2): tt_cost_fused {RESULTS['tt_cost_fused']['ms']:.6f}"
        f" ms, its kernel alone {alone:.6f} ms")


def check_poisoned(kernel: str, tag: str, output: str, fn, plain, rel,
                   time_global: bool = False) -> float:
    """``fn()`` against ``plain()`` on inputs with poisoned padded slots:
    outputs finite and within ``rel``.  For B15 and B5 also
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
    padded slots on it; NaN jc/jp/r on padded slots for B3, B5 and B8, and
    window row 0 of x NaN for B3; B3 and B4 also exactly against their
    ordered plain forms; for the tt kernels an extra NaN camera that only
    padded slots carry); B15 and
    B5 also in their forced global-memory mode, whose f32 device time per
    pass is their ``global_ms``."""
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
            r = torch.randn(2, g, tb, pc, generator=torch.Generator().manual_seed(bi),
                            dtype=torch.float64).to(jc.device, dtype)
            jc_n, jp_n, r_n = nan_on(pad, jc, jp, r)
            # B3 with window row 0 of x NaN too; both bit for bit.
            xw_n = d["xw_t"].clone()
            xw_n[:, :, 0] = float("nan")
            b4 = (wcam, d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.TRIVIAL)
            planes = mv.wtt_wt_planes_idx(xw_n, wcam, jc_n, jp_n)
            cols = wtt_cost.wtt_cost_cols_idx(*b4)
            if not (torch.isfinite(planes).all() and torch.isfinite(cols).all()):
                raise AssertionError(f"B3/B4 {tag}: a poisoned padded slot reached an output")
            errs["B3"], errs["B4"] = ordered_errs(
                "wtt_wt_planes_idx", "wtt_cost_cols_idx", f"{tag} poisoned", planes,
                (xw_n, wcam, jc, jp), cols, b4)
            onehot = (wcam[:, None, :] == torch.arange(w, device=wcam.device)[None, :, None])
            b6 = (d["xw_t"], onehot.to(torch.int8), jc, jp, v_inv)
            errs["B6"] = check_poisoned(
                "wtt_coupling_rows_fused", tag, "rows",
                lambda: mv.wtt_coupling_rows_fused(*b6),
                lambda: mv.wtt_coupling_rows_fused_plain(*b6), summed)
            b5 = (_sym3_matvec(v_inv, g_pt).contiguous(), wcam, jc_n, jp_n, w)
            errs["B5"] = check_poisoned(
                "wtt_w_rows_idx", tag, "rows", lambda **kw: mv.wtt_w_rows_idx(*b5, **kw),
                lambda: mv.wtt_w_rows_idx_plain(*b5), summed, time_global=t)
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
    log("B15 and B5, device ms per pass (f32, cold L2), picked mode -> global mode forced: "
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
    tile of 8,192 entries measured slower), B16 as ``B16 [C=1024]`` (its
    partials bit for bit, its kernel alone also timed)."""
    from tpu3drecon_torch.ops import tt_linearize as tt_ops
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    elem, summed = TOL[torch.float32]
    row, row13 = "B12 [C=1024]", "B13 [C=1024]"
    row14, row15, row16 = "B14 [C=1024]", "B15 [C=1024]", "B16 [C=1024]"
    c = tt.n_cameras
    alone = 0.0
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
        b16 = args[:7]
        cost = tt_ops.tt_cost_fused(*b16)
        errs["B16"] = compare(row16, "f32", "", cost, tt_ops.tt_cost_fused_plain(*b16), elem)
        compare(row16, "f32", "partials", tt_ops._cost_lanes(*b16),
                tt_ops._cost_lanes_plain(*b16), 0.0)
        modes = {k: mode_of(counters()[n], before[n]) for k, n in (
            ("B12", "tt_cam_normal_fused"), ("B13", "tt_coupling_fused"),
            ("B14", "tt_wt_times_fused"), ("B15", "tt_w_times_fused"),
            ("B16", "tt_cost_fused"))}
        ms = timed(row, lambda: tt_ops.tt_cam_normal_fused(*args))
        ms13, ms14, ms15, ms16 = (RESULTS[r]["ms"] for r in (row13, row14, row15, row16))
        account(row13, lambda: tt_ops.tt_coupling_fused(*b13),
                lambda: tt_ops.tt_coupling_fused_plain(*b13), nbytes(*b13[:5], coup),
                FLOPS["tt_coupling_fused"] * tb * pb)
        account(row14, lambda: tt_ops.tt_wt_times_fused(*b14),
                lambda: tt_ops.tt_wt_times_fused_plain(*b14), nbytes(*b14, wtx),
                FLOPS["tt_wt_times_fused"] * tb * pb)
        account(row15, lambda: tt_ops.tt_w_times_fused(*b15),
                lambda: tt_ops.tt_w_times_fused_plain(*b15), nbytes(*b15[:5], wy),
                FLOPS["tt_w_times_fused"] * tb * pb)
        account(row16, lambda: tt_ops.tt_cost_fused(*b16),
                lambda: tt_ops.tt_cost_fused_plain(*b16), nbytes(*b16[:6], cost),
                FLOPS["tt_cost_fused"] * tb * pb)
        alone += device_ms(lambda: tt_ops._cost_lanes(*b16))
        log(f"check f32 tt_seq1024 bucket {bi} (C={c} Tb={tb} Pb={pb}): "
            + " ".join(f"{k} {v:.3e} [{modes[k]}]" for k, v in errs.items())
            + f"; B12 {ms:.6f} ms, B13 {RESULTS[row13]['ms'] - ms13:.6f} ms, "
            f"B14 {RESULTS[row14]['ms'] - ms14:.6f} ms, "
            f"B15 {RESULTS[row15]['ms'] - ms15:.6f} ms, "
            f"B16 {RESULTS[row16]['ms'] - ms16:.6f} ms")
        RESULTS[row]["ms"] += ms
        RESULTS[row]["plain_ms"] += device_ms(lambda: tt_ops.tt_cam_normal_fused_plain(*args))
        RESULTS[row]["bytes"] += nbytes(*args[:6], *got)
        RESULTS[row]["flops"] += FLOPS["tt_cam_normal_fused"] * tb * pb
    log(f"B16 per tt_seq1024 pass (f32, cold L2): tt_cost_fused {RESULTS[row16]['ms']:.6f} ms, "
        f"its kernel alone {alone:.6f} ms")


def flat_pass(lin_row: str, cpl_row: str, tag: str, args, n_cameras: int, n_points: int,
              loss, timed_pass: bool, optimize_dist: bool = False) -> dict:
    """One linearization of the flat kernels (``linearize`` and its
    ``coupling``) against the plain version on the same inputs, 8 camera
    columns or 10 with ``optimize_dist``: U, V, g_c, g_p and the coupling as
    sums, W per element, the coupling on the V^-1 of the plain sums damped
    as the solver damps them (lam 1e-4).  With ``timed_pass`` (f32) both
    rows also get their device times, and their bytes and operations from
    ``portbench/flat_roofline.py``.  Returns the errors relative to
    max|plain|."""
    from portbench import flat_roofline
    from tpu3drecon_torch.benchmark.wtt_bucket_times import kernel_alone_ms
    from tpu3drecon_torch.ops import flat_linearize as fl
    from tpu3drecon_torch.solvers import schur

    elem, summed = TOL[args[5].dtype]
    lam = torch.tensor(1e-4, dtype=args[5].dtype, device=args[5].device)

    def lin():
        return fl.linearize(*args, n_cameras, n_points, loss=loss, optimize_dist=optimize_dist)

    def plain():
        return fl.linearize_plain(*args, n_cameras, n_points, loss=loss,
                                  optimize_dist=optimize_dist)

    got, want = lin(), plain()
    np_cam = 8 + 2 * optimize_dist
    if got.u.shape[-1] != np_cam or want.w.shape[1:] != (np_cam, 3):
        raise AssertionError(f"flat {tag}: U {tuple(got.u.shape)}, plain W "
                             f"{tuple(want.w.shape)} at {np_cam} camera columns")
    errs = {}
    for k in ("u", "v", "w", "g_cam", "g_pt"):
        a, b = getattr(got, k), getattr(want, k)
        errs[k] = compare(lin_row, tag, k, a, b, elem if k == "w" else summed) / max(
            float(torch.max(torch.abs(b))), 1e-300)
    v_inv = schur.damp_normal_blocks(want, lam, precond="jacobi_u").v_inv
    cpl, cpl_plain = got.coupling(v_inv), want.coupling(v_inv)
    errs["coupling"] = compare(cpl_row, tag, "", cpl, cpl_plain, summed) / max(
        float(torch.max(torch.abs(cpl_plain))), 1e-300)
    if timed_pass:
        shape = (args[8].shape[0], n_cameras, n_points, np_cam, args[5].element_size())
        for row, kernel, fn, plain_fn in (
                (lin_row, "lin_kernel", lin, plain),
                (cpl_row, "coupling_kernel", lambda: got.coupling(v_inv),
                 lambda: want.coupling(v_inv))):
            account(row, fn, plain_fn, flat_roofline.launch_bytes(kernel, *shape),
                    flat_roofline.obs_flops(kernel, np_cam) * shape[0])
        errs["lin_kernel_alone_ms"] = kernel_alone_ms(lin, "flat_lin_kernel")
        errs["coupling_kernel_alone_ms"] = kernel_alone_ms(lambda: got.coupling(v_inv),
                                                           "flat_coupling_kernel")
    return errs


def flat_args(cams, points3d, cam_idx, pt_idx, uv, mask, inv_width: float, dtype):
    """``flat_linearize.linearize``'s arguments through ``inv_width``: the
    float tensors cast to ``dtype``, all contiguous."""
    def t(x):
        return x.to(dtype).contiguous()

    return (*(t(getattr(cams, f)) for f in CAM_FIELDS), t(points3d), cam_idx.contiguous(),
            pt_idx.contiguous(), t(uv), t(mask),
            torch.as_tensor(inv_width, dtype=dtype, device=points3d.device))


def check_flat_kernels(flat) -> None:
    """Phase 10b: the flat kernels against their plain versions, on the
    medium problem (trivial loss in f32 and f64, the Cauchy and Huber losses
    in f64; at 8 camera columns, then at 10 with k1, k2 set on every
    camera) and at the benchmark's flat shapes (portbench's generator, the
    trivial loss in f32, at the width its cells run); the f32 passes at
    8 columns on the medium problem and every pass at the flat shapes
    timed."""
    from portbench import generator
    from tpu3drecon_torch.geometry.losses import RobustLoss

    trivial = RobustLoss.TRIVIAL
    inv_w = 1.0 / flat.avg_cam_width
    c, p = flat.n_cameras, flat.n_points
    gen = torch.Generator(device="cpu").manual_seed(FLAT_SEED)
    # k1, k2 of a consumer lens on normalized coordinates (the medium
    # problem's cameras have none), so that every k term is live.
    dist = (torch.tensor([-0.1, 0.02], dtype=torch.float64)
            * (0.5 + torch.rand(c, 2, generator=gen, dtype=torch.float64)))
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        args = flat_args(flat.cameras, flat.points3d, flat.cam_idx, flat.pt_idx, flat.uv,
                         flat.mask, inv_w, dtype)
        losses = (trivial,) if dtype == torch.float32 else (trivial, RobustLoss.CAUCHY,
                                                          RobustLoss.HUBER)
        for loss in losses:
            errs = flat_pass("flat_lin_kernel", "flat_coupling_kernel", tag, args, c, p, loss,
                             timed_pass=dtype == torch.float32)
            log(f"check {tag} flat medium {loss.value}: " + json.dumps(errs))
        args = args[:4] + (dist.to(dtype=dtype, device=flat.points3d.device),) + args[5:]
        for loss in losses:
            errs = flat_pass("flat_lin_kernel", "flat_coupling_kernel", f"{tag} np=10", args,
                             c, p, loss, timed_pass=False, optimize_dist=True)
            log(f"check {tag} flat medium np=10 {loss.value}: " + json.dumps(errs))
    for name, label, optimize_dist in FLAT_SHAPES:
        with open(f"portbench/configs/{name}.json") as fh:
            cfg = json.load(fh)
        inp = generator.make_inputs(cfg, FLAT_SEED, flat.points3d.device, torch.float32)
        mask = torch.ones(inp.n_obs, dtype=torch.float32, device=inp.points3d.device)
        args = flat_args(inp, inp.points3d, inp.cam_idx, inp.pt_idx, inp.uv, mask,
                         1.0 / inp.width, torch.float32)
        errs = flat_pass(f"flat_lin_kernel [{label}]", f"flat_coupling_kernel [{label}]",
                         "f32", args, inp.n_cameras, inp.n_points, trivial, timed_pass=True,
                         optimize_dist=optimize_dist)
        log(f"check f32 flat {label} ({inp.n_cameras} cameras, {inp.n_points} points, "
            f"{inp.n_obs} observations, {8 + 2 * optimize_dist} camera columns, max|k| "
            f"{float(inp.dist.abs().max()):.4f}, seed {FLAT_SEED}): " + json.dumps(errs))
        del inp, args
        torch.cuda.empty_cache()


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


def solve_line(path: str, warm_s: float, times, report: dict) -> None:
    log(f"solve {path} " + json.dumps(dict(
        median_s=statistics.median(times), min_s=min(times), max_s=max(times),
        warmup_s=warm_s, **report)))


def no_port_kernel(path: str, counts: dict) -> None:
    """These solvers reach no Pallas kernel in JAX and no kernel of the
    TPU port here (``KERNELS``): nothing counted since ``counts`` were set
    to 0."""
    ran = {n: (c.kernel, c.plain) for n, c in counts.items() if c.kernel or c.plain}
    if ran:
        raise AssertionError(f"{path}: port kernels or plain versions ran: {ran}")


def flat_widths(path: str, solve, np_cam: int) -> dict:
    """One more ``solve()`` of ``path`` with the program's counters on
    (``utils/timing.py``): every flat launch must be at ``np_cam`` camera
    columns, a coupling launch beside each linearization.  Returns the
    launches by width."""
    from tpu3drecon_torch.utils import timing

    timing.reset()
    with timing.recording():
        solve()
    counts = timing.tally()["counts"]
    timing.reset()
    got = {k: v for k, v in counts.items() if k.startswith("flat.") and k.count(".") == 2}
    n = counts.get("flat.lin_kernel", 0)
    want = {f"flat.lin_kernel.np{np_cam}": n, f"flat.coupling_kernel.np{np_cam}": n}
    log(f"widths {path}: " + json.dumps(got))
    if not n or got != want:
        raise AssertionError(f"{path}: flat launches by width {got}, expected {want}")
    return got


def run_solvers(flat) -> dict:
    """Phase 11: the flat engine on the medium problem, batched PnP,
    tracking, intrinsics refinement and the calibration alternation, each
    one warm-up and 3 timed solves, each held to its check.  Returns the
    flat kernels' launch counts over the medium flat solves."""
    import numpy as np

    from tpu3drecon_torch.benchmark import solver_cells as cells
    from tpu3drecon_torch.benchmark.medium_config import BENCH_CONFIG, timed_solve_stats
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.solvers.bundle_adjust import ba_solve, reprojection_rmse
    from tpu3drecon_torch.solvers.intrinsics_refine import (
        ba_with_intrinsics_calibration,
        refine_intrinsics,
    )
    from tpu3drecon_torch.solvers.pose_refine import refine_poses

    counts = counters()

    def reset():
        for cnt in counts.values():
            cnt.reset()

    def lanes(state) -> dict:
        return dict(iter_num=state.iter_num.tolist(), accepted=state.accepted.tolist())

    _, _, init = ba_solve(flat, BENCH_CONFIG._replace(maxiter=0))
    reset()
    warm_s, times, (cams, pts, state) = timed_solve_stats(
        lambda p: ba_solve(p, BENCH_CONFIG), flat, 3)
    rmse = float(reprojection_rmse(flat, cams, pts))
    launches = path_launches(FLAT, counts)
    ok = rmse < 1e-3 and float(state.loss) < float(init.loss) and int(state.accepted) > 0
    solve_line(FLAT, warm_s, times, dict(
        reproj_rmse_px=rmse, initial_loss=float(init.loss), final_loss=float(state.loss),
        lm_iters=int(state.iter_num), accepted_steps=int(state.accepted),
        cg_iters_last=int(state.cg_iters),
        launches_per_solve={n: v / 4 for n, v in launches.items()},
        check="rmse < 1e-3 px", ok=ok))
    if not ok:
        raise AssertionError(f"flat: RMSE {rmse:.3e} px, or the loss did not fall")
    flat_widths(FLAT, lambda: ba_solve(flat, BENCH_CONFIG), 8)
    # The same solve with k1, k2 among the LM parameters: the kernels' NP =
    # 10 instances, every flat launch at that width.
    dist_config = BENCH_CONFIG._replace(optimize_dist=True)
    drive(FLAT_DIST, lambda p, **kw: ba_solve(p, dist_config._replace(**kw)), flat, flat, 3)
    flat_widths(FLAT_DIST, lambda: ba_solve(flat, dist_config), 10)

    problem, noisy = cells.pnp_problem()
    reset()
    warm_s, times, (cams, state) = timed_solve_stats(
        lambda p: refine_poses(p, loss=RobustLoss.TRIVIAL, config=cells.PNP_CONFIG), problem, 3)
    path_launches("pnp", counts)
    oracle = cells.pnp_scipy_oracle(problem, noisy)
    parity = cells.pnp_parity(cams, oracle)
    ok = parity["max_rot_geodesic_err_rad"] < 1e-4 and parity["max_tvec_err"] < 2e-3
    solve_line("pnp", warm_s, times, dict(
        cameras=problem.batch, padded_points=problem.max_points, scipy_oracle_s=oracle[3],
        **parity, **lanes(state),
        check="rotation < 1e-4 rad and tvec < 2e-3 against scipy", ok=ok))
    if not ok:
        raise AssertionError(f"pnp: parity against scipy {parity}")

    problem, scene = cells.tracking_problem()
    reset()
    warm_s, times, (cams, state) = timed_solve_stats(
        lambda p: refine_poses(p, config=cells.TRACKING_CONFIG), problem, 3)
    path_launches("tracking", counts)
    t_err = float(np.median(np.abs(cams.tvecs.double().cpu().numpy() - scene.tvecs)))
    ok = t_err < 1e-3
    solve_line("tracking", warm_s, times, dict(
        frames=problem.batch, padded_points=problem.max_points,
        ms_per_frame=statistics.median(times) / problem.batch * 1e3,
        median_tvec_err=t_err, max_iter_num=int(state.iter_num.max()),
        min_iter_num=int(state.iter_num.min()), accepted_total=int(state.accepted.sum()),
        check="median |tvec - truth| < 1e-3", ok=ok))
    if not ok:
        raise AssertionError(f"tracking: median tvec error {t_err:.3e}")

    problem, scene = cells.intrinsics_problem()
    reset()
    warm_s, times, (cams, state) = timed_solve_stats(
        lambda p: refine_intrinsics(p, config=cells.INTRINSICS_CONFIG), problem, 3)
    path_launches("intrinsics", counts)
    f_rel = float(np.max(np.abs(cams.fx_fy.cpu().numpy() / scene.fx_fy - 1.0)))
    d_abs = float(np.max(np.abs(cams.dist.cpu().numpy() - scene.dist)))
    ok = f_rel <= 1e-6 and d_abs <= 1e-6
    solve_line("intrinsics", warm_s, times, dict(
        cameras=problem.batch, dtype="float64", max_focal_rel_err=f_rel,
        max_dist_abs_err=d_abs, max_iter_num=int(state.iter_num.max()),
        accepted_total=int(state.accepted.sum()),
        check="fx/fy rtol 1e-6, dist atol 1e-6", ok=ok))
    if not ok:
        raise AssertionError(f"intrinsics: focal rel err {f_rel:.3e}, dist err {d_abs:.3e}")

    problem = cells.calib_problem()
    reset()
    warm_s, times, (cams, pts, state) = timed_solve_stats(
        lambda p: ba_with_intrinsics_calibration(p, rounds=8), problem, 3)
    calib = path_launches(CALIB, counts)
    k1 = cams.dist[:, 0].cpu().numpy()
    rmse = float(reprojection_rmse(problem, cams, pts))
    ok = bool(np.all(k1 < -0.06) and np.all(k1 > -0.14)) and rmse < 0.06
    solve_line(CALIB, warm_s, times, dict(
        rounds=8, dtype="float64", k1=k1.tolist(), reproj_rmse_px=rmse,
        lm_iters_last=int(state.iter_num), accepted_last=int(state.accepted),
        launches_per_solve={n: v / 4 for n, v in calib.items()},
        check="k1 in (-0.14, -0.06), rmse < 0.06 px", ok=ok))
    if not ok:
        raise AssertionError(f"calib: k1 {k1}, RMSE {rmse:.3e} px")
    return launches


def same_records(what: str, got, want) -> None:
    """Two packed COLMAP record groups equal field for field, bit for bit."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        same = g == w if isinstance(w, list) else (
            g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w))
        if not same:
            raise AssertionError(f"{what}: the native and numpy readers differ in {f.name}")


def run_files(flat, smi: str) -> None:
    """Phase 12: the grid engine on the medium problem, then the paths from
    file to solve to file (COLMAP binary, BAL, the Dataset objects), each
    solve 1 warm-up and 3 timed, each part held to its checks."""
    import dataclasses
    import tempfile

    import numpy as np

    from tpu3drecon_torch.benchmark.file_cells import write_ladybug49_like
    from tpu3drecon_torch.benchmark.medium_config import (
        BENCH_CONFIG,
        N_CAMERAS,
        N_POINTS,
        OBS_PER_CAMERA,
        SEED,
        timed_solve_stats,
    )
    from tpu3drecon_torch.dataset import (
        load_colmap_dataset,
        make_scene,
        perturb_scene,
        scene_to_colmap_model,
    )
    from tpu3drecon_torch.geometry.alignment import alignment_errors, umeyama_alignment
    from tpu3drecon_torch.geometry.pose import camera_center
    from tpu3drecon_torch.io import colmap as cio
    from tpu3drecon_torch.io.bal import ba_problem_from_bal, export_bal, read_bal
    from tpu3drecon_torch.io.colmap import binary, native
    from tpu3drecon_torch.problems.from_dataset import ba_problem_from_dataset
    from tpu3drecon_torch.problems.grid import grid_from_flat
    from tpu3drecon_torch.problems.packing import (
        ba_problem_from_colmap,
        colmap_model_with_solution,
    )
    from tpu3drecon_torch.solvers.ba_grid import ba_solve_grid
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, reprojection_rmse

    dev = flat.points3d.device
    counts = counters()

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def grid_solve(path: str, problem, config) -> tuple:
        """grid_from_flat, then 1 warm-up + 3 timed ba_solve_grid with every
        count at 0; the loss must fall with an accepted step."""
        grid, pack_s = clock(lambda: grid_from_flat(problem))
        _, _, init = ba_solve_grid(grid, config._replace(maxiter=0))
        for cnt in counts.values():
            cnt.reset()
        warm_s, times, (cams, pts, state) = timed_solve_stats(
            lambda g: ba_solve_grid(g, config), grid, 3)
        no_port_kernel(path, counts)
        report = dict(
            grid_pack_s=pack_s, median_s=statistics.median(times), min_s=min(times),
            max_s=max(times), warmup_s=warm_s,
            reproj_rmse_px=float(reprojection_rmse(problem, cams, pts)),
            initial_loss=float(init.loss), final_loss=float(state.loss),
            lm_iters=int(state.iter_num), accepted_steps=int(state.accepted),
            cg_iters_last=int(state.cg_iters), grid_ck=list(grid.mask.shape),
            track_slots=list(grid.track_idx.shape),
        )
        if not float(state.loss) < float(init.loss):
            raise AssertionError(f"{path}: the final loss is not finite and below the initial")
        if int(state.accepted) < 1:
            raise AssertionError(f"{path}: no step was accepted")
        return report, cams, pts

    def line(path: str, report: dict, check: str) -> None:
        log(f"solve {path} " + json.dumps(dict(card=smi, **report, check=check)))

    # (a) ba_grid: the JAX CLI's --engine grid on the medium problem.
    report, _, _ = grid_solve("ba_grid", flat, BENCH_CONFIG)
    line("ba_grid", report, "rmse < 1e-3 px")
    if not report["reproj_rmse_px"] < 1e-3:
        raise AssertionError(f"ba_grid: RMSE {report['reproj_rmse_px']:.3e} px")

    f32 = torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        # (b) solve-colmap: the medium scene's perturbed parameters with its
        # clean observations, as build_problem pairs them.
        def medium_scene():
            sc = make_scene(n_cameras=N_CAMERAS, n_points=N_POINTS,
                            obs_per_camera=OBS_PER_CAMERA, seed=SEED)
            return sc, perturb_scene(sc, seed=SEED + 1, point2d_noise=0.5)

        (scene, noisy), scene_s = clock(medium_scene)
        model = scene_to_colmap_model(dataclasses.replace(noisy, uv=scene.uv))
        _, write_in_s = clock(lambda: cio.write_model(model, f"{tmp}/in", binary=True))
        lib, build_s = clock(native.load_library)  # g++ at first use
        if lib is None:
            raise AssertionError("files colmap: the native reader did not build")
        native.COUNTS.reset()
        m, read_s = clock(lambda: cio.read_model(f"{tmp}/in"))
        if native.COUNTS.native != {"images": 1, "points3d": 1} or native.COUNTS.numpy:
            raise AssertionError(f"files colmap: the native reader did not parse both files: "
                                 f"native {native.COUNTS.native}, numpy {native.COUNTS.numpy}")
        (images, points), numpy_read_s = clock(lambda: (
            binary.read_images_bin(f"{tmp}/in/images.bin", use_native=False),
            binary.read_points3d_bin(f"{tmp}/in/points3D.bin", use_native=False)))
        same_records("images.bin", m.images, images)
        same_records("points3D.bin", m.points, points)
        (problem, meta), pack_s = clock(
            lambda: ba_problem_from_colmap(m, dtype=f32, device=dev))
        report, cams, pts = grid_solve("files colmap", problem, BENCH_CONFIG)
        _, write_s = clock(lambda: cio.write_model(
            colmap_model_with_solution(m, cams, pts, meta), f"{tmp}/out", binary=True))
        (back, _), reread_s = clock(lambda: ba_problem_from_colmap(
            cio.read_model(f"{tmp}/out"), dtype=f32, device=dev))
        rmse = report["reproj_rmse_px"]
        rmse_re = float(reprojection_rmse(back, back.cameras, back.points3d))
        line("files colmap", dict(
            images=len(m.images), points=len(m.points), observations=meta.n_real_obs,
            scene_s=scene_s, write_input_s=write_in_s, native_build_s=build_s,
            read_native_s=read_s,
            read_numpy_s=numpy_read_s, pack_s=pack_s, **report, write_s=write_s,
            reread_pack_s=reread_s, reread_rmse_px=rmse_re,
            native_reads=dict(native.COUNTS.native)),
            "native == numpy records bit for bit, rmse < 1e-3 px, |reread - rmse| < 1e-3 px")
        if not (rmse < 1e-3 and abs(rmse_re - rmse) < 1e-3):
            raise AssertionError(f"files colmap: RMSE {rmse:.3e} px, re-read {rmse_re:.3e} px")

        # (c) solve-bal on a file of Ladybug problem-49's shape.
        bal_path = f"{tmp}/ladybug49.txt"
        info, gen_s = clock(lambda: write_ladybug49_like(bal_path, seed=49))
        native.COUNTS.reset()
        _, read_s = clock(lambda: read_bal(bal_path))
        (bal, _), load_s = clock(lambda: ba_problem_from_bal(bal_path, dtype=f32, device=dev))
        if native.COUNTS.native != {"bal": 2} or native.COUNTS.numpy:
            raise AssertionError(f"files bal: the native tokenizer did not parse the file: "
                                 f"native {native.COUNTS.native}, numpy {native.COUNTS.numpy}")
        rmse0 = float(reprojection_rmse(bal, bal.cameras, bal.points3d))
        config = BAConfig(maxiter=50, gtol=1e-10, cg_maxiter=30, cg_rtol=1e-6,
                          optimize_focal=False)
        report, cams, pts = grid_solve("files bal", bal, config)
        _, write_s = clock(lambda: export_bal(f"{tmp}/ladybug49_solved.txt", bal, cams, pts))
        (back, _), reload_s = clock(lambda: ba_problem_from_bal(
            f"{tmp}/ladybug49_solved.txt", dtype=f32, device=dev))
        rmse = report["reproj_rmse_px"]
        rmse_re = float(reprojection_rmse(back, back.cameras, back.points3d))
        line("files bal", dict(
            **info, generate_s=gen_s, read_native_s=read_s, read_pack_s=load_s,
            initial_rmse_px=rmse0, **report, write_s=write_s, reload_s=reload_s,
            reload_rmse_px=rmse_re),
            "rmse falls, |reload - rmse| < 1e-3 px")
        if not (rmse < rmse0 and abs(rmse_re - rmse) < 1e-3):
            raise AssertionError(f"files bal: RMSE {rmse0:.4f} -> {rmse:.4f} px, reloaded "
                                 f"{rmse_re:.4f} px")

        # (d) the dataset path on (b)'s model.
        ds, load_s = clock(lambda: load_colmap_dataset(f"{tmp}/in", binary=True))
        (dproblem, dmeta), dpack_s = clock(
            lambda: ba_problem_from_dataset(ds, dtype=f32, device=dev))

        def obs_rows(p, pm):
            keep = p.mask.cpu().numpy() > 0
            uv = p.uv.cpu().numpy()[keep].astype(np.float64)
            rows = np.stack([p.cam_idx.cpu().numpy()[keep].astype(np.float64),
                             pm.point_ids[p.pt_idx.cpu().numpy()[keep]].astype(np.float64),
                             uv[:, 0], uv[:, 1]], axis=1)
            return rows[np.lexsort(rows.T[::-1])]

        if not np.array_equal(obs_rows(dproblem, dmeta), obs_rows(problem, meta)):
            raise AssertionError("files dataset: its observations differ from the colmap path's")
        report, cams, pts = grid_solve("files dataset", dproblem, BENCH_CONFIG)
        solved = camera_center(cams.rmats.double().cpu(), cams.tvecs.double().cpu())
        truth = camera_center(torch.from_numpy(scene.rmats), torch.from_numpy(scene.tvecs))
        sim = umeyama_alignment(solved, truth)
        err = float(torch.median(alignment_errors(sim, solved, truth)))
        extent = float(torch.linalg.vector_norm(truth.max(0).values - truth.min(0).values))
        rmse = report["reproj_rmse_px"]
        line("files dataset", dict(
            entries=len(ds.datasetEntries), points3d=len(ds.points3D),
            points2d=sum(e.num_2d_points for e in ds.datasetEntries),
            observations=dmeta.n_real_obs, load_s=load_s, pack_s=dpack_s, **report,
            median_centre_err=err, extent=extent, rel_centre_err=err / extent),
            "same observations as files colmap, rmse < 1e-3 px, median centre error "
            "< 1e-6 of the extent")
        if not (rmse < 1e-3 and err < 1e-6 * extent):
            raise AssertionError(f"files dataset: RMSE {rmse:.3e} px, median centre error "
                                 f"{err:.3e} of extent {extent:.3e}")

        run_cli(tmp, smi, dev)  # phase 12b, on this phase's files


def path_launches(path: str, counts: dict) -> dict:
    """The launch counts of ``path``'s kernels since the counts were set to
    0; raises if one of them did not launch or a plain version ran."""
    mine = {name for _, _, name, _, _, paths, *_ in KERNELS if path in paths}
    got = {n: counts[n].kernel for n in mine}
    plain = {n: c.plain for n, c in counts.items() if c.plain}
    if not mine:
        no_port_kernel(path, counts)
    missing = [n for n, v in got.items() if v == 0]
    if missing:
        raise AssertionError(f"{path}: kernels not launched: {missing}")
    if plain:
        raise AssertionError(f"{path}: plain versions ran: {plain}")
    return got


def open_nccl_mesh(store_dir: str):
    """Phase 12c's group: NCCL, one rank on card 0 (the machine has one card,
    and NCCL takes one rank per device).  No fallback: a failed NCCL start
    fails the run."""
    import torch.distributed as dist

    from tpu3drecon_torch.parallel.distributed import global_obs_mesh, initialize_distributed

    torch.cuda.set_device(0)
    initialize_distributed(f"file://{store_dir}/nccl_store", world_size=1, rank=0,
                           backend="nccl", timeout_s=600)
    mesh = global_obs_mesh(device="cuda:0")
    if dist.get_backend() != "nccl" or mesh.size != 1:
        raise AssertionError(f"expected NCCL at world size 1, got {dist.get_backend()} "
                             f"at {mesh.size}")
    log(f"sharded: NCCL group (torch.distributed), world size {mesh.size}, rank "
        f"{mesh.rank}, device {mesh.device}")
    return mesh


def sharded_pair(path: str, mesh, sharded, single, problem, rmse_fn, exact: bool,
                 repeats: int = 3, rmse_limit=1e-3) -> tuple:
    """One sharded path beside its single-device engine in this call: the
    single-device solve once, then 1 warm-up + ``repeats`` timed of each,
    every count set to 0 just before the sharded solves and read just
    after; ``rmse_fn(cameras, points)`` gives the reprojection RMSE in
    pixels.  ``exact`` (wtt, tt): where the single-device solve repeats its
    own loss bits, the same ``accepted``, ``iter_num`` and ``cg_iters`` and
    the same loss bits (JAX's single-device-mesh test); where its float
    atomics make it vary from run to run, both at the float32 rounding
    floor (RMSE below 1e-4 px, where the loss is rounding noise), or all
    of: the most common (``iter_num``, ``accepted``, ``cg_iters``) of the
    sharded solves equal to that of the single-device solves, the median
    sharded loss within 50 % of the median single-device loss (the
    3-iteration BAL hub split varies ~35 % between identical float32
    solves), and the median reprojection RMSE of the returned cameras and
    points within 10 % of the single-device solves' (the last solves'
    RMSEs differed by 0.7-2.0 % in three runs, ``PERF.md`` PR 18; a fault
    in how the sharded wrapper gathers or unpermutes its outputs moves the
    RMSE by far more).  Otherwise (grid, flat, pose): the loss within 1e-3
    relative, or the rounding floor.  Every RMSE below ``rmse_limit``
    (None: no limit).  Returns (the report, the sharded cameras)."""
    from tpu3drecon_torch.benchmark.medium_config import timed_solve_stats

    def recorded(fn, solves):
        def run(p):
            out = fn(p)
            solves.append(out)
            return out
        return run

    def steps(st) -> tuple:
        return int(st.iter_num), int(st.accepted), int(st.cg_iters)

    counts = counters()
    single_solves, sharded_solves = [], []
    recorded(single, single_solves)(problem)
    warm_1, times_1, (cams1, pts1, st1) = timed_solve_stats(
        recorded(single, single_solves), problem, repeats)
    single_losses = [float(o[2].loss) for o in single_solves]
    repeat_bits = len(set(single_losses)) == 1
    for cnt in counts.values():
        cnt.reset()
    mesh.counts.reset()
    warm_s, times_s, (cams, pts, st) = timed_solve_stats(
        recorded(sharded, sharded_solves), problem, repeats)
    sharded_losses = [float(o[2].loss) for o in sharded_solves]
    n = repeats + 1
    collectives = dict(all_reduce=mesh.counts.all_reduce / n,
                       all_gather=mesh.counts.all_gather / n)
    launches = path_launches(path, counts)
    loss, loss1 = float(st.loss), float(st1.loss)
    rel = abs(loss - loss1) / max(abs(loss1), 1e-300)
    rmse, rmse1 = float(rmse_fn(cams, pts)), float(rmse_fn(cams1, pts1))
    med, med1 = statistics.median(sharded_losses), statistics.median(single_losses)
    rmses = [float(rmse_fn(o[0], o[1])) for o in sharded_solves]
    rmses1 = [float(rmse_fn(o[0], o[1])) for o in single_solves]
    rmse_med, rmse_med1 = statistics.median(rmses), statistics.median(rmses1)
    step_mode = statistics.mode(steps(o[2]) for o in sharded_solves)
    step_mode1 = statistics.mode(steps(o[2]) for o in single_solves)
    within_variation = (abs(med - med1) <= 0.5 * abs(med1) and step_mode == step_mode1
                        and abs(rmse_med - rmse_med1) <= 0.1 * rmse_med1)
    del single_solves, sharded_solves
    report = dict(
        median_s=statistics.median(times_s), min_s=min(times_s), max_s=max(times_s),
        warmup_s=warm_s, single_median_s=statistics.median(times_1),
        single_min_s=min(times_1), single_max_s=max(times_1), single_warmup_s=warm_1,
        collectives_per_solve=collectives,
        launches_per_solve={k: v / n for k, v in launches.items()},
        reproj_rmse_px=rmse, single_reproj_rmse_px=rmse1,
        loss=loss, single_loss=loss1, loss_rel_diff=rel, loss_bits_equal=loss == loss1,
        sharded_losses=sharded_losses, single_losses=single_losses,
        sharded_rmses_px=rmses, single_rmses_px=rmses1,
        steps_mode=(step_mode, step_mode1),
        single_repeats_its_bits=repeat_bits,
        points_bits_equal=bool(torch.equal(pts, pts1)),
        lm_iters=(int(st.iter_num), int(st1.iter_num)),
        accepted=(int(st.accepted), int(st1.accepted)),
        cg_iters_last=(int(st.cg_iters), int(st1.cg_iters)),
    )
    floor = max(rmse, rmse1) < 1e-4
    if exact and repeat_bits:
        report["held_by"] = "bits"
        same = loss == loss1 and all(a == b for a, b in (
            report["lm_iters"], report["accepted"], report["cg_iters_last"]))
    elif exact:
        report["held_by"] = "rounding floor" if floor else "run-to-run variation"
        same = floor or within_variation
    else:
        report["held_by"] = "loss" if rel <= 1e-3 else "rounding floor"
        same = rel <= 1e-3 or floor
    ok = same and (rmse_limit is None or max(rmse, rmse1) < rmse_limit)
    log(f"solve {path} " + json.dumps(report))
    if not ok:
        raise AssertionError(f"{path}: the sharded solve does not match the single-device "
                             f"one: {report}")
    return report, cams


def run_sharded(mesh, flat, wtt, smi: str) -> None:
    """Phase 12c: the parallel layer at world size 1 over NCCL, each sharded
    engine beside its single-device engine on the medium problem, and
    sharded pose refinement on the tracking cell."""
    from tpu3drecon_torch.benchmark import solver_cells as cells
    from tpu3drecon_torch.benchmark.medium_config import (
        BENCH_CONFIG,
        build_grid_problem,
        build_tt_problem,
    )
    from tpu3drecon_torch.geometry.projection import project_points_batched
    from tpu3drecon_torch.parallel.sharded_ba import ba_solve_sharded
    from tpu3drecon_torch.parallel.sharded_grid import ba_solve_grid_sharded
    from tpu3drecon_torch.parallel.sharded_pose import refine_poses_sharded
    from tpu3drecon_torch.parallel.sharded_tt import ba_solve_tt_sharded
    from tpu3drecon_torch.parallel.sharded_wtt import ba_solve_wtt_sharded
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_tt import ba_solve_tt
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
    from tpu3drecon_torch.solvers.bundle_adjust import ba_solve, reprojection_rmse
    from tpu3drecon_torch.solvers.pose_refine import refine_poses

    log(f"sharded phase on {smi}")

    def rmse(cams, pts):
        return reprojection_rmse(flat, cams, pts)

    cfg = BENCH_CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
    sharded_pair(SHARDED_WTT, mesh, lambda p: ba_solve_wtt_sharded(p, cfg, mesh=mesh),
                 lambda p: ba_solve_wtt(p, cfg), wtt, rmse, exact=True)
    grid = build_grid_problem(flat.points3d.device, torch.float32)
    sharded_pair(SHARDED_GRID, mesh,
                 lambda p: ba_solve_grid_sharded(p, BENCH_CONFIG, mesh=mesh, kernels="auto"),
                 lambda p: ba_solve_pallas(p, BENCH_CONFIG), grid, rmse, exact=False)
    del grid
    tt = build_tt_problem(flat.points3d.device, torch.float32)
    sharded_pair("sharded_tt", mesh, lambda p: ba_solve_tt_sharded(p, BENCH_CONFIG, mesh=mesh),
                 lambda p: ba_solve_tt(p, BENCH_CONFIG, kernels=False), tt, rmse, exact=True)
    del tt
    sharded_pair(SHARDED_FLAT, mesh, lambda p: ba_solve_sharded(p, BENCH_CONFIG, mesh=mesh),
                 lambda p: ba_solve(p, BENCH_CONFIG, device=p.points3d.device), flat, rmse,
                 exact=False)

    problem, scene = cells.tracking_problem(device=flat.points3d.device)

    def pose_out(fn):
        """(cameras, tvecs, totals of the per-frame state) as the solve
        drivers take a solve's output."""
        def run(p):
            cams, state = fn(p)
            return cams, cams.tvecs, types.SimpleNamespace(
                loss=state.loss.sum(), iter_num=state.iter_num.max(),
                accepted=state.accepted.sum(), cg_iters=0)
        return run

    def pose_rmse(cams, _):
        proj = project_points_batched(cams.rmats, cams.tvecs, cams.fx_fy, cams.cx_cy_skew,
                                      cams.dist, problem.points3d)
        res = (proj - problem.points2d) * problem.mask[..., None]
        return torch.sqrt(torch.sum(res * res) / (2.0 * torch.sum(problem.mask)))

    report, cams = sharded_pair(
        "sharded_pose", mesh,
        pose_out(lambda p: refine_poses_sharded(p, mesh=mesh, config=cells.TRACKING_CONFIG)),
        pose_out(lambda p: refine_poses(p, config=cells.TRACKING_CONFIG,
                                        device=p.points3d.device)),
        problem, pose_rmse, exact=False)
    rmse = report["reproj_rmse_px"]
    t_err = float(torch.median(torch.abs(cams.tvecs.double().cpu()
                                         - torch.from_numpy(scene.tvecs))))
    log("solve sharded_pose check " + json.dumps(dict(
        frames=problem.batch, reproj_rmse_px=rmse, median_tvec_err=t_err,
        ms_per_frame=report["median_s"] / problem.batch * 1e3,
        single_ms_per_frame=report["single_median_s"] / problem.batch * 1e3)))
    if not (rmse < 1e-3 and t_err < 1e-3):
        raise AssertionError(f"sharded_pose: RMSE {rmse:.3e} px, median tvec error {t_err:.3e}")


def run_cli(tmp: str, smi: str, dev) -> None:
    """Phase 12b: the command line on phase 12's files (``dev``, the card): ``main([...])`` in
    process for solve-colmap on the medium COLMAP model with each engine,
    solve-bal on the Ladybug-shaped BAL file, a checkpointed solve-bal run
    twice (the second resumes complete); ``python -m tpu3drecon_torch info``
    and ``solve-bal`` as subprocesses.  Every written file is read back: its
    RMSE within 1e-3 px of the solve's."""
    import contextlib
    import io
    import os
    import re
    import subprocess

    from tpu3drecon_torch.cli import main as cli_main
    from tpu3drecon_torch.io import colmap as cio
    from tpu3drecon_torch.io.bal import ba_problem_from_bal
    from tpu3drecon_torch.problems.packing import ba_problem_from_colmap
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse

    counts = counters()
    rmse_re = re.compile(r"RMSE ([0-9.]+) -> ([0-9.]+) px")

    def run(path: str, argv: list) -> tuple:
        for cnt in counts.values():
            cnt.reset()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main(argv)
        wall = time.perf_counter() - t0
        text = err.getvalue()
        if rc != 0:
            raise AssertionError(f"{path}: exit code {rc}\n{text}")
        launches = path_launches(path, counts)
        found = rmse_re.findall(text)
        if not found:
            raise AssertionError(f"{path}: no RMSE line in\n{text}")
        rmse0, rmse1 = map(float, found[-1])
        return wall, rmse0, rmse1, launches, text.strip().splitlines()[-2:]

    def reread_rmse(kind: str, out: str) -> float:
        if kind == "colmap":
            p, _ = ba_problem_from_colmap(cio.read_model(out), device=dev)
        else:
            p, _ = ba_problem_from_bal(out, device=dev)
        return float(reprojection_rmse(p, p.cameras, p.points3d))

    def check(path: str, kind: str, out: str, rmse: float, report: dict) -> None:
        back = reread_rmse(kind, out)
        report.update(reread_rmse_px=back, solve_rmse_px=rmse)
        log(f"solve {path} " + json.dumps(dict(card=smi, **report)))
        if not abs(back - rmse) < 1e-3:
            raise AssertionError(f"{path}: re-read RMSE {back} px, solve {rmse} px")

    short = ["--maxiter", "30", "--cg-maxiter", "8"]
    for engine in ("flat", "grid", "pallas", "tt", "wtt"):
        out = f"{tmp}/cli_colmap_{engine}"
        wall, r0, r1, launches, lines = run(
            f"cli {engine}", ["solve-colmap", f"{tmp}/in", "-o", out, "--binary",
                              "--engine", engine, *short])
        check(f"cli {engine}", "colmap", out, r1, dict(
            command="solve-colmap", wall_s=wall, initial_rmse_px=r0,
            launches=launches, stderr=lines))
        if not r1 < 1e-3:
            raise AssertionError(f"cli {engine}: RMSE {r1} px")

    bal = f"{tmp}/ladybug49.txt"
    flags = ["--maxiter", "50", "--no-focal"]
    out = f"{tmp}/cli_bal.txt"
    wall, r0, r1, launches, lines = run("cli bal", ["solve-bal", bal, "-o", out, *flags])
    check("cli bal", "bal", out, r1, dict(command="solve-bal", wall_s=wall,
                                          initial_rmse_px=r0, stderr=lines))
    ck = [*flags, "--checkpoint-dir", f"{tmp}/ck", "--checkpoint-every", "10"]
    for attempt in ("first", "resumed"):
        out = f"{tmp}/cli_bal_ck_{attempt}.txt"
        wall, r0, r1, launches, lines = run(f"cli bal checkpointed {attempt}",
                                            ["solve-bal", bal, "-o", out, *ck])
        if attempt == "resumed" and "resumed complete" not in " ".join(lines):
            raise AssertionError(f"the re-run did not resume complete: {lines}")
        check(f"cli bal checkpointed {attempt}", "bal", out, r1, dict(
            command="solve-bal --checkpoint-dir", wall_s=wall, initial_rmse_px=r0,
            stderr=lines))
        if not r1 < r0:
            raise AssertionError(f"cli bal checkpointed {attempt}: RMSE {r0} -> {r1} px")

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    info = subprocess.run([sys.executable, "-m", "tpu3drecon_torch", "info"], env=env,
                          capture_output=True, text=True, timeout=300, check=True)
    payload = json.loads(info.stdout)
    log("cli info (subprocess, " + f"{time.perf_counter() - t0:.1f} s): "
        + json.dumps(payload))
    if payload["device"] != "cuda" or not payload["devices"] or not payload["native_io"]:
        raise AssertionError(f"cli info: {payload}")
    out = f"{tmp}/cli_bal_subprocess.txt"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu3drecon_torch", "solve-bal", bal, "-o",
                           out, *flags], env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli solve-bal subprocess: exit {proc.returncode}\n"
                             f"{proc.stderr}")
    r0, r1 = map(float, rmse_re.findall(proc.stderr)[-1])
    check("cli bal subprocess", "bal", out, r1, dict(
        command="python -m tpu3drecon_torch solve-bal", wall_s=wall, initial_rmse_px=r0,
        stderr=proc.stderr.strip().splitlines()[-2:]))


def same_problem(what: str, got, want) -> None:
    """Two packed problems equal field for field: tensors bit for bit, static
    fields by value."""
    import dataclasses

    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            same_problem(f"{what}.{f.name}", getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} != {len(want)} entries")
        for i, (g, w) in enumerate(zip(got, want)):
            same_problem(f"{what}[{i}]", g, w)
    elif isinstance(want, torch.Tensor):
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: the tensors differ")
    elif got != want:
        raise AssertionError(f"{what}: {got} != {want}")


SUITE_CHECKS = {  # metric -> (path, check of the line's extra, what the check holds)
    "pnp_parity_batched_refine": (
        "suite pnp", lambda e: e["max_rot_geodesic_err_vs_scipy_rad"] < 1e-4
        and e["max_tvec_err_vs_scipy"] < 2e-3, "rotation < 1e-4 rad, tvec < 2e-3 vs scipy"),
    "ba_small_10cam_5kpt_rmse": (
        "suite ba_small", lambda e: e["rmse_px"] < 1e-3, "RMSE < 1e-3 px"),
    "ba_medium_100cam_100kpt_30lm_iters": (
        SUITE_MEDIUM, lambda e: e["reproj_rmse_px"] < 1e-3, "RMSE < 1e-3 px"),
    "tracking_500frame_ms_per_frame": (
        "suite tracking", lambda e: e["median_tvec_err"] < 1e-3, "median tvec error < 1e-3"),
    "bal_wtt_s_per_lm_iter": (
        SUITE_BAL, lambda e: math.isfinite(e["loss"]) and e["loss"] < e["initial_loss"]
        and e["accepted_steps"] >= 1 and e["full_scale"] and e["split_windows"],
        "full scale, split windows, finite loss below the initial one, >= 1 accepted step"),
}


def run_suite_lines(smi: str) -> list:
    """The suite at its defaults, each line checked as it comes: its check,
    and the kernels its path must launch (B1-B4 on the medium and BAL lines,
    none elsewhere; no plain version), every count set to 0 before each
    line; the BAL line must load its problem from the cache."""
    from tpu3drecon_torch.benchmark import suite
    from tpu3drecon_torch.utils import problem_cache

    counts = counters()
    lines = []

    def reset():
        for cnt in counts.values():
            cnt.reset()

    def emit(res: dict) -> None:
        path, check, holds = SUITE_CHECKS[res["metric"]]
        launches = path_launches(path, counts)
        ok = math.isfinite(res["value"]) and bool(check({**res["extra"], "rmse_px": res["value"]}))
        if path == SUITE_BAL:
            ok = ok and problem_cache.COUNTS["hit"] > hits
        log("suite " + json.dumps({**res, "card": smi, "launches": launches,
                                   "check": holds, "ok": ok}))
        if not ok:
            raise AssertionError(f"{path}: {holds} does not hold: {res}")
        lines.append(res)
        reset()

    hits = problem_cache.COUNTS["hit"]
    reset()
    suite.run_suite(emit=emit)
    return lines


def run_harness(smi: str, dev) -> None:
    """The benchmark drivers on the registry's synthetic_medium_noised (30
    cameras, 3000 points): the torch adapter and scipy, the gated COLMAP
    and GTSAM baselines skipped, saved and loaded back; the torch adapter
    must lower the mean reprojection error and both must end below 1.0
    px^2 (tests/test_benchmark_harness.py's bound); then the BA adapter in a
    spawned child on the card, its mean squared error within 1e-4 of the
    in-process one's (the parameters' largest differences are logged).  No
    port kernel and no plain version may run."""
    import numpy as np

    from tpu3drecon_torch.benchmark import drivers
    from tpu3drecon_torch.benchmark.adapters.torch_adapters import (
        TorchBundleAdjustmentBenchmark,
    )
    from tpu3drecon_torch.benchmark.datasets import get_dataset
    from tpu3drecon_torch.benchmark.harness import load_benchmarks

    counts = counters()
    for cnt in counts.values():
        cnt.reset()

    def overall(errors: dict) -> float:
        return float(np.nanmean([np.mean(v) if len(v) else np.nan for v in errors.values()]))

    t0 = time.perf_counter()
    ds = get_dataset("synthetic_medium_noised")
    load_s = time.perf_counter() - t0
    before = overall(ds.compute_reprojection_errors_alt(lambda x: x))
    root = tempfile.mkdtemp(prefix="harness_")
    try:
        report = {"card": smi, "dataset": "synthetic_medium_noised",
                  "cameras": len(ds.datasetEntries), "points": len(ds.points3D),
                  "load_s": load_s, "mean_sq_err_before_px2": before}
        for kind, run in (
                ("ba", lambda: drivers.benchmark_bundle_adjustment(
                    ds, results_root=f"{root}/ba")),
                ("pose", lambda: drivers.benchmark_single_pose(
                    ds, results_root=f"{root}/pose"))):
            t0 = time.perf_counter()
            benchmarks = run()
            wall = time.perf_counter() - t0
            loaded = load_benchmarks(f"{root}/{kind}/latest")
            means = {b.FRAMEWORK: overall(b.reprojection_errors()) for b in benchmarks}
            report[kind] = dict(
                wall_s=wall, frameworks=[b.FRAMEWORK for b in benchmarks],
                times_s={b.FRAMEWORK: b.time for b in benchmarks},
                iterations={b.FRAMEWORK: (b.iterations or [None])[:3] for b in benchmarks},
                mean_sq_err_px2=means, loaded=sorted(type(b).__name__ for b in loaded))
            if [b.FRAMEWORK for b in benchmarks] != ["tpu3drecon_torch", "scipy"] or \
                    len(loaded) != 2 or not means["tpu3drecon_torch"] < before:
                raise AssertionError(f"harness {kind}: {report[kind]}")
            if kind == "ba":
                in_process = benchmarks[0]
                if not max(means.values()) < 1.0:
                    raise AssertionError(f"harness ba: mean errors {means} not below 1.0")
        report["launches"] = path_launches("harness", counts)

        child = TorchBundleAdjustmentBenchmark(ds)
        t0 = time.perf_counter()
        child.subprocess_benchmark(timeout_s=600, device="cuda")
        child_s = time.perf_counter() - t0
        mine = overall(in_process.reprojection_errors())
        theirs = overall(child.reprojection_errors())
        cam = lambda b: np.stack([np.r_[c.camera_pose.rotation.ravel(),  # noqa: E731
                                        c.camera_pose.translation]
                                  for _, c in sorted(b.results.camera_mapping.items())])
        pts = lambda b: np.stack([p.xyz for _, p in sorted(b.results.point_mapping.items())])  # noqa: E731
        report["subprocess"] = dict(
            wall_s=child_s, mean_sq_err_px2=theirs, in_process_px2=mine,
            iterations=child.iterations, in_process_iterations=in_process.iterations,
            max_cam_diff=float(np.max(np.abs(cam(child) - cam(in_process)))),
            max_point_diff=float(np.max(np.abs(pts(child) - pts(in_process)))))
        log("harness " + json.dumps(report))
        # The child's solve is the same float32 solve: its mean error (free of
        # the gauge, along which the float atomics move the parameters) agrees.
        if not abs(theirs - mine) <= 1e-4 * mine:
            raise AssertionError(f"harness subprocess: {report['subprocess']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pixel_rmse(rvecs, tvecs, fx_fy, ccs, points, uv, mask) -> float:
    """Pinhole reprojection RMSE (px) of per-camera point sets (B, N, 3)
    against (B, N, 2) observations under a (B, N) mask."""
    from tpu3drecon_torch.geometry.projection import project_points_batched
    from tpu3drecon_torch.geometry.rotations import rodrigues_to_matrix

    proj = project_points_batched(rodrigues_to_matrix(rvecs), tvecs, fx_fy, ccs,
                                  torch.zeros_like(fx_fy), points)
    sq = ((proj - uv) ** 2).sum(-1) * mask
    return float(torch.sqrt(sq.sum() / (2 * mask.sum())))


def run_compat(smi: str, dev) -> None:
    """The reference-API classes on the card at f64, on clean observations
    of a scene of 8 cameras and 2000 points (seed 51, perturbed with seed
    52): ``JaxPoseOptimizer`` with the points held at the truth (the
    reference's scalar Cauchy form, which stops at its gradient tolerance
    short of the exact fit): RMSE below a tenth of the initial one and the
    focals within 5e-2 of the truth (tests/test_compat.py's bound);
    ``JaxBundleAdjustment`` from the perturbed points: RMSE below 1e-3 px."""
    import numpy as np

    from tpu3drecon_torch import compat
    from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene

    counts = counters()
    for cnt in counts.values():
        cnt.reset()
    scene = make_scene(n_cameras=8, n_points=2000, seed=51)
    noisy = perturb_scene(scene, point3d_noise=2e-2, camera_rotation_noise=1e-2,
                          camera_translation_noise=3e-2, camera_intrinsics_noise=5.0,
                          point2d_noise=0.0, seed=52)
    B = scene.n_cameras
    n = int(np.bincount(scene.cam_idx, minlength=B).max())
    pts, uv = np.zeros((B, n, 3)), np.zeros((B, n, 2))
    pidx, mask = np.zeros((B, n), np.int32), np.zeros((B, n))
    for c in range(B):
        sel = scene.cam_idx == c
        k = int(sel.sum())
        pts[c, :k], uv[c, :k] = scene.points3d[scene.pt_idx[sel]], scene.uv[sel]
        pidx[c, :k], mask[c, :k] = scene.pt_idx[sel], 1.0
    poses0 = np.concatenate([noisy.rmats, noisy.tvecs[:, :, None]], axis=2)
    intr0 = np.concatenate([noisy.fx_fy, scene.cx_cy_skew], axis=1)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    report = {"card": smi, "cameras": B, "points": scene.n_points, "dtype": "float64"}

    opt = compat.JaxPoseOptimizer(avg_cam_width=scene.width)
    params0, ccs = opt.prepare_params(poses0, intr0)
    t0 = time.perf_counter()
    params, state = opt.optimize(params0, pts, uv, ccs, mask)
    torch.cuda.synchronize()
    focal_err = float(np.max(np.abs(params[:, 6:8].cpu().numpy() / scene.fx_fy - 1.0)))
    report["pose"] = dict(
        wall_s=time.perf_counter() - t0, max_focal_rel_err=focal_err,
        initial_rmse_px=pixel_rmse(params0[:, :3], params0[:, 3:6], params0[:, 6:8], ccs,
                                   t(pts), t(uv), t(mask)),
        rmse_px=pixel_rmse(params[:, :3], params[:, 3:6], params[:, 6:8], ccs, t(pts), t(uv),
                           t(mask)),
        max_iter_num=int(state.iter_num.max()), device=str(params.device))

    ba = compat.JaxBundleAdjustment(cam_num=B, avg_cam_width=scene.width)
    flat0, ccs = ba.prepare_params(poses0, intr0, noisy.points3d)
    t0 = time.perf_counter()
    out, state = ba.optimize(flat0, uv, pidx, ccs, mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def ba_rmse(vec) -> float:
        cams = vec[: B * 6].reshape(B, 6)
        points = vec[B * 8:].reshape(-1, 3)[t(pidx).long()]
        return pixel_rmse(cams[:, :3], cams[:, 3:6], vec[B * 6: B * 8].reshape(B, 2), ccs,
                          points, t(uv), t(mask))

    report["ba"] = dict(wall_s=wall, initial_rmse_px=ba_rmse(flat0), rmse_px=ba_rmse(out),
                        lm_iters=int(state.iter_num), accepted=int(state.accepted),
                        loss=float(state.loss), device=str(out.device))
    report["launches"] = path_launches("compat", counts)
    log("compat " + json.dumps(report))
    pose, bundle = report["pose"], report["ba"]
    on_card = {pose["device"], bundle["device"]} == {str(dev)}
    if not (on_card and pose["rmse_px"] < 0.1 * pose["initial_rmse_px"]
            and focal_err < 5e-2 and bundle["rmse_px"] < 1e-3):
        raise AssertionError(f"compat: {report}")


def run_export(smi: str) -> None:
    """``export_scene`` of the medium scene (100 cameras, 100k points):
    seconds and file sizes."""
    import os

    import numpy as np

    from tpu3drecon_torch.benchmark import medium_config as mc
    from tpu3drecon_torch.dataset.synthetic import make_scene
    from tpu3drecon_torch.utils.visualization import export_scene

    scene = make_scene(n_cameras=mc.N_CAMERAS, n_points=mc.N_POINTS,
                       obs_per_camera=mc.OBS_PER_CAMERA, seed=mc.SEED)
    ks = np.zeros((scene.n_cameras, 3, 3))
    ks[:, 0, 0], ks[:, 1, 1] = scene.fx_fy[:, 0], scene.fx_fy[:, 1]
    ks[:, 0, 1], ks[:, 0, 2], ks[:, 1, 2] = (scene.cx_cy_skew[:, 2], scene.cx_cy_skew[:, 0],
                                             scene.cx_cy_skew[:, 1])
    ks[:, 2, 2] = 1.0
    out = tempfile.mkdtemp(prefix="export_")
    try:
        t0 = time.perf_counter()
        ply, obj = export_scene(out, scene.points3d, scene.rmats, scene.tvecs, ks,
                                [scene.width] * scene.n_cameras,
                                [scene.height] * scene.n_cameras)
        wall = time.perf_counter() - t0
        sizes = {os.path.basename(p): os.path.getsize(p) for p in (ply, obj)}
        log("export " + json.dumps({"card": smi, "points": scene.n_points,
                                    "cameras": scene.n_cameras, "wall_s": wall,
                                    "bytes": sizes}))
        if not all(sizes.values()):
            raise AssertionError(f"export: empty file in {sizes}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def run_bench_cli(smi: str) -> None:
    """``bench``: ``main(["bench"])`` in process (B1-B4 counted, path ``cli
    bench``), then ``python -m tpu3drecon_torch bench`` as a subprocess;
    each line's RMSE below 1e-3 px."""
    import contextlib
    import io
    import subprocess

    from tpu3drecon_torch.cli import main as cli_main

    counts = counters()
    for cnt in counts.values():
        cnt.reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["bench"])
    wall = time.perf_counter() - t0
    launches = path_launches(CLI_BENCH, counts)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    log("cli bench " + json.dumps({"card": smi, "wall_s": wall, "launches": launches,
                                   "line": line}))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu3drecon_torch", "bench"], env=env,
                          capture_output=True, text=True, timeout=600)
    sub_wall = time.perf_counter() - t0
    if proc.returncode != 0 or rc != 0:
        raise AssertionError(f"cli bench: exit {rc} / {proc.returncode}\n{proc.stderr}")
    sub_line = json.loads(proc.stdout.strip().splitlines()[-1])
    log("cli bench subprocess " + json.dumps({"card": smi, "wall_s": sub_wall,
                                              "line": sub_line}))
    for got in (line, sub_line):
        if not (got["extra"]["reproj_rmse_px"] < 1e-3 and got["extra"]["backend"] == "cuda"):
            raise AssertionError(f"cli bench: {got}")


def run_tools(split_miss, miss_s: float, smi: str, dev) -> None:
    """Phase 13, the tool surface: the problem cache (a hit of the split
    BAL build beside its miss, the same problem bit for bit), the suite at
    its defaults, the benchmark harness, the reference-API classes, the
    scene export and ``bench``."""
    from tpu3drecon_torch.benchmark.balscale import bal_sequential_wtt
    from tpu3drecon_torch.utils import problem_cache

    t_phase = time.perf_counter()
    log(f"tool surface phase on {smi}")
    hits = problem_cache.COUNTS["hit"]
    t0 = time.perf_counter()
    split_hit = bal_sequential_wtt(split_windows=True, device=dev, verbose=False)
    torch.cuda.synchronize()
    hit_s = time.perf_counter() - t0
    if problem_cache.COUNTS["hit"] != hits + 1:
        raise AssertionError("the second split BAL build was not a problem-cache hit")
    same_problem("split BAL hit", split_hit, split_miss)
    entry = max(problem_cache._cache_dir().glob("*.torch.pickle"), key=os.path.getmtime)
    log("problem cache " + json.dumps({
        "card": smi, "problem": "bal_sequential_wtt(split_windows=True)",
        "miss_s": miss_s, "hit_s": hit_s, "entry_bytes": entry.stat().st_size,
        "buckets": len(split_hit.buckets), "same_as_miss": True}))
    del split_hit

    run_suite_lines(smi)
    run_harness(smi, dev)
    run_compat(smi, dev)
    run_export(smi)
    run_bench_cli(smi)
    log(f"tool surface phase: {time.perf_counter() - t_phase:.1f} s")


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

    # The problem cache in a directory of this run's own: the first build of
    # each BAL packing is a miss, and the tool-surface phase's are hits.
    cache_dir = tempfile.mkdtemp(prefix="problem_cache_")
    os.environ["TPU3DRECON_PROBLEM_CACHE_DIR"] = cache_dir
    from tpu3drecon_torch.utils import problem_cache

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
    check_flat_kernels(flat)
    first_path(run_solvers(flat))
    run_files(flat, smi)
    store_dir = tempfile.mkdtemp(prefix="nccl_store_")
    mesh = open_nccl_mesh(store_dir)
    run_sharded(mesh, flat, wtt, smi)

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
    misses = problem_cache.COUNTS["miss"]
    split = bal_sequential_wtt(split_windows=True, device=dev, verbose=False)
    torch.cuda.synchronize()
    split_miss_s = time.perf_counter() - t0
    if problem_cache.COUNTS["miss"] != misses + 1:
        raise AssertionError("the split BAL build was not a problem-cache miss")
    log(f"BAL split packing: bal_sequential_wtt(split_windows=True) built in "
        f"{split_miss_s:.1f} s (a problem-cache miss); buckets (G, Tb, Pc, W, global "
        f"tiles, global_tile0): {buckets_line(split)}")
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
    del bal_flat  # split stays: the tool-surface phase compares a cache hit with it

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
    from tpu3drecon_torch.parallel.sharded_wtt import ba_solve_wtt_sharded
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse

    hub3 = cfg._replace(maxiter=3)
    sharded_pair(SHARDED_HUB, mesh, lambda p: ba_solve_wtt_sharded(p, hub3, mesh=mesh),
                 lambda p: ba_solve_wtt(p, hub3), hub_split,
                 lambda c, p: reprojection_rmse(hub_flat, c, p), exact=True, repeats=5,
                 rmse_limit=None)
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
    from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat
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
    del tt1024

    t0 = time.perf_counter()
    grid1024 = grid_bucketed_from_flat(seq_flat)
    torch.cuda.synchronize()
    log(f"grid_seq1024 problem: (C, K) = {tuple(grid1024.mask.shape)}, "
        f"P_pad = {grid1024.points3d.shape[0]}, packed in {time.perf_counter() - t0:.1f} s; "
        "track buckets (Pb, Tb): " + str([tuple(b.track_idx.shape) for b in grid1024.buckets]))
    check_grid1024_kernels(grid1024)
    first_path(drive(
        GRID1024, lambda p, **kw: ba_solve_pallas(p, BAL_CONFIG._replace(**kw)),
        grid1024, seq_flat, 2, maxiters=(3,), rmse_limit=None,
    ))
    del grid1024, seq_flat

    from tpu3drecon_torch.experiments import term_stack

    term_stack.run(log=log)
    run_probe_e4(launches)
    import torch.distributed as dist

    dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    run_tools(split, split_miss_s, smi, dev)
    del split
    shutil.rmtree(cache_dir, ignore_errors=True)
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
