"""Command-line interface: solve-bal / solve-colmap / bench / info.

Counterpart of ``tpu3drecon/cli.py``, with its subcommands, flags and
defaults:

    python -m tpu3drecon_torch info
    python -m tpu3drecon_torch solve-bal problem.txt [-o solved.txt] [--engine wtt]
    python -m tpu3drecon_torch solve-colmap sparse/ -o sparse_opt/ [--binary]
    python -m tpu3drecon_torch bench [--cpu]

Solves run on the CUDA card; ``--cpu`` is the only way to the CPU, and
without a card (and without ``--cpu``) the command fails.  ``--f64``
solves in float64.  The ``auto`` rules are JAX's, with "on the TPU" read
as "on the card": ``--matvec`` and ``--linearize auto`` pick the index
kernels (B2 and B1) for ``--engine wtt`` on the card, the PyTorch products
elsewhere; ``--split-windows auto`` splits the window classes exactly when
both index kernels run; ``--precond auto`` takes block SSOR for the
track-table engines at 1000 cameras or more, Schur-Jacobi otherwise.
Whether SSOR and the split windows pay on the card is an open question of
ROADMAP.md.  Where the windowed layout cannot be built, ``--engine wtt``
falls back to the fused grid engine on the card and the grid engine
elsewhere.  ``--checkpoint-dir`` runs the solve as resumable chunks
(``utils/checkpoint.py``).  ``bench`` prints the medium configuration's
JSON line (``benchmark/suite.py run_medium``: the wtt engine with both
index kernels, B1-B4), as JAX's ``bench`` prints its headline.  ``--aot``
(a TPU compile cache, ROADMAP A.8) is not ported and raises
``NotImplementedError``.  After a solve's report line, one more line
gives the packing and kernel-build seconds and the timed solve's host
milliseconds per LM phase and in each host wait, from the program's
spans (``utils/timing.py``).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

PREFIX = "[tpu3drecon_torch]"


def _split_windows_arg(value: str):
    """``--split-windows`` value: auto/on/off or a positive int class cap."""
    if value in ("auto", "on", "off"):
        return value
    try:
        cap = int(value)
    except ValueError:
        cap = 0
    if cap <= 0:
        raise argparse.ArgumentTypeError(
            f"expected auto, on, off, or a positive integer class cap "
            f"(got {value!r})"
        )
    return cap


def _add_common(p):
    p.add_argument("--cpu", action="store_true",
                   help="solve on the CPU (default: the CUDA card)")
    p.add_argument("--f64", action="store_true", help="solve in float64")
    p.add_argument("--maxiter", type=int, default=50)
    p.add_argument("--cg-maxiter", type=int, default=30)
    p.add_argument(
        "--engine", choices=("flat", "grid", "pallas", "tt", "wtt"),
        default="flat",
        help="BA engine: flat (implicit Schur on the observation list), "
        "grid (camera grid and track table), pallas (the grid with kernels "
        "B9-B11), tt (dense track table), wtt (windowed track table, for "
        "BAL-scale camera counts on sequential captures; kernels B1-B4 on "
        "the card)",
    )
    p.add_argument("--no-focal", action="store_true", help="freeze focal lengths")
    p.add_argument("--loss", choices=("trivial", "cauchy"), default="trivial")
    p.add_argument(
        "--precond",
        choices=("auto", "schur_jacobi", "ssor", "tridiag", "jacobi_u"),
        default="auto",
        help="CG preconditioner for the reduced camera system.  auto: block "
        "SSOR for the track-table engines (tt, wtt) at 1000 cameras or "
        "more, Schur-Jacobi otherwise",
    )
    p.add_argument(
        "--matvec",
        choices=("auto", "xla", "fused", "index", "index2", "index1"),
        default="auto",
        help="PCG coupling matvec (wtt engine): xla (PyTorch products), fused "
        "(kernel B6 on the dense one-hot), index (kernel B2), index2/index1 "
        "(B2 with x rounded through 2 or 1 bfloat16 split terms in float32).  "
        "auto: index on the card, xla elsewhere",
    )
    p.add_argument(
        "--linearize", choices=("auto", "xla", "index", "index2"),
        default="auto",
        help="linearization (wtt engine): xla (kernels B7 and B8 around "
        "PyTorch planes), index (kernel B1), index2 (B1 with its columns "
        "rounded through 2 bfloat16 split terms in float32).  auto: index "
        "on the card, xla elsewhere",
    )
    p.add_argument(
        "--split-windows", type=_split_windows_arg, default="auto",
        metavar="{auto,on,off,N}",
        help="micro-chunk window classes of the wtt packing "
        "(problems/wtt.py split_windows): narrower windows per chunk, more "
        "buckets.  auto: on exactly when both index kernels run.  An "
        "integer N > 0 caps the window classes per bucket ('on' = 4)",
    )
    p.add_argument(
        "--checkpoint-dir", default=None,
        help="run the solve as resumable chunks with a checkpoint after each "
        "in this directory; a killed run re-invoked with the same directory "
        "resumes from the last completed chunk (utils/checkpoint.py; the "
        "JAX package's orbax checkpoints are not read)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=10, metavar="N",
        help="outer LM iterations per checkpoint chunk (default 10)",
    )
    p.add_argument(
        "--aot", action="store_true",
        help="the JAX package's persistent AOT executable cache: not ported "
        "(ROADMAP A.8), raises",
    )


def _device(args):
    """The solve's device: the CPU under ``--cpu``, else the CUDA card (an
    error without one)."""
    import torch

    from tpu3drecon_torch.device import resolve_device

    if args.cpu:
        return torch.device("cpu")
    try:
        return resolve_device(None)
    except RuntimeError:
        print(f"{PREFIX} no CUDA device: the solve runs on the card; pass --cpu to "
              "solve on the CPU", file=sys.stderr)
        raise SystemExit(2)


def _usage_error(msg: str):
    print(f"{PREFIX} {msg}", file=sys.stderr)
    raise SystemExit(2)


def _config(args, n_cameras: int = 0):
    """``BAConfig`` from the flags; the ``auto`` choices follow JAX's rules
    with "on the TPU" read as "on the card" (not ``args.cpu``)."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    on_card = not getattr(args, "cpu", False)
    precond = getattr(args, "precond", "auto")
    if precond in ("ssor", "tridiag") and args.engine not in ("tt", "wtt"):
        _usage_error(f"--precond {precond} requires --engine tt or wtt "
                     "(the band preconditioners need the track-table layout)")
    if precond == "auto":
        precond = ("ssor" if args.engine in ("tt", "wtt") and n_cameras >= 1000
                   else "schur_jacobi")
    matvec = getattr(args, "matvec", "auto")
    if matvec not in ("auto", "xla") and args.engine != "wtt":
        _usage_error(f"--matvec {matvec} applies to --engine wtt only")
    if matvec == "auto":
        matvec = "index" if args.engine == "wtt" and on_card else "xla"
    linearize = getattr(args, "linearize", "auto")
    if linearize not in ("auto", "xla") and args.engine != "wtt":
        _usage_error(f"--linearize {linearize} applies to --engine wtt only")
    sw = getattr(args, "split_windows", "auto")
    if sw != "auto" and args.engine != "wtt":
        _usage_error(f"--split-windows {sw} applies to --engine wtt only "
                     "(window classes are a wtt packing concept)")
    if linearize == "auto":
        linearize = "index" if args.engine == "wtt" and on_card else "xla"
    return BAConfig(
        maxiter=args.maxiter,
        cg_maxiter=args.cg_maxiter,
        gtol=1e-10,
        cg_rtol=1e-6,
        optimize_focal=not args.no_focal,
        optimize_dist=getattr(args, "optimize_dist", False),
        loss=RobustLoss.CAUCHY if args.loss == "cauchy" else RobustLoss.TRIVIAL,
        precond=precond,
        matvec_kernel=False if matvec == "xla" else matvec,
        linearize_kernel=False if linearize == "xla" else linearize,
    )


def _pack_wtt(problem, args, config):
    """(packed problem or None, config): the windowed track table with the
    flags' window split, or None where its layout cannot be built (the
    config then drops what only wtt runs)."""
    from tpu3drecon_torch.problems.wtt import wtt_from_flat

    sw = getattr(args, "split_windows", "auto")
    if sw == "auto":
        split = bool(config.matvec_kernel and config.linearize_kernel)
    elif isinstance(sw, int):
        split = sw
    else:
        split = sw == "on"
    # A fully indexed solve never reads the dense one-hot: never build it.
    fully_indexed = (config.matvec_kernel in ("index", "index1", "index2")
                     and config.linearize_kernel in ("index", "index2"))
    try:
        packed = wtt_from_flat(problem, split_windows=split, defer_onehot=fully_indexed)
    except ValueError as e:
        note = ""
        if config.precond in ("ssor", "tridiag"):
            note += (f"; band preconditioner {config.precond!r} replaced with "
                     "schur_jacobi (ssor/tridiag are tt/wtt-only)")
            config = config._replace(precond="schur_jacobi")
        if config.matvec_kernel:
            note += (f"; matvec kernel {config.matvec_kernel!r} replaced with the "
                     "PyTorch matvec (the kernels are wtt-only)")
            config = config._replace(matvec_kernel=False)
        if config.linearize_kernel:
            note += (f"; linearize kernel {config.linearize_kernel!r} replaced with "
                     "the PyTorch linearization (the kernels are wtt-only)")
            config = config._replace(linearize_kernel=False)
        fallback = "pallas" if problem.points3d.is_cuda else "grid"
        if config.optimize_dist:  # the grid engines refuse it
            fallback = "flat"
        print(f"{PREFIX} wtt layout infeasible ({e}); falling back to the {fallback} "
              f"engine{note}", file=sys.stderr)
        args.engine = fallback  # the summary line reports what ran
        return None, config
    if config.precond in ("ssor", "tridiag") and any(b.global_tiles for b in packed.buckets):
        print(f"{PREFIX} hub/global camera split in effect; band preconditioner "
              f"{config.precond!r} replaced with schur_jacobi (ssor/tridiag need "
              "pure window locality)", file=sys.stderr)
        config = config._replace(precond="schur_jacobi")
    return packed, config


def _pack(problem, args, config, device):
    """(packed problem, config, config -> solver) for ``args.engine``."""
    from tpu3drecon_torch.solvers.bundle_adjust import ba_solve

    packed = None
    if args.engine == "wtt":
        from tpu3drecon_torch.solvers.ba_wtt import make_wtt_ba_solver

        packed, config = _pack_wtt(problem, args, config)
        make_solver = make_wtt_ba_solver
    if args.engine == "pallas":
        from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat
        from tpu3drecon_torch.solvers.ba_pallas import make_pallas_ba_solver

        packed = grid_bucketed_from_flat(problem)
        make_solver = make_pallas_ba_solver
    elif args.engine == "grid":
        from tpu3drecon_torch.problems.grid import grid_from_flat
        from tpu3drecon_torch.solvers.ba_grid import make_grid_ba_solver

        packed = grid_from_flat(problem)
        make_solver = make_grid_ba_solver
    elif args.engine == "tt":
        from tpu3drecon_torch.problems.tt import tt_from_flat
        from tpu3drecon_torch.solvers.ba_tt import make_tt_ba_solver

        packed = tt_from_flat(problem)
        make_solver = make_tt_ba_solver
    elif args.engine == "flat":
        packed = problem

        def make_solver(c):
            return functools.partial(ba_solve, config=c, device=device)

    return packed, config, make_solver


# The phases of an LM iteration, as utils/timing.py's spans name them.
PHASES = ("lm.linearize", "lm.rhs", "pcg", "lm.backsub", "lm.apply", "lm.cost",
          "lm.update")


def _phases_line(setup: dict, timed: dict) -> str:
    """The packing and kernel-build seconds of ``setup`` (the tally of the
    packing and the first solve), then the host ms of ``timed`` (the timed
    solve's tally) per LM phase and in each ``sync.*`` wait, then its
    flat linearizations on the card's kernels (``flat.lin_kernel``)."""

    def secs(t, name):
        return t["spans"].get(name, {}).get("s", 0.0)

    pack = sum(v["s"] for k, v in setup["spans"].items()
               if k.startswith("pack.") and not (v["parent"] or "").startswith("pack."))
    build = secs(setup, "build.nvcc") + secs(timed, "build.nvcc")
    compiles = setup["counts"].get("build.compiles", 0) + timed["counts"].get(
        "build.compiles", 0)
    phases = ", ".join(f"{name} {1e3 * secs(timed, name):.1f}" for name in PHASES
                       if name in timed["spans"])
    waits = ", ".join(f"{name[5:]} {v['calls']}x {1e3 * v['s']:.1f}"
                      for name, v in sorted(timed["spans"].items())
                      if name.startswith("sync."))
    lin = timed["counts"].get("flat.lin_kernel")
    kernels = f"; flat.lin_kernel {lin}" if lin else ""
    return (f"{PREFIX} phases: pack {pack:.3f}s, build {build:.2f}s ({compiles} compiles); "
            f"solve host ms over {timed['counts'].get('lm.iters', 0)} LM iterations: "
            f"{phases}; sync waits: {waits or 'none'}{kernels}")


def _solve(problem, args, device):
    """Pack for ``args.engine``, solve (twice, the second timed, or as
    checkpointed chunks) and report; returns (cameras, points, state).
    The packing and the first solve are recorded in one tally, the timed
    solve in another (``utils/timing.py``), for the phases line."""
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse
    from tpu3drecon_torch.utils import timing

    if args.aot:
        raise NotImplementedError(
            "--aot (the persistent AOT executable cache) is TPU-specific and not "
            "ported (ROADMAP A.8)")
    config = _config(args, n_cameras=int(problem.n_cameras))
    rmse0 = float(reprojection_rmse(problem, problem.cameras, problem.points3d))
    timing.reset()
    with timing.recording():
        packed, config, make_solver = _pack(problem, args, config, device)
    try:
        solver = make_solver(config)
    except ValueError as e:  # a setting this engine refuses
        _usage_error(str(e))

    where = _device_name(device)
    if args.checkpoint_dir:
        from tpu3drecon_torch.utils.checkpoint import ba_solve_checkpointed

        setup = timing.tally()
        timing.reset()
        t0 = time.perf_counter()
        with timing.recording():
            cams, pts, state = ba_solve_checkpointed(
                packed, config, args.checkpoint_dir, chunk_iters=args.checkpoint_every,
                solver_fn=lambda p, c: make_solver(c)(p),
            )
            timing.device_sync(pts)
        solve_s, first_s = time.perf_counter() - t0, 0.0
        if state is None:
            print(f"{PREFIX} checkpoint at {args.checkpoint_dir} already covers "
                  f"maxiter={config.maxiter}; returning the checkpointed solution",
                  file=sys.stderr)
            rmse1 = float(reprojection_rmse(problem, cams, pts))
            print(f"{PREFIX} {args.engine} engine on {where}: RMSE {rmse0:.4f} -> "
                  f"{rmse1:.5f} px (resumed complete)", file=sys.stderr)
            return cams, pts, state
    else:
        t0 = time.perf_counter()
        with timing.recording():
            cams, pts, state = solver(packed)
            timing.device_sync(pts)
        first_s = time.perf_counter() - t0
        setup = timing.tally()
        timing.reset()
        t0 = time.perf_counter()
        with timing.recording():
            cams, pts, state = solver(packed)
            timing.device_sync(pts)
        solve_s = time.perf_counter() - t0
    timed = timing.tally()
    rmse1 = float(reprojection_rmse(problem, cams, pts))
    print(f"{PREFIX} {args.engine} engine on {where}: RMSE {rmse0:.4f} -> {rmse1:.5f} px, "
          f"{int(state.accepted)}/{int(state.iter_num)} iters accepted, solve "
          f"{solve_s:.2f}s (first call {first_s:.1f}s)", file=sys.stderr)
    print(_phases_line(setup, timed), file=sys.stderr)
    return cams, pts, state


def _device_name(device) -> str:
    """``cuda (<card name>)`` or ``cpu``."""
    import torch

    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


def _dtype(args):
    import torch

    return torch.float64 if args.f64 else torch.float32


def cmd_solve_bal(args):
    from tpu3drecon_torch.io.bal import ba_problem_from_bal, export_bal

    device = _device(args)
    problem, meta = ba_problem_from_bal(args.input, dtype=_dtype(args), device=device)
    print(f"{PREFIX} loaded {args.input}: {problem.n_cameras} cams / {problem.n_points} "
          f"pts / {meta.n_real_obs} obs", file=sys.stderr)
    cams, pts, state = _solve(problem, args, device)
    if args.output:
        export_bal(args.output, problem, cams, pts)
        print(f"{PREFIX} wrote {args.output}", file=sys.stderr)
    return 0


def cmd_solve_colmap(args):
    from tpu3drecon_torch.io import colmap as cio
    from tpu3drecon_torch.problems.packing import (
        ba_problem_from_colmap,
        colmap_model_with_solution,
    )

    device = _device(args)
    model = cio.read_model(args.input)
    problem, meta = ba_problem_from_colmap(model, dtype=_dtype(args), device=device)
    print(f"{PREFIX} loaded {args.input}: {problem.n_cameras} cams / {problem.n_points} "
          f"pts / {meta.n_real_obs} obs", file=sys.stderr)
    cams, pts, state = _solve(problem, args, device)
    if args.output:
        solved = colmap_model_with_solution(model, cams, pts, meta)
        cio.write_model(solved, args.output, binary=args.binary)
        print(f"{PREFIX} wrote {args.output}", file=sys.stderr)
    return 0


def cmd_bench(args):
    """The medium configuration's line (``benchmark.suite.run_medium``), as
    JAX's ``bench`` prints its headline: 5 timed solves on the card, 2 on
    the CPU."""
    from tpu3drecon_torch.benchmark import suite

    device = _device(args)
    print(json.dumps(suite.run_medium(reps=2 if device.type == "cpu" else 5,
                                      device=device)))
    return 0


def cmd_info(args):
    import torch

    import tpu3drecon_torch
    from tpu3drecon_torch.io.colmap import native

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": tpu3drecon_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": "cuda" if cuda else "cpu (no CUDA device: solves need --cpu)",
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
        "native_io": native.load_library() is not None,
        "engines": ["flat (implicit Schur)", "grid (camera grid, track table)",
                    "pallas (grid with kernels B9-B11)", "tt (dense track table)",
                    "wtt (windowed track table, kernels B1-B4)",
                    "sharded_flat", "sharded_pose", "sharded_wtt", "sharded_tt",
                    "sharded_grid (parallel/, torch.distributed)"],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu3drecon_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve-bal", help="bundle-adjust a BAL problem file")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None, help="write solved BAL file")
    p.add_argument("--optimize-dist", action="store_true",
                   help="optimize each camera's radial distortion k1, k2 beside its pose "
                   "and focal length, as BAL's 9-parameter camera (default: k1, k2 "
                   "held as read)")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_bal)

    p = sub.add_parser("solve-colmap", help="bundle-adjust a COLMAP sparse model")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None, help="write solved sparse model")
    p.add_argument("--binary", action="store_true", help="write .bin (default .txt)")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_colmap)

    p = sub.add_parser("bench", help="the medium BA configuration: one JSON line")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="torch, device and capability report")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
