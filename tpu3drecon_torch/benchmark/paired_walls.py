"""Wall times of the medium solves of two source trees, taken in turns on
one card.

    python -m tpu3drecon_torch.benchmark.paired_walls --base DIR [--rounds R]
        [--pairs N] [--engines grid,wtt_unfused]

``--base`` is the root of another checkout (an unpacked ``git archive`` of
the parent commit, say); the other tree is this checkout.  A worker
process per tree runs with that tree's ``tpu3drecon_torch`` first on its
path: it builds the medium problem of each engine (``profile_solve``'s
``grid``: ``ba_solve_pallas`` with ``BENCH_CONFIG``; ``wtt_unfused``:
``ba_solve_wtt`` with ``linearize_kernel=False``, ``matvec_kernel="index"``
on the packing with its dense one-hot; ``wtt_onehot``: the same with
``matvec_kernel="fused"``), solves each twice to warm up, and then runs one
solve per request, synchronized, and answers with its host wall time.
Only one worker runs at a time.  Each of the ``--rounds`` rounds starts a
fresh worker per tree and takes ``--pairs`` pairs per engine, the requests
alternating base, this, this, base, ...; the rounds alternate which worker
starts first.  A worker's speed varies from one start to the next as much
as the kernels' device time could move a host-bound solve, so pairs from
one pair of processes measure the processes as much as the trees; run
with ``--base`` a copy of this tree for the spread of identical code.

One JSON line per engine gives each tree's walls in order (``base_s``,
``this_s``), their medians, minima and maxima, the median of the paired
differences this - base (``diff_median_s``) and the number of pairs in
which this tree was the slower (``this_slower``), beside the card's
``nvidia-smi`` name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ENGINES = ("grid", "wtt_unfused", "wtt_onehot")
HERE = Path(__file__).resolve()
THIS_ROOT = HERE.parents[2]


def _solvers(engines):
    """engine -> (solve, problem) of the tree this process imports."""
    from tpu3drecon_torch.benchmark.medium_config import (
        BENCH_CONFIG,
        build_grid_problem,
        build_problem,
    )
    from tpu3drecon_torch.problems.wtt import wtt_from_flat
    from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
    from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt

    unfused = BENCH_CONFIG._replace(matvec_kernel="index", linearize_kernel=False)
    onehot = BENCH_CONFIG._replace(matvec_kernel="fused", linearize_kernel=False)
    runs = {
        "grid": (lambda p: ba_solve_pallas(p, BENCH_CONFIG), build_grid_problem),
        "wtt_unfused": (lambda p: ba_solve_wtt(p, unfused),
                        lambda: wtt_from_flat(build_problem(), defer_onehot=False)),
        "wtt_onehot": (lambda p: ba_solve_wtt(p, onehot),
                       lambda: wtt_from_flat(build_problem(), defer_onehot=False)),
    }
    return {e: (runs[e][0], runs[e][1]()) for e in engines}


def worker(engines) -> int:
    """Build and warm up, print ``ready``, then answer each engine name read
    on stdin with the wall seconds of one solve, until ``quit``."""
    import torch

    solvers = _solvers(engines)
    for solve, problem in solvers.values():
        for _ in range(2):
            solve(problem)
    torch.cuda.synchronize()
    print("ready", flush=True)
    for line in sys.stdin:
        engine = line.strip()
        if engine == "quit":
            break
        solve, problem = solvers[engine]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(problem)
        torch.cuda.synchronize()
        print(json.dumps({"engine": engine, "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


def _start(root: Path, engines) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.Popen([sys.executable, str(HERE), "--worker", "--engines",
                             ",".join(engines)], cwd=root, env=env, text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)


def _ask(proc: subprocess.Popen, engine: str) -> float:
    proc.stdin.write(engine + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"paired_walls: a worker ended (exit {proc.wait()})")
    return json.loads(line)["wall_s"]


def _summary(engine: str, base: list, this: list, card: str) -> dict:
    diffs = [t - b for b, t in zip(base, this)]
    out = {"engine": engine, "card": card, "pairs": len(base), "base_s": base, "this_s": this}
    for name, walls in (("base", base), ("this", this)):
        out.update({f"{name}_median_s": statistics.median(walls),
                    f"{name}_min_s": min(walls), f"{name}_max_s": max(walls)})
    out.update(diff_median_s=statistics.median(diffs),
               this_slower=sum(d > 0 for d in diffs))
    return out


def _stop(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            try:
                proc.stdin.write("quit\n")
                proc.stdin.flush()
                proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                proc.kill()
                proc.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=4, help="fresh workers per round")
    ap.add_argument("--pairs", type=int, default=4, help="pairs per engine and round")
    ap.add_argument("--engines", default="grid,wtt_unfused")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    engines = [e for e in args.engines.split(",") if e]
    unknown = set(engines) - set(ENGINES)
    if unknown:
        raise SystemExit(f"paired_walls: unknown engines {sorted(unknown)}")
    if args.worker:
        return worker(engines)
    if not args.base:
        raise SystemExit("paired_walls: --base is required")
    from tpu3drecon_torch.benchmark.timing import card_line

    card = card_line()
    roots = {"base": Path(args.base).resolve(), "this": THIS_ROOT}
    walls = {e: {"base": [], "this": []} for e in engines}
    for r in range(args.rounds):
        names = ("base", "this") if r % 2 == 0 else ("this", "base")
        procs = {}
        try:
            for name in names:
                procs[name] = _start(roots[name], engines)
            for name in names:
                if procs[name].stdout.readline().strip() != "ready":
                    raise RuntimeError(
                        f"paired_walls: the {name} worker failed (exit {procs[name].wait()})")
            for i in range(args.pairs):
                for engine in engines:
                    for name in names if i % 2 == 0 else names[::-1]:
                        walls[engine][name].append(_ask(procs[name], engine))
        finally:
            _stop(procs)
    for engine in engines:
        print(json.dumps(_summary(engine, walls[engine]["base"], walls[engine]["this"], card)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
