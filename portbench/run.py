"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json`` at the checkout's root, its
configuration (``configs/``), traffic (``traffic/``), limits
(``limits/<workload>.json``) and per-layer readers (``metrics/``) by name.
Set-up makes the inputs on the card from ``--seed`` (``generator.py``),
packs them with the traffic's ``pack`` entry of ``tpu3drecon_torch`` and
warms up with one solve.  The window then runs solves back to back, each
from the same start through the traffic's ``solve`` entry, until
``--seconds`` have passed; ``lm_iter_s`` (``lm_iter_s.wtt`` on the wtt
engine's cells) is the window's time to the synchronized end of its last
solve over the LM iterations its solves completed.  With ``--trace 1`` the
window runs under ``torch.profiler`` and the cell's per-layer metrics are
read from the trace.  Then the program's state is freed and the plain
reference (``reference.py``) solves the same inputs; ``compare.py``
decides ``correct``.  The last line of standard output is the result's
JSON object.

Needs a CUDA card (exit 2 otherwise).  Imports neither JAX nor the JAX
package; exits 3 if either is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3drecon")
PROGRAM = "tpu3drecon_torch"
CACHE = ROOT / ".portbench_cache"
FAULTS = ("unchanged", "half", "altered")


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed directories inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    with open(root / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / config_entry["file"]) as fh:
        config = json.load(fh)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    with open(BENCH / "limits" / f"{workload}.json") as fh:
        limits = json.load(fh)
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=end_to_end, per_layer=per_layer)


def _json_file(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def unlisted_cell(config_file, traffic, limits) -> dict:
    """A cell that ``BENCHMARK.json`` does not list, as ``load_cell`` gives
    one, from its configuration file, its traffic (a name under
    ``traffic/`` or a ``.json`` file) and its limits (a file or a dict).
    It reports no metric: it is judged, not measured."""
    if str(traffic).endswith(".json"):
        traffic_spec = _json_file(traffic)
    else:
        traffic_spec = _json_file(BENCH / "traffic" / f"{traffic}.json")
    config = _json_file(config_file)
    cell = dict(name="unlisted", config=config["name"], traffic=traffic_spec["name"], chips=1)
    return dict(cell=cell, config=config, traffic=traffic_spec,
                limits=limits if isinstance(limits, dict) else _json_file(limits),
                end_to_end=[], per_layer=[])


def _entry(dotted: str):
    """A function of the program by its dotted path."""
    module, _, attr = dotted.rpartition(".")
    if module.split(".")[0] != PROGRAM:
        raise ValueError(f"{dotted}: the benchmark drives {PROGRAM} only")
    return getattr(importlib.import_module(module), attr)


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _half(problem):
    """``problem`` with every second observation left out (a fault)."""
    keep = slice(0, None, 2)
    return dataclasses.replace(problem, cam_idx=problem.cam_idx[keep],
                               pt_idx=problem.pt_idx[keep], uv=problem.uv[keep],
                               mask=problem.mask[keep])


def _bucket_shapes(packed) -> list | None:
    """(g, tb, pc, window, live slots) of each wtt bucket, or None."""
    buckets = getattr(packed, "buckets", None)
    if not buckets or not hasattr(buckets[0], "wcam"):
        return None
    out = []
    for b in buckets:
        g, _, tb, pc = b.uv.shape
        out.append((g, tb, pc, b.window, int((b.wcam >= 0).sum())))
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, fault: str | None = None) -> dict:
    """One run of the cell ``spec`` (``load_cell``) on ``device``; returns
    the result object.  ``fault`` breaks the timed path (tests only)."""
    import torch

    from portbench import compare, generator
    from portbench import trace as trace_mod
    from portbench.reference import Params, Reference
    from tpu3drecon_torch.problems.packing import BAProblem, CameraParams
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    config, traffic = spec["config"], spec["traffic"]
    on_card = torch.device(device).type == "cuda"
    dtype = getattr(torch, config["dtype"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if fault not in (None,) + FAULTS:
        raise ValueError(f"fault {fault!r}")
    t_gen = time.perf_counter()
    inputs = generator.make_inputs(config, seed, device, dtype)
    sync()
    gen_s = time.perf_counter() - t_gen
    got = dict(n_cameras=inputs.n_cameras, n_points=inputs.n_points, n_obs=inputs.n_obs)
    if got != config["expected"]:
        raise RuntimeError(f"generator made {got}, the configuration states "
                           f"{config['expected']}")
    t0 = time.perf_counter()
    problem = BAProblem(
        cameras=CameraParams(inputs.rmats, inputs.tvecs, inputs.fx_fy, inputs.cx_cy_skew,
                             inputs.dist),
        points3d=inputs.points3d, cam_idx=inputs.cam_idx, pt_idx=inputs.pt_idx,
        uv=inputs.uv, mask=torch.ones(inputs.n_obs, dtype=dtype, device=device),
        avg_cam_width=torch.tensor(inputs.width, dtype=dtype, device=device),
    )
    if fault == "half":
        problem = _half(problem)
    packed = _entry(traffic["pack"])(problem, **traffic["pack_kwargs"]) if traffic["pack"] \
        else problem
    sync()
    pack_s = time.perf_counter() - t0

    bconfig = BAConfig(**traffic["solver"])
    solve_fn = _entry(traffic["solve"])
    if "device" in inspect.signature(solve_fn).parameters:
        solve_fn = functools.partial(solve_fn, device=device)
    maxiter = traffic["solver"]["maxiter"]

    def solve():
        if fault == "unchanged":
            cams, pts, state = solve_fn(packed, bconfig._replace(maxiter=0),
                                        **traffic["solve_kwargs"])
            return cams, pts, state._replace(iter_num=maxiter)
        cams, pts, state = solve_fn(packed, bconfig, **traffic["solve_kwargs"])
        if fault == "altered":
            pts = pts.clone()
            pts[seed % pts.shape[0]] += 1.0
        return cams, pts, state

    t_warm = time.perf_counter()
    solve()  # warm-up: builds the kernels and the allocator's pools
    sync()
    warmup_s = time.perf_counter() - t_warm
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way in the window
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    first = last = None
    loss_t, iters, durations = [], [], []
    t_win = time.perf_counter()
    t_prev = t_win
    while True:
        last = solve()
        sync()
        t_now = time.perf_counter()
        durations.append(t_now - t_prev)
        t_prev = t_now
        loss_t.append(last[2].loss)
        iters.append(int(last[2].iter_num))
        if first is None:
            first = last
        if t_now - t_win >= seconds:
            break
    window_s = t_now - t_win
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    losses = [float(x) for x in torch.stack(loss_t).double().cpu()]
    samples = [(Params(c.rmats, c.tvecs, c.fx_fy, p, c.dist), float(st.loss))
               for c, p, st in ((first, last) if len(iters) > 1 else (first,))]
    shapes = _bucket_shapes(packed)
    del packed, problem, first, last, loss_t, solve
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)  # from here: the reference's peak

    summary = None
    if prof is not None:
        CACHE.mkdir(parents=True, exist_ok=True)
        path = CACHE / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        summary = trace_mod.summarize(str(path))
        path.unlink()

    t_ref = time.perf_counter()
    ref = Reference(inputs, traffic["solver"], "float64")
    ref_result = ref.solve()
    sync()
    ref_solve_s = time.perf_counter() - t_ref
    samples = [(p.to(ref.dtype), loss) for p, loss in samples]
    nums, per_solve = compare.numbers(losses, iters, samples, ref, ref_result, maxiter)
    checks = compare.judge(nums, spec["limits"])
    failed = sum(g > spec["limits"]["cost_gap"] or i != maxiter
                 for g, i in zip(per_solve, iters))
    correct = all(c["ok"] for c in checks.values())
    ref_s = time.perf_counter() - t_ref
    gc.unfreeze()

    n_iters = sum(iters)
    if trace:
        ctx = dict(pack_s=pack_s, trace=summary, lm_iters=n_iters, buckets=shapes,
                   kernels=traffic["kernels"])
        metrics = {}
        for m in spec["per_layer"]:
            value = _reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        # A metric is named for its quantity, with a suffix where cells of
        # one engine family carry their own bound ("lm_iter_s.wtt").
        values = dict(lm_iter_s=window_s / n_iters, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"].split(".")[0]], unit=m["unit"])
                   for m in spec["end_to_end"]}
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(device) if on_card else "cpu",
               count=1, memory_peak_bytes=int(memory_peak))
    result = dict(correct=correct, attempted=len(iters), failed=int(failed),
                  metrics=metrics, device=dev)
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = trace_mod.breakdown(summary)
    result["diagnostics"] = dict(
        window_s=window_s, lm_iters=n_iters, gen_s=gen_s, pack_s=pack_s,
        warmup_s=warmup_s, reference_s=ref_s, reference_solve_s=ref_solve_s,
        reference_peak_bytes=torch.cuda.max_memory_allocated(device) if on_card else 0,
        solve_s=[round(d, 6) for d in durations], buckets=shapes,
        reference_loss=ref_result.loss,
        reference_accepted=ref_result.accepted, reference_fallbacks=ref_result.fallbacks,
        start_loss=ref.cost(ref.start),
    )
    result["checks"] = {k: dict(value=v["value"], limit=v["limit"]) for k, v in checks.items()}
    return result


def _finite(obj):
    """``obj`` with every non-finite float written as a string, so the
    line stays strict JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    spec = load_cell(args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 3
    diag = result.pop("diagnostics")
    print(f"portbench: {args.workload} seed {args.seed}: {json.dumps(diag)}", file=sys.stderr)
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
