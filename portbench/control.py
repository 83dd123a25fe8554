"""The control of ``correct``: the plain reference, computed one precision
below the configuration's (TF32 products for float32 with TF32 off), put
in the program's place and judged by ``compare.py`` as a run judges the
program.

    python3 portbench/control.py --workload <name> --seeds 11,12,13
    python3 portbench/control.py --config <file> --traffic <name or file> \
        --limits <file> --seeds 11,12,13

The second form takes a cell that ``BENCHMARK.json`` does not list yet
(``run.unlisted_cell``), so that a cell's limits can be set from its
control before the cell is added.

Prints one JSON line per seed with the compared numbers, which have to
fail the cell's limits.  For each seed it makes the cell's inputs on the
card, solves them with the float64 reference and with the control, and
compares the control's answer as the first and last answer of a window.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, generator, run  # noqa: E402
from portbench.reference import Reference  # noqa: E402


def control_numbers(spec: dict, seed: int, device) -> tuple[dict, dict]:
    """The compared numbers of the control on one seed, and what the
    reference's and the control's solves did: start and end cost, steps
    accepted, camera blocks whose preconditioner fell back to chol(U)."""
    import torch

    config, solver = spec["config"], spec["traffic"]["solver"]
    if config["dtype"] != "float32" or config["tf32"]:
        raise ValueError("the control is written for float32 with TF32 off")
    inputs = generator.make_inputs(config, seed, device, getattr(torch, config["dtype"]))
    ref = Reference(inputs, solver, "float64")
    ref_result = ref.solve()
    ctl = Reference(inputs, solver, "tf32").solve()
    # The control reports its own cost, as the program reports its own.
    nums, _ = compare.numbers([ctl.loss], [ctl.iterations],
                              [(ctl.params.to(ref.dtype), ctl.loss)], ref, ref_result,
                              solver["maxiter"])
    solves = {name: dict(loss=r.loss, accepted=r.accepted, fallbacks=r.fallbacks)
              for name, r in (("reference", ref_result), ("control", ctl))}
    return nums, dict(solves, start_loss=ref.cost(ref.start))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", help="a cell of BENCHMARK.json")
    ap.add_argument("--config", help="an unlisted cell's configuration file")
    ap.add_argument("--traffic", help="its traffic: a name under traffic/ or a file")
    ap.add_argument("--limits", help="its limits file")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    unlisted = (args.config, args.traffic, args.limits)
    if any(unlisted) if args.workload else not all(unlisted):
        ap.error("give --workload, or --config, --traffic and --limits")
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    if args.workload is not None:
        spec = run.load_cell(args.workload)
    else:
        spec = run.unlisted_cell(args.config, args.traffic, limits=args.limits)
    name = spec["cell"]["name"]
    for seed in (int(s) for s in args.seeds.split(",")):
        nums, solves = control_numbers(spec, seed, torch.device("cuda", 0))
        checks = compare.judge(nums, spec["limits"])
        print(json.dumps(dict(workload=name, config=spec["config"]["name"],
                              traffic=spec["traffic"]["name"], seed=seed, numbers=nums,
                              fails=[k for k, c in checks.items() if not c["ok"]],
                              solves=solves)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
