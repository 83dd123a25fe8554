"""The control of ``correct``: the plain reference, computed one precision
below the configuration's (TF32 products for float32 with TF32 off), put
in the program's place and judged by ``compare.py`` as a run judges the
program.

    python3 portbench/control.py --workload <name> --seeds 11,12,13

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


def control_numbers(spec: dict, seed: int, device) -> dict:
    """The compared numbers of the control on one seed."""
    import torch

    config, solver = spec["config"], spec["traffic"]["solver"]
    if config["dtype"] != "float32" or config["tf32"]:
        raise ValueError("the control is written for float32 with TF32 off")
    inputs = generator.make_inputs(config, seed, device, getattr(torch, config["dtype"]))
    ref = Reference(inputs, "float64")
    ref_result = ref.solve(solver)
    ctl = Reference(inputs, "tf32").solve(solver)
    # The control reports its own cost, as the program reports its own.
    params = compare.Params(*(getattr(ctl.params, k).to(ref.dtype) for k in compare.GROUPS))
    nums, _ = compare.numbers([ctl.loss], [ctl.iterations], [(params, ctl.loss)], ref,
                              ref_result, solver["maxiter"])
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    spec = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(spec, seed, torch.device("cuda", 0))
        checks = compare.judge(nums, spec["limits"])
        print(json.dumps(dict(workload=args.workload, seed=seed, numbers=nums,
                              fails=[k for k, c in checks.items() if not c["ok"]])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
