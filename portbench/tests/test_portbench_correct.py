"""``correct`` at a size the CPU holds: the program agrees with the plain
reference, and the control and each fault a cell can have come out not
correct against the cell's own limits."""

import time

import pytest
import torch

from _small import small_spec
from portbench import compare, generator, run
from portbench.control import control_numbers
from portbench.reference import Reference, round_tf32

CELLS = ("final13682.wtt", "venice1778.flat", "final13682.flat")
SEED = 2**31 + 977


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_the_reference(workload):
    spec = small_spec(workload)
    res = run.run_cell(spec, SEED, 0.3, False, "cpu", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", run.FAULTS)
def test_each_fault_comes_out_not_correct(workload, fault):
    spec = small_spec(workload)
    res = run.run_cell(spec, SEED, 0.2, False, "cpu", t_start=time.perf_counter(),
                       fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(workload):
    spec = small_spec(workload)
    nums = control_numbers(spec, SEED, "cpu")
    checks = compare.judge(nums, spec["limits"])
    assert not all(c["ok"] for c in checks.values()), checks


def test_traced_run_reads_its_per_layer_metrics():
    spec = small_spec("final13682.wtt")
    res = run.run_cell(spec, SEED, 0.2, True, "cpu", t_start=time.perf_counter())
    assert res["correct"]
    assert "inputs.pack_s" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.14159265, 6543.21])
    y = round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0  # a tie rounds to even
    assert y[2] == 1.0 + 2**-10
    for a, b in zip(x[3:], y[3:]):
        assert abs(float(a - b)) <= abs(float(a)) * 2**-11
        assert (b.view(torch.int32) & 0x1FFF) == 0


def test_reference_jacobian_matches_finite_differences():
    spec = small_spec("venice1778.flat")
    inp = generator.make_inputs(spec["config"], 5, "cpu")
    ref = Reference(inp, "float64")
    r, jc, jp = ref._linearize(ref.start)
    sl = slice(0, 50)
    zeros = [torch.zeros(50, w, dtype=torch.float64) for w in (3, 3, 2, 3)]
    assert torch.allclose(ref.residual_after(ref.start, sl, *zeros), r[sl], rtol=0, atol=1e-15)
    eps = 1e-5
    col = 0
    for arg, width in enumerate((3, 3, 2, 3)):
        for k in range(width):
            up, down = [z.clone() for z in zeros], [z.clone() for z in zeros]
            up[arg][:, k], down[arg][:, k] = eps, -eps
            fd = (ref.residual_after(ref.start, sl, *up)
                  - ref.residual_after(ref.start, sl, *down)) / (2 * eps)
            got = jc[sl, :, col] if col < 8 else jp[sl, :, col - 8]
            assert torch.allclose(fd, got, rtol=1e-6, atol=1e-10), col
            col += 1
