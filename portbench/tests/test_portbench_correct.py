"""``correct`` at a size the CPU holds: the program agrees with the plain
reference, and the control and each fault a cell can have come out not
correct against the cell's own limits.  The same for the radial spec
(BAL's camera, k1 and k2 optimized) on the wtt engine; on the flat engine,
which holds k1 and k2 fixed, that spec comes out not correct."""

import dataclasses
import time

import pytest
import torch

from _small import radial_spec, small_spec
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
    nums, _ = control_numbers(spec, SEED, "cpu")
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


def _hold_jacobian_to_finite_differences(ref: Reference) -> None:
    """Every camera column (so3, t, fx fy, then k1 k2 where optimized) and
    point column of ``ref``'s Jacobian against central differences of
    ``residual_after`` on 50 observations."""
    r, jc, jp = ref._linearize(ref.start)
    sl = slice(0, 50)
    widths = (3, 3, 2, 3) + ((2,) if ref.optimize_dist else ())
    zeros = [torch.zeros(50, w, dtype=torch.float64) for w in widths]
    assert torch.allclose(ref.residual_after(ref.start, sl, *zeros), r[sl], rtol=0, atol=1e-15)
    eps = 1e-5
    cam_cols = ([0, 1, 2], [3, 4, 5], [6, 7], None, [8, 9])
    for arg, width in enumerate(widths):
        for k in range(width):
            up, down = [z.clone() for z in zeros], [z.clone() for z in zeros]
            up[arg][:, k], down[arg][:, k] = eps, -eps
            fd = (ref.residual_after(ref.start, sl, *up)
                  - ref.residual_after(ref.start, sl, *down)) / (2 * eps)
            got = jp[sl, :, k] if arg == 3 else jc[sl, :, cam_cols[arg][k]]
            assert torch.allclose(fd, got, rtol=1e-6, atol=1e-10), (arg, k)


def test_reference_jacobian_matches_finite_differences():
    spec = small_spec("venice1778.flat")
    inp = generator.make_inputs(spec["config"], 5, "cpu")
    _hold_jacobian_to_finite_differences(Reference(inp, spec["traffic"]["solver"]))


@pytest.mark.parametrize("optimize_dist", [True, False])
def test_radial_reference_jacobian_matches_finite_differences(optimize_dist):
    spec = radial_spec("wtt")
    inp = generator.make_inputs(spec["config"], 5, "cpu")
    assert bool((inp.dist != 0).all())
    solver = dict(spec["traffic"]["solver"], optimize_dist=optimize_dist)
    ref = Reference(inp, solver)
    assert ref.optimize_dist == optimize_dist and ref.width == (10 if optimize_dist else 8)
    _hold_jacobian_to_finite_differences(ref)


def test_radial_spec_on_the_wtt_engine_agrees_with_the_reference():
    res = run.run_cell(radial_spec("wtt"), SEED, 0.3, False, "cpu",
                       t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", run.FAULTS)
def test_radial_spec_faults_come_out_not_correct(fault):
    res = run.run_cell(radial_spec("wtt"), SEED, 0.2, False, "cpu",
                       t_start=time.perf_counter(), fault=fault)
    assert not res["correct"], res["checks"]


def test_radial_spec_control_comes_out_not_correct():
    spec = radial_spec("wtt")
    nums, solves = control_numbers(spec, SEED, "cpu")
    checks = compare.judge(nums, spec["limits"])
    assert not all(c["ok"] for c in checks.values()), checks
    # A control that moved nothing would show a state left unchanged, not
    # what the lower precision does.
    assert solves["control"]["accepted"] >= 1 and solves["control"]["loss"] < solves["start_loss"]


def test_radial_spec_on_the_flat_engine_comes_out_not_correct():
    # ba_solve takes optimize_dist but its 8-column block never moves k1, k2.
    res = run.run_cell(radial_spec("flat"), SEED, 0.2, False, "cpu",
                       t_start=time.perf_counter())
    assert not res["correct"], res["checks"]
    assert res["checks"]["param_gap"]["value"] >= 1.0


def test_dist_is_compared_only_where_the_reference_optimizes_it():
    spec = radial_spec("wtt")
    inp = generator.make_inputs(spec["config"], 7, "cpu")
    for optimize_dist in (True, False):
        ref = Reference(inp, dict(spec["traffic"]["solver"], optimize_dist=optimize_dist))
        result = ref.solve()
        moved = dataclasses.replace(result.params, dist=result.params.dist + 1e-3)
        nums, _ = compare.numbers([result.loss], [3], [(moved, result.loss)], ref, result, 3)
        assert (nums["param_gap"] > 0) == optimize_dist


REFUSED = [
    dict(loss="cauchy"), dict(precond="jacobi"), dict(optimize_pp=True),
    dict(optimize_focal=False), dict(optimize_points=False), dict(matvec_bf16=True),
    dict(packed_gathers=True), dict(no_such_setting=1),
]


@pytest.mark.parametrize("setting", REFUSED, ids=lambda d: next(iter(d)))
def test_the_reference_refuses_settings_it_does_not_implement(setting):
    spec = small_spec("final13682.wtt")
    inp = generator.make_inputs(spec["config"], 5, "cpu")
    with pytest.raises(ValueError, match=next(iter(setting))):
        Reference(inp, dict(spec["traffic"]["solver"], **setting))


def test_the_reference_refuses_a_solve_without_its_required_settings():
    spec = small_spec("final13682.wtt")
    inp = generator.make_inputs(spec["config"], 5, "cpu")
    solver = dict(spec["traffic"]["solver"])
    del solver["cg_rtol"]
    with pytest.raises(ValueError, match="cg_rtol"):
        Reference(inp, solver)


def test_the_reference_ignores_the_program_route_and_takes_defaults():
    spec = small_spec("final13682.wtt")
    inp = generator.make_inputs(spec["config"], 5, "cpu")
    solver = spec["traffic"]["solver"]
    plain = {k: v for k, v in solver.items() if k not in ("matvec_kernel", "linearize_kernel")}
    named = dict(plain, loss="trivial", optimize_focal=True, optimize_points=True,
                 optimize_pp=False, optimize_dist=False, min_lambda=1e-32, max_lambda=1e32)
    losses = {Reference(inp, s).solve().loss for s in (solver, plain, named)}
    assert len(losses) == 1
