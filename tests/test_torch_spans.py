"""The port's spans and counters (``tpu3drecon_torch/utils/timing.py``):
nesting, self time and parents in the tally; nothing recorded and no
``record_function`` entered while off; the LM spans in a CPU profiler's
Chrome trace of a small flat and a small wtt solve (its CPU route, the
plain kernel versions); the CG and sync counters; and outputs bit for bit
the same with the tally on and off."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu3drecon_torch.dataset.synthetic import (
    make_scene,
    make_sequential_scene,
    perturb_scene,
    scene_to_ba_problem,
)
from tpu3drecon_torch.problems.wtt import wtt_from_flat
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, ba_solve
from tpu3drecon_torch.solvers.pcg import pcg
from tpu3drecon_torch.utils import timing

MAXITER = 3
CONFIG = BAConfig(maxiter=MAXITER, gtol=0.0, ftol=0.0, cg_maxiter=4, cg_rtol=0.0)
WTT_CONFIG = CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
# The phases of one LM iteration, children of lm.iter or of lm.propose.
PHASES = ("lm.linearize", "lm.rhs", "pcg", "lm.backsub", "lm.apply", "lm.cost", "lm.update")


@pytest.fixture(autouse=True)
def _empty_tally():
    timing.reset()
    yield
    timing.reset()


def _flat():
    scene = make_scene(n_cameras=6, n_points=200, seed=3)
    noisy = perturb_scene(scene, seed=4, point2d_noise=0.5)
    return scene_to_ba_problem(noisy, observed=scene, dtype=torch.float64, device="cpu")[0]


def _wtt():
    scene = make_sequential_scene(n_cameras=24, points_per_camera=20, track_span=3, seed=5)
    noisy = perturb_scene(scene, seed=6, point2d_noise=0.5)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=torch.float64, device="cpu")
    return wtt_from_flat(flat, point_chunk=64, defer_onehot=True)


SOLVES = {
    "flat": (_flat, lambda p: ba_solve(p, CONFIG, device="cpu")),
    "wtt": (_wtt, lambda p: ba_solve_wtt(p, WTT_CONFIG)),
}


def test_nesting_self_time_and_parents():
    with timing.recording():
        with timing.span("outer"):
            with timing.span("inner"):
                time.sleep(0.02)
            with timing.span("inner"):
                timing.count("things", 2)
            with timing.span("other"):
                time.sleep(0.01)
        with timing.span("outer"):
            timing.count("things")
    t = timing.tally()
    outer, inner, other = (t["spans"][n] for n in ("outer", "inner", "other"))
    assert (outer["calls"], inner["calls"], other["calls"]) == (2, 2, 1)
    assert (outer["parent"], inner["parent"], other["parent"]) == (None, "outer", "outer")
    assert inner["s"] >= 0.02 and other["s"] >= 0.01
    assert outer["s"] >= inner["s"] + other["s"]
    assert outer["self_s"] == pytest.approx(outer["s"] - inner["s"] - other["s"], abs=1e-9)
    assert inner["self_s"] == pytest.approx(inner["s"], abs=1e-12)
    assert t["counts"] == {"things": 3}
    timing.reset()
    assert timing.tally() == {"spans": {}, "counts": {}}


def test_host_wait_spanned_and_nested_recording():
    @timing.spanned("wrapped")
    def f(x):
        with timing.host_wait("site"):
            return x + 1

    assert f(1) == 2 and timing.tally()["spans"] == {}
    with timing.recording():
        with timing.recording():
            f(1)
        f(2)
    t = timing.tally()
    assert t["spans"]["wrapped"]["calls"] == 2
    assert t["spans"]["sync.site"]["parent"] == "wrapped"
    assert t["counts"] == {"sync.site": 2}


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with timing.span("x"):
        timing.count("y")
    build, solve = SOLVES["flat"]
    solve(build())
    assert timing.tally() == {"spans": {}, "counts": {}}
    with pytest.raises(AssertionError, match="entered while off"):
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("x"):
                pass


@pytest.mark.parametrize("engine", sorted(SOLVES))
def test_profiler_trace_holds_the_lm_spans(engine, tmp_path):
    build, solve = SOLVES[engine]
    problem = build()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(problem)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and "dur" in e]

    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]

    iters = spans("lm.iter")
    assert len(iters) == MAXITER and len(spans("ba.solve")) == 1
    for name in ("lm.linearize", "pcg", "lm.cost"):
        inside = spans(name)
        assert len(inside) == MAXITER, name
        assert all(any(s0 <= s and e <= e0 for s0, e0 in iters) for s, e in inside), name
    # The profiler's session also filled the tally, with the same calls.
    t = timing.tally()
    assert t["counts"]["lm.iters"] == MAXITER
    assert t["spans"]["lm.iter"]["calls"] == MAXITER
    assert all(t["spans"][p]["calls"] == MAXITER for p in PHASES)
    assert t["spans"]["lm.propose"]["parent"] == "lm.iter"
    assert t["spans"]["lm.linearize"]["parent"] == "lm.propose"
    assert t["spans"]["pcg.matvec"]["parent"] == "pcg"


@pytest.mark.parametrize("engine", sorted(SOLVES))
def test_outputs_bit_identical_with_the_tally_on_and_off(engine):
    build, solve = SOLVES[engine]
    problem = build()
    cams0, pts0, st0 = solve(problem)
    with timing.recording():
        cams1, pts1, st1 = solve(problem)
    assert timing.tally()["counts"]["lm.iters"] == MAXITER
    assert torch.equal(pts0, pts1) and torch.equal(cams0.rmats, cams1.rmats)
    assert torch.equal(cams0.tvecs, cams1.tvecs) and torch.equal(cams0.fx_fy, cams1.fx_fy)
    assert torch.equal(st0.loss, st1.loss) and torch.equal(st0.lam, st1.lam)
    assert st0.iter_num == st1.iter_num == MAXITER


def test_solve_counters_match_the_solve():
    build, solve = SOLVES["flat"]
    with timing.recording():
        _, _, state = solve(build())
    counts = timing.tally()["counts"]
    assert counts["lm.iters"] == state.iter_num == MAXITER
    # cg_rtol 0: every CG solve runs cg_maxiter iterations, each after one
    # loop-condition read; the LM loop reads converged before each of its
    # first MAXITER iterations (the last test stops at maxiter unread).
    assert counts["cg.iters"] == MAXITER * CONFIG.cg_maxiter
    assert counts["sync.cg_converged"] == MAXITER * CONFIG.cg_maxiter
    assert counts["sync.lm_converged"] == MAXITER
    assert counts["sync.state_init"] == 4
    # One block solve for z0 and one per CG iteration.
    assert counts["sync.cho_solve"] == MAXITER * (CONFIG.cg_maxiter + 1)


def _spd(n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, n, generator=g, dtype=torch.float64)
    return a @ a.T + n * torch.eye(n, dtype=torch.float64)


@pytest.mark.parametrize("rtol,maxiter", [(0.0, 5), (1e-6, 50)])
def test_cg_counters_equal_the_iterations_and_reads(rtol, maxiter):
    a = _spd(12, 7)
    b = torch.ones(12, dtype=torch.float64)
    with timing.recording():
        out = pcg(lambda p: a @ p, lambda r: r, b, maxiter, rtol)
    counts = timing.tally()["counts"]
    assert counts["cg.iters"] == out.iters
    stopped_early = out.iters < maxiter
    assert stopped_early == (rtol > 0)
    # One read before each iteration, and one more where the test stopped it.
    assert counts["sync.cg_converged"] == out.iters + stopped_early
    spans = timing.tally()["spans"]
    assert spans["pcg.matvec"]["calls"] == out.iters
    assert spans["pcg.precond"]["calls"] == out.iters + 1
