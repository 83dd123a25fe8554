"""The readers of the program's spans (``portbench/spans.py``): nothing
without a trace, without a tally or without an LM iteration; the right ms
per LM iteration from a hand-made tally; and the three metrics of each
cell present and finite in a traced run of its small form on the CPU."""

import json
import math
import time
from pathlib import Path

import pytest

from portbench import run
from tpu3drecon_torch.utils import timing

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = [m for m in SPEC["per_layer"] if m["source"] == "program_span"]
TRACE = dict(busy_s=0.0, window_s=1.0, launch_calls=0, sync_calls=0, kernels={},
             idle_gaps={})
HAND_MADE = dict(
    spans={
        "lm.iter": dict(calls=4, s=0.40, self_s=0.0, parent="ba.solve"),
        "lm.linearize": dict(calls=4, s=0.10, self_s=0.09, parent="lm.propose"),
        "pcg": dict(calls=4, s=0.20, self_s=0.05, parent="lm.propose"),
        "sync.cg_converged": dict(calls=32, s=0.012, self_s=0.012, parent="pcg"),
        "sync.cho_solve": dict(calls=36, s=0.004, self_s=0.004, parent="pcg.precond"),
        "sync.lm_converged": dict(calls=4, s=0.004, self_s=0.004, parent="ba.solve"),
    },
    counts={"lm.iters": 4, "cg.iters": 32},
)


def _ctx(trace=TRACE):
    return dict(pack_s=1.0, trace=trace, lm_iters=4, buckets=None, kernels=[])


def test_the_six_readers_are_declared():
    assert sorted(m["name"] for m in READERS) == sorted(
        f"solver.{m}_ms_per_lm_iter{s}" for m in ("linearize", "pcg", "sync_wait")
        for s in ("", ".wtt"))
    for m in READERS:
        assert m["unit"] == "ms/iter" and m["layer"] == "solver loop"
        assert m["moves"] == ("lm_iter_s.wtt" if m["name"].endswith(".wtt") else "lm_iter_s")


def test_readers_give_ms_per_lm_iter_from_a_tally(monkeypatch):
    monkeypatch.setattr(timing, "tally", lambda: HAND_MADE)
    values = {m["name"].removesuffix(".wtt"): run._reader(m["name"])(_ctx())
              for m in READERS}
    assert values["solver.linearize_ms_per_lm_iter"] == pytest.approx(25.0)
    assert values["solver.pcg_ms_per_lm_iter"] == pytest.approx(50.0)
    assert values["solver.sync_wait_ms_per_lm_iter"] == pytest.approx(5.0)


def test_readers_read_nothing_without_a_trace_a_tally_or_an_iteration(monkeypatch):
    monkeypatch.setattr(timing, "tally", lambda: HAND_MADE)
    for m in READERS:
        assert run._reader(m["name"])(_ctx(trace=None)) is None, m["name"]
    no_iters = dict(HAND_MADE, counts={"lm.iters": 0})
    monkeypatch.setattr(timing, "tally", lambda: no_iters)
    for m in READERS:
        assert run._reader(m["name"])(_ctx()) is None, m["name"]
    monkeypatch.delattr(timing, "tally")  # a program without the tally
    for m in READERS:
        assert run._reader(m["name"])(_ctx()) is None, m["name"]


def test_a_reader_never_raises(monkeypatch):
    def broken():
        raise RuntimeError("no tally today")

    monkeypatch.setattr(timing, "tally", broken)
    for m in READERS:
        assert run._reader(m["name"])(_ctx()) is None, m["name"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_traced_small_run_reports_the_span_metrics(workload):
    from _small import small_spec

    timing.reset()
    res = run.run_cell(small_spec(workload), 2**31 + 5, 0.1, True, "cpu",
                       t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert timing.tally()["counts"]["lm.iters"] == res["diagnostics"]["lm_iters"]
    want = [m["name"] for m in READERS if workload in m["workloads"]]
    assert len(want) == 3
    for name in want:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name
    timing.reset()
