"""``BENCHMARK.json`` against the rules the harness relies on, the import
rule, the trace reduction, the readers and the card runs."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import roofline, run, trace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu3drecon"}
# Files that must not import the program either: the yardstick.
YARDSTICK = ("reference.py", "generator.py", "compare.py", "trace.py", "roofline.py")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_benchmark_names_units_and_files():
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"] and 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in SPEC["workloads"]] + [
        c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s", "lm_iter_s"}
    for w in SPEC["workloads"]:  # setup_s and one more, and a per-layer metric
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert set(limits) == {"cost_gap", "cost_eval_gap", "param_gap", "iters_off"}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", [])) <= {w["name"] for w in SPEC["workloads"]}


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for name in YARDSTICK:
        assert "tpu3drecon_torch" not in _imports(BENCH / name), name


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, 'portbench/tests'); "
            "from _small import small_spec; from portbench import run; "
            "run.run_cell(small_spec('venice1778.flat'), 3, 0.1, False, 'cpu', "
            "t_start=time.perf_counter()); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "venice1778.flat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _event(cat, name, ts, dur):
    return dict(cat=cat, name=name, ts=ts, dur=dur, ph="X")


def test_summarize_counts_busy_time_and_idle_gaps(tmp_path):
    events = [
        _event("cpu_op", "aten::add", 0, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 1, 2),
        _event("kernel", "void (anonymous namespace)::lin_kernel<float, 8>(int)", 5, 20),
        _event("kernel", "void at::native::indexFuncLargeIndex<float>(int)", 20, 10),
        _event("cpu_op", "aten::index_add_", 40, 20),
        _event("cuda_runtime", "cudaStreamSynchronize", 45, 5),
        _event("gpu_memcpy", "Memcpy DtoH", 70, 10),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(str(path))
    assert s["busy_s"] == pytest.approx(35e-6) and s["window_s"] == pytest.approx(80e-6)
    assert s["launch_calls"] == 1 and s["sync_calls"] == 1
    gaps = s["idle_gaps"]
    assert gaps["aten::add"] == pytest.approx(5) and gaps["aten::index_add_"] == pytest.approx(20)
    assert gaps["host_between_ops"] == pytest.approx(20)
    b = trace.breakdown(s)
    assert b["device_ops"][0][1] == pytest.approx(20e-6)


def test_readers_read_the_summary_or_nothing():
    summary = dict(busy_s=0.5, window_s=2.0, launch_calls=300, sync_calls=30,
                   kernels={"void (anonymous namespace)::coupling_kernel<float, 8, 3>(x)": [4, 4e5],
                            "void at::native::indexFuncLargeIndex<float>(x)": [6, 3000.0]},
                   idle_gaps={})
    buckets = [(10, 8, 512, 256, 30000), (4, 12, 512, 384, 20000)]
    ctx = dict(pack_s=1.5, trace=summary, lm_iters=3, buckets=buckets,
               kernels=["lin_kernel", "coupling_kernel"])
    values = {m["name"]: run._reader(m["name"])(ctx) for m in SPEC["per_layer"]}
    assert values["inputs.pack_s"] == 1.5
    assert values["solver.launches_per_lm_iter"] == 100
    assert values["solver.launches_per_lm_iter.wtt"] == 100
    assert values["solver.syncs_per_lm_iter"] == 10
    assert values["device.idle_pct"] == pytest.approx(75.0)
    assert values["flat.segment_sum_ms_per_lm_iter"] == pytest.approx(1.0)
    least = 2 * roofline.pass_least_s("coupling_kernel", buckets)
    assert values["kernels.wtt_roofline"] == pytest.approx(100 * least / 0.4)
    empty = dict(ctx, trace=None, buckets=None)
    for m in SPEC["per_layer"]:
        if m["name"] != "inputs.pack_s":
            assert run._reader(m["name"])(empty) is None, m["name"]


def test_bytes_count_each_input_and_output_once():
    # One group, one track row of 512 slots, a 128-row window, every slot live.
    g, tb, pc, w, e = 1, 1, 512, 128, 4
    slots = g * tb * pc
    assert roofline.bucket_bytes("cost_kernel", g, tb, pc, w, slots) == (
        2 * slots + w * 19 * e + 3 * pc * e + 3 * slots * e + pc * e)
    assert roofline.bucket_bytes("coupling_kernel", g, tb, pc, w, slots) == (
        2 * 8 * w * e + 2 * slots + 22 * slots * e + 6 * pc * e)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_small_cell_on_the_card(cuda_device, workload):
    import time

    from _small import small_spec

    res = run.run_cell(small_spec(workload), 2**31 + 3, 0.5, True, cuda_device,
                       t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


def test_an_unlisted_cell_takes_a_config_a_traffic_and_limits():
    from _small import RADIAL_CONFIG

    limits = dict(cost_gap=1.0, cost_eval_gap=1.0, param_gap=1.0, iters_off=0.0)
    spec = run.unlisted_cell(RADIAL_CONFIG, "wtt_fixed3", limits=limits)
    assert spec["traffic"]["name"] == "wtt_fixed3" and spec["limits"] == limits
    assert spec["config"]["camera"]["model"] == "radial" and spec["end_to_end"] == []
    listed = run.load_cell("venice1778.flat")
    by_file = run.unlisted_cell(RADIAL_CONFIG, BENCH / "traffic" / "flat_fixed3.json",
                                limits=BENCH / "limits" / "venice1778.flat.json")
    assert by_file["traffic"] == listed["traffic"] and by_file["limits"] == listed["limits"]
    assert by_file["per_layer"] == [] and by_file["cell"]["chips"] == 1
    with pytest.raises(TypeError):
        run.unlisted_cell(RADIAL_CONFIG, "wtt_fixed3")


@pytest.mark.parametrize("argv", [["--seeds", "1"],
                                  ["--workload", "final13682.wtt", "--config", "x.json",
                                   "--seeds", "1"],
                                  ["--config", "x.json", "--traffic", "wtt_fixed3",
                                   "--seeds", "1"]])
def test_the_control_takes_a_listed_or_a_whole_unlisted_cell(argv):
    from portbench import control

    with pytest.raises(SystemExit):
        control.main(argv)
