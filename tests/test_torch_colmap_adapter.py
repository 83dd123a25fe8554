"""The port's gated baselines (COLMAP and GTSAM adapters) against JAX's.

Case for case as tests/test_colmap_adapter.py.  pycolmap, gtsam and the
colmap binary are not installed here, so the adapters are pinned on a
recorded Ceres-style report and a stub executable: ``parse_ba_report`` and
``BundleAdjustmentOptions.to_args`` must equal JAX's on the same text and
options, the stub round trip must pass the same arguments and read the
same report, and each missing tool must raise ``BaselineUnavailable``.
"""

import dataclasses
import stat

import pytest

from tpu3drecon.benchmark.adapters import colmap_adapter as j_colmap

from tpu3drecon_torch.benchmark.adapters import colmap_adapter as t_colmap
from tpu3drecon_torch.benchmark.adapters import gtsam_adapter as t_gtsam
from tpu3drecon_torch.benchmark.adapters.colmap_adapter import (
    BaselineUnavailable,
    BundleAdjustmentOptions,
    parse_ba_report,
    perform_bundle_adjustment,
)

# Recorded shape of `colmap bundle_adjuster` stdout (Ceres self-report as
# COLMAP prints it; values synthetic), as in tests/test_colmap_adapter.py.
CERES_STDOUT = """\
==============================================================================
Global bundle adjustment
==============================================================================

iter      cost      cost_change  |gradient|   |step|    tr_ratio  ls_iter  iter_time  total_time
   0  1.204895e+02    0.00e+00    1.84e+02   0.00e+00   0.00e+00        0    8.21e-02   1.62e-01
   1  4.923011e+01    7.13e+01    4.62e+01   1.36e+00   9.96e-01       18    1.94e-01   3.56e-01

Bundle adjustment report
------------------------
    Residuals : 59196
   Parameters : 23541
   Iterations : 27
         Time : 1.30671 [s]
 Initial cost : 0.798092 [px]
   Final cost : 0.296306 [px]
  Termination : Convergence
"""


def _stub(tmp_path, body):
    stub = tmp_path / "colmap"
    stub.write_text("#!/bin/sh\n" + body)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return stub


@pytest.mark.parametrize("text", [
    CERES_STDOUT, "Iterations : 3\nsome noise\n", "  Termination : NO_CONVERGENCE\n", "",
], ids=["full", "partial", "no_convergence", "empty"])
def test_parse_ba_report_equals_jax(text):
    got = parse_ba_report(text)
    want = j_colmap.parse_ba_report(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.raw_stdout == text


def test_full_report_fields():
    r = parse_ba_report(CERES_STDOUT)
    assert (r.residuals, r.parameters, r.iterations) == (59196, 23541, 27)
    assert r.time == pytest.approx(1.30671)
    assert r.initial_cost == pytest.approx(0.798092)
    assert r.final_cost == pytest.approx(0.296306)
    assert r.termination == "Convergence"


@pytest.mark.parametrize("opts", [
    {}, {"max_num_iterations": 55, "refine_principal_point": True},
    {"refine_focal_length": False, "function_tolerance": 1e-6, "refine_extrinsics": False},
])
def test_to_args_equals_jax(opts):
    assert BundleAdjustmentOptions(**opts).to_args() == \
        j_colmap.BundleAdjustmentOptions(**opts).to_args()


def test_missing_binary_raises_baseline_unavailable(tmp_path, monkeypatch):
    monkeypatch.setenv("COLMAP_BIN", str(tmp_path / "nope"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(BaselineUnavailable, match="colmap binary not found"):
        perform_bundle_adjustment(str(tmp_path), str(tmp_path / "out"))


def test_stub_binary_round_trip(tmp_path, monkeypatch):
    stub = _stub(tmp_path, 'echo "$@" > "%s/args.txt"\n' % tmp_path
                 + "cat <<'EOF'\n" + CERES_STDOUT + "EOF\n")
    monkeypatch.setenv("COLMAP_BIN", str(stub))
    opts = BundleAdjustmentOptions(max_num_iterations=55, refine_principal_point=True)
    report = perform_bundle_adjustment(str(tmp_path), str(tmp_path / "out"), opts)
    args = (tmp_path / "args.txt").read_text()
    want = j_colmap.perform_bundle_adjustment(
        str(tmp_path), str(tmp_path / "out"),
        j_colmap.BundleAdjustmentOptions(max_num_iterations=55, refine_principal_point=True))
    assert (tmp_path / "args.txt").read_text() == args
    assert dataclasses.asdict(report) == dataclasses.asdict(want)
    assert report.iterations == 27 and report.termination == "Convergence"
    assert (tmp_path / "out").is_dir()
    assert "--BundleAdjustment.max_num_iterations 55" in args
    assert "--BundleAdjustment.refine_principal_point 1" in args
    assert f"--input_path {tmp_path}" in args


def test_failing_binary_raises_with_stderr(tmp_path, monkeypatch):
    monkeypatch.setenv("COLMAP_BIN", str(_stub(tmp_path, "echo boom >&2\nexit 3\n")))
    with pytest.raises(RuntimeError, match=r"failed \(3\).*boom") as e:
        perform_bundle_adjustment(str(tmp_path), str(tmp_path / "out"))
    assert not isinstance(e.value, BaselineUnavailable)


def test_wall_time_fallback_when_report_lacks_time(tmp_path, monkeypatch):
    monkeypatch.setenv("COLMAP_BIN", str(_stub(tmp_path, 'echo "Iterations : 5"\n')))
    report = perform_bundle_adjustment(str(tmp_path), str(tmp_path / "out"))
    assert report.iterations == 5
    assert report.time is not None and report.time > 0


def test_ba_benchmark_with_stub_binary(tmp_path, monkeypatch):
    """Export in COLMAP format, the (stub) bundle_adjuster copies input to
    output, read the model back: the read-back reproduces the input."""
    from tpu3drecon_torch.benchmark.datasets import get_dataset

    stub = _stub(tmp_path, (
        'in=""; out=""\n'
        'while [ $# -gt 0 ]; do\n'
        '  case "$1" in\n'
        "    --input_path) in=$2; shift 2;;\n"
        "    --output_path) out=$2; shift 2;;\n"
        "    *) shift;;\n"
        "  esac\n"
        "done\n"
        'cp "$in"/* "$out"/\n'
        + "cat <<'EOF'\n" + CERES_STDOUT + "EOF\n"
    ))
    monkeypatch.setenv("COLMAP_BIN", str(stub))
    ds = get_dataset("synthetic_small")
    bench = t_colmap.ColmapBundleAdjustmentBenchmark(ds)
    bench.benchmark(work_dir=str(tmp_path / "work"))
    assert bench.report.termination == "Convergence"
    assert bench.iterations == [27] and bench.time == pytest.approx(1.30671)
    assert len(bench.results.camera_mapping) == len(ds.datasetEntries)
    assert len(bench.results.point_mapping) == len(ds.points3D)
    for pid, p in bench.results.point_mapping.items():
        assert tuple(p.xyz) == tuple(ds.points3D_mapped[pid].xyz)


@pytest.mark.parametrize("adapter, tool", [
    (t_colmap.ColmapSinglePoseBenchmark, "pycolmap"),
    (t_gtsam.GtsamBundleAdjustmentBenchmark, "gtsam"),
    (t_gtsam.GtsamSinglePoseBenchmark, "gtsam"),
])
def test_missing_library_raises_baseline_unavailable(adapter, tool):
    try:
        __import__(tool)
        pytest.skip(f"{tool} installed; gating path not reachable")
    except ImportError:
        pass
    from tpu3drecon_torch.benchmark.datasets import get_dataset

    with pytest.raises(BaselineUnavailable, match=tool):
        adapter(get_dataset("synthetic_small")).benchmark()


def test_one_baseline_error_type():
    assert t_gtsam.BaselineUnavailable is BaselineUnavailable
    assert issubclass(BaselineUnavailable, RuntimeError)
