"""The port's benchmark harness against JAX's: the dataset registry, the
adapters, persistence, process isolation, the drivers and the reports.

Case for case as tests/test_benchmark_harness.py holds JAX's.  Both
packages load the registry's synthetic_small (8 cameras, 300 points, seed
100) from their own COLMAP writer and reader; the noised copies are drawn
with an explicit ``np.random.default_rng(7)`` in each (never the
module-global generator, whose draws depend on call order) and agree to
~1e-15; the adapters then run on the JAX copy's exact values.  At f64 the
torch adapters must give JAX's adapters' cameras, points and iteration
counts on bit-identical inputs (BA to rtol 1e-7, atol 1e-7: the
solutions part along the gauge at ~1e-8; PnP to rtol 1e-8), the port's
scipy adapters JAX's to 1e-10; a saved benchmark loads in a process where
``jax`` and ``tpu3drecon`` cannot be imported, and a spawned child
(``subprocess_benchmark(device="cpu")``) gives the in-process results.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drecon.benchmark import datasets as j_datasets
from tpu3drecon.benchmark.adapters import scipy_adapter as j_scipy
from tpu3drecon.benchmark.adapters import tpu_adapters as j_tpu
from tpu3drecon.dataset.scene import Dataset as JDataset

from tpu3drecon_torch.benchmark import datasets as t_datasets
from tpu3drecon_torch.benchmark import drivers
from tpu3drecon_torch.benchmark import reporting as rep
from tpu3drecon_torch.benchmark.adapters import scipy_adapter as t_scipy
from tpu3drecon_torch.benchmark.adapters import torch_adapters as t_adapters
from tpu3drecon_torch.benchmark.harness import (
    BundleAdjustmentBenchmark,
    load_benchmarks,
    save_benchmarks,
)
from tpu3drecon_torch.dataset.scene import Dataset as TDataset

ROOT = Path(__file__).resolve().parent.parent
POSE_NOISE = dict(point3d_noise=0.0, point2d_noise=0.0, camera_rotation_noise=2e-2,
                  camera_translation_noise=5e-2, camera_intrinsics_noise=0.0)


def _noised(ds, cls, **noise):
    return cls.with_noise(ds, rng=np.random.default_rng(7), **noise)


@pytest.fixture(scope="module")
def datasets():
    j = j_datasets.get_dataset("synthetic_small")
    t = t_datasets.get_dataset("synthetic_small")
    return j, t


def _jax_values(td, jd):
    """``td`` with ``jd``'s poses, points and observations: the two
    packages' noisers agree to ~1e-15 (the test below), and the adapters are
    compared on bit-identical inputs, since BA amplifies such differences
    along its gauge."""
    td = copy.deepcopy(td)
    for tp, jp in zip(td.points3D, jd.points3D):
        tp.x, tp.y, tp.z = jp.x, jp.y, jp.z
    for te, je in zip(td.datasetEntries, jd.datasetEntries):
        te.camera.camera_pose.rotation = je.camera.camera_pose.rotation.copy()
        te.camera.camera_pose.translation = je.camera.camera_pose.translation.copy()
        for tq, jq in zip(te.points2D, je.points2D):
            tq.x, tq.y = jq.x, jq.y
        te.refresh_mapping()
    td.refresh_mapping()
    return td


@pytest.fixture(scope="module")
def drawn(datasets):
    """Each package's own noised copy, drawn from the same seed."""
    j, t = datasets
    return _noised(j, JDataset), _noised(t, TDataset)


@pytest.fixture(scope="module")
def noised(drawn):
    jd, td = drawn
    return jd, _jax_values(td, jd)


@pytest.fixture(scope="module")
def pose_noised(datasets):
    j, t = datasets
    jd = _noised(j, JDataset, **POSE_NOISE)
    return jd, _jax_values(_noised(t, TDataset, **POSE_NOISE), jd)


@pytest.fixture(scope="module")
def ba_pair(noised):
    jd, td = noised
    jb = j_tpu.TpuBundleAdjustmentBenchmark(jd, dtype=jnp.float64)
    jb.benchmark()
    tb = t_adapters.TorchBundleAdjustmentBenchmark(td, dtype=torch.float64)
    tb.benchmark(device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def scipy_ba(noised):
    jd, td = noised
    jb = j_scipy.ScipyBundleAdjustmentBenchmark(jd)
    jb.benchmark(maxiter=60)
    tb = t_scipy.ScipyBundleAdjustmentBenchmark(td)
    tb.benchmark(maxiter=60)
    return jb, tb


def _cam_arrays(mapping):
    out = {}
    for i, cam in sorted(mapping.items()):
        intr = cam.camera_intrinsics
        out[i] = np.concatenate([
            cam.camera_pose.rotation.ravel(), cam.camera_pose.translation,
            [intr.focal_x, intr.focal_y, intr.center_x, intr.center_y, intr.skew_factor or 0.0],
        ])
    return np.stack([out[i] for i in sorted(out)])


def _pt_arrays(mapping):
    ids = sorted(mapping)
    return ids, np.stack([mapping[i].xyz for i in ids])


def assert_same_results(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(_cam_arrays(got.camera_mapping), _cam_arrays(want.camera_mapping),
                               rtol=rtol, atol=atol)
    if hasattr(want, "point_mapping"):
        g_ids, g_xyz = _pt_arrays(got.point_mapping)
        w_ids, w_xyz = _pt_arrays(want.point_mapping)
        assert g_ids == w_ids
        np.testing.assert_allclose(g_xyz, w_xyz, rtol=rtol, atol=atol)


# ---- the registry -------------------------------------------------------------


def test_registry_names_equal_jax():
    assert t_datasets.available() == j_datasets.available()
    assert t_datasets.available(include_disk_gated=True) == \
        j_datasets.available(include_disk_gated=True)
    assert "reichstag" not in t_datasets.available()
    assert "reichstag_noised" in t_datasets.available(include_disk_gated=True)
    assert sorted(t_datasets.REGISTRY) == sorted(j_datasets.REGISTRY)
    with pytest.raises(KeyError):
        t_datasets.get_dataset("nope")


@pytest.mark.parametrize("name", ["synthetic_small", "synthetic_medium"])
def test_unnoised_synthetic_datasets_equal_jax(name):
    j = j_datasets.get_dataset(name)
    t = t_datasets.get_dataset(name)
    assert t.name == j.name == name
    assert [p.identifier for p in t.points3D] == [p.identifier for p in j.points3D]
    np.testing.assert_array_equal([p.xyz for p in t.points3D], [p.xyz for p in j.points3D])
    assert len(t.datasetEntries) == len(j.datasetEntries)
    for te, je in zip(t.datasetEntries, j.datasetEntries):
        np.testing.assert_allclose(te.camera.camera_pose.rotation,
                                   je.camera.camera_pose.rotation, rtol=0, atol=1e-15)
        np.testing.assert_array_equal(te.camera.camera_pose.translation,
                                      je.camera.camera_pose.translation)
        assert (te.camera.width, te.camera.height) == (je.camera.width, je.camera.height)
        assert [(p.x, p.y, p.point3D_identifier) for p in te.points2D] == \
            [(p.x, p.y, p.point3D_identifier) for p in je.points2D]


def test_noised_datasets_equal_jax_with_an_explicit_rng(drawn):
    jd, td = drawn
    np.testing.assert_allclose([p.xyz for p in td.points3D], [p.xyz for p in jd.points3D],
                               rtol=1e-15, atol=0)
    for te, je in zip(td.datasetEntries, jd.datasetEntries):
        np.testing.assert_allclose(te.camera.camera_pose.translation,
                                   je.camera.camera_pose.translation, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose([p.xy for p in te.points2D], [p.xy for p in je.points2D],
                                   rtol=1e-15, atol=0)


# ---- the adapters ----------------------------------------------------------------


def test_torch_ba_adapter_equals_jax(noised, ba_pair):
    jb, tb = ba_pair
    assert tb.iterations == jb.iterations
    # The same trajectory; the two solvers' rounding parts the converged
    # solutions along the gauge at ~1e-8.
    assert_same_results(tb.results, jb.results, rtol=1e-7, atol=1e-7)
    before = noised[1].compute_reprojection_errors_alt(lambda x: x)
    after = tb.reprojection_errors()
    assert np.mean(np.concatenate(list(after.values()))) < \
        0.01 * np.mean(np.concatenate(list(before.values())))
    assert tb.time > 0 and tb.compile_time is not None
    assert tb.FRAMEWORK == "tpu3drecon_torch"


def test_scipy_adapters_equal_jax(scipy_ba, pose_noised):
    jb, tb = scipy_ba
    assert tb.iterations == jb.iterations
    assert_same_results(tb.results, jb.results, rtol=1e-10, atol=1e-10)
    jd, td = pose_noised
    js = j_scipy.ScipySinglePoseBenchmark(jd)
    js.benchmark()
    ts = t_scipy.ScipySinglePoseBenchmark(td)
    ts.benchmark()
    assert ts.iterations == js.iterations
    assert_same_results(ts.results, js.results, rtol=1e-10, atol=1e-10)
    assert np.nanmean(list(drivers.mean_reprojection_errors(ts).values())) < 1e-3


def test_parity_of_torch_and_scipy(ba_pair, scipy_ba):
    """Both end below JAX's bound of 1.0 px^2 mean error per camera."""
    for b in (ba_pair[1], scipy_ba[1]):
        assert np.nanmean(list(drivers.mean_reprojection_errors(b).values())) < 1.0


def test_torch_pose_adapter_equals_jax(pose_noised):
    jd, td = pose_noised
    jb = j_tpu.TpuSinglePoseBenchmark(jd, dtype=jnp.float64)
    jb.benchmark(maxiter=100)
    tb = t_adapters.TorchSinglePoseBenchmark(td, dtype=torch.float64)
    tb.benchmark(maxiter=100, device="cpu")
    assert tb.iterations == jb.iterations
    assert len(tb.iterations) == len(td.datasetEntries)
    assert_same_results(tb.results, jb.results, rtol=1e-8, atol=1e-9)
    assert np.nanmean(list(drivers.mean_reprojection_errors(tb).values())) < 1e-3


def test_adapters_need_a_card(noised, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (t_adapters.TorchBundleAdjustmentBenchmark, t_adapters.TorchSinglePoseBenchmark):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(noised[1]).benchmark()


def test_nan_guard():
    with pytest.raises(t_adapters.NanGuardError):
        t_adapters._check_finite("points", np.array([1.0, np.nan]))


# ---- persistence and process isolation -----------------------------------------


_LOAD_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["tpu3drecon"] = None
from tpu3drecon_torch.benchmark.harness import load_benchmarks
(b,) = load_benchmarks(sys.argv[1])
errs = b.reprojection_errors()
assert len(errs) == len(b.dataset.datasetEntries)
assert not any(k == "jax" or k.startswith(("jax.", "tpu3drecon.")) for k, v in sys.modules.items()
               if v is not None)
print("LOADED", type(b).__name__, b.time, len(b.results.point_mapping))
"""


def test_save_load_round_trip(ba_pair, tmp_path):
    tb = ba_pair[1]
    out = save_benchmarks([tb], str(tmp_path))
    assert os.path.isdir(tmp_path / "latest")
    (lb,) = load_benchmarks(out)
    assert lb.time == tb.time and lb.iterations == tb.iterations
    assert_same_results(lb.results, tb.results, rtol=0)
    assert len(lb.reprojection_errors()) == len(tb.dataset.datasetEntries)
    run = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_JAX, out], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert f"LOADED TorchBundleAdjustmentBenchmark {tb.time}" in run.stdout


def test_export_results_colmap(ba_pair, tmp_path):
    from tpu3drecon_torch.io import colmap as cio

    tb = ba_pair[1]
    tb.export_results_in_colmap_format(str(tmp_path / "export"), binary=True)
    model = cio.read_model(str(tmp_path / "export"))
    assert len(model.images) == len(tb.dataset.datasetEntries)


def test_subprocess_benchmark_equals_in_process(ba_pair, noised):
    tb = ba_pair[1]
    child = t_adapters.TorchBundleAdjustmentBenchmark(noised[1], dtype=torch.float64)
    child.subprocess_benchmark(timeout_s=300, device="cpu")
    assert child.iterations == tb.iterations
    assert_same_results(child.results, tb.results, rtol=0)


def test_subprocess_benchmark_without_a_card_fails():
    """A child asked for ``cuda`` where there is none fails; it does not
    drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tiny = t_datasets.get_dataset("synthetic_small").make_reduced_dataset(2, 20)
    b = t_adapters.TorchBundleAdjustmentBenchmark(tiny)
    with pytest.raises(RuntimeError, match="exited with code"):
        b.subprocess_benchmark(timeout_s=120, device="cuda")
    assert b.results is None


# ---- drivers and reports ---------------------------------------------------------


@pytest.fixture(scope="module")
def driven(noised, tmp_path_factory):
    """Both drivers with every baseline asked for: COLMAP and GTSAM are not
    installed here and are skipped with a printed line."""
    root = tmp_path_factory.mktemp("results")
    ba = drivers.benchmark_bundle_adjustment(
        noised[1], camera_limit=4, points_limit=100, results_root=str(root / "ba"),
        device="cpu")
    return root, ba


def test_ba_driver_skips_the_gated_baselines(driven, capsys):
    root, ba = driven
    assert [b.FRAMEWORK for b in ba] == ["tpu3drecon_torch", "scipy"]
    assert os.path.isdir(root / "ba" / "latest")
    for b in ba:
        assert len(b.dataset.datasetEntries) == 4
        assert np.isfinite(np.nanmean(list(drivers.mean_reprojection_errors(b).values())))


def test_single_pose_driver(pose_noised, tmp_path, capsys):
    sp = drivers.benchmark_single_pose(pose_noised[1], results_root=str(tmp_path),
                                       device="cpu", maxiter=50)
    out = capsys.readouterr().out
    assert "skipping COLMAP baseline" in out
    assert [b.FRAMEWORK for b in sp] == ["tpu3drecon_torch", "scipy"]
    loaded_names = sorted(type(b).__name__ for b in load_benchmarks(str(tmp_path / "latest")))
    assert loaded_names == ["ScipySinglePoseBenchmark", "TorchSinglePoseBenchmark"]


def test_gated_baselines_print_their_skip_lines(noised, capsys, tmp_path):
    from tpu3drecon_torch.benchmark.adapters import colmap_adapter, gtsam_adapter

    for mod, name in ((colmap_adapter, "pycolmap"), (gtsam_adapter, "gtsam")):
        try:
            __import__(name)
            pytest.skip(f"{name} installed; gating path not reachable")
        except ImportError:
            pass
    env_path = os.environ.get("PATH", "")
    os.environ["PATH"] = str(tmp_path)
    try:
        drivers.benchmark_bundle_adjustment(noised[1], camera_limit=2, points_limit=20,
                                            with_scipy_baseline=False, save=False,
                                            device="cpu")
    finally:
        os.environ["PATH"] = env_path
    out = capsys.readouterr().out
    assert "skipping COLMAP baseline" in out and "skipping GTSAM baseline" in out
    assert "Cross-framework mean reprojection errors" in out


def test_reports_render(driven, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    root, ba = driven
    monkeypatch.setattr(rep, "EVALUATION_PATH", str(tmp_path))
    paths = rep.bundle_adjustment_statistics(ba, "synthetic_small_noised")
    assert len(paths) == 3 and all(os.path.getsize(p) > 0 for p in paths)
    replotted = rep.replot_latest(str(root / "ba"), "replot")
    assert sorted(os.path.basename(p) for p in replotted) == \
        ["ba_iterations.png", "ba_reprojection_errors.png", "ba_runtimes.png"]


def test_plots_name_matplotlib_when_it_is_missing(ba_pair, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        rep.runtime_bars([ba_pair[1]], "x")


def test_cost_curve_equals_jax(pose_noised, tmp_path, monkeypatch):
    """The samples of ``pose_cost_curve`` equal those of JAX's
    ``plot_pose_cost_curve`` loop (its rodrigues_to_matrix,
    matrix_to_rodrigues and pose_residuals_per_axis) to 1e-10."""
    from tpu3drecon.geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
    from tpu3drecon.problems.from_dataset import pose_problem_from_dataset as j_pose_problem
    from tpu3drecon.solvers.pose_refine import pose_residuals_per_axis

    from tpu3drecon_torch.problems.from_dataset import pose_problem_from_dataset
    from tpu3drecon_torch.solvers.pose_refine import pose_params_pack

    jd, td = pose_noised
    problem, _ = pose_problem_from_dataset(td, dtype=torch.float64, device="cpu")
    jproblem, _ = j_pose_problem(jd, dtype=jnp.float64)
    p0 = pose_params_pack(problem.cameras)[1].numpy()
    p1 = p0 + np.array([0.02, -0.01, 0.015, 0.1, -0.05, 0.2, 3.0, -2.0])
    ts, costs = rep.pose_cost_curve(problem, 1, p0, p1, n_samples=7)

    r0 = rodrigues_to_matrix(jnp.asarray(p0[:3]))
    r1 = rodrigues_to_matrix(jnp.asarray(p1[:3]))
    rel = matrix_to_rodrigues(jnp.asarray(np.asarray(r0).T @ np.asarray(r1)))
    want = []
    for t in np.linspace(0.0, 1.0, 7):
        rt = np.asarray(r0) @ np.asarray(rodrigues_to_matrix(jnp.asarray(t * np.asarray(rel))))
        pt = np.concatenate([np.asarray(matrix_to_rodrigues(jnp.asarray(rt))),
                             (1 - t) * p0[3:] + t * p1[3:]])
        res = pose_residuals_per_axis(
            jnp.asarray(pt), jproblem.points3d[1], jproblem.points2d[1],
            jproblem.cameras.cx_cy_skew[1], jproblem.cameras.dist[1], jproblem.mask[1],
            jproblem.avg_cam_width)
        want.append(0.5 * float(np.sum(np.asarray(res) ** 2)))
    np.testing.assert_array_equal(ts, np.linspace(0.0, 1.0, 7))
    np.testing.assert_allclose(costs, want, rtol=1e-10)
    pytest.importorskip("matplotlib")
    monkeypatch.setattr(rep, "EVALUATION_PATH", str(tmp_path))
    assert os.path.exists(rep.plot_pose_cost_curve(problem, 1, p0, p1, n_samples=5))


def test_reduced_results_rematerialize(ba_pair):
    """A BA benchmark's results dataset keeps every camera and only the
    surviving points."""
    ds = BundleAdjustmentBenchmark.shallow_results_dataset(ba_pair[1])
    assert len(ds.points3D) == len(ba_pair[1].results.point_mapping)
    assert len(ds.datasetEntries) == len(ba_pair[1].dataset.datasetEntries)
