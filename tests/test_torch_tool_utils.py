"""The port's last utils against JAX's: the scene exports
(``utils/visualization.py``), the spawn pool (``utils/multiprocess.py``),
the disk cache of built problems (``utils/problem_cache.py``) and the
fd-level capture (``benchmark/adapters/output_grabber.py``).

Scenes come from seeds (``make_scene`` seed 91, 5 cameras, 100 points, as
tests/test_utils.py).  The PLY and OBJ writers must write JAX's bytes from
the same numpy inputs; the pool must give the serial results; the cache
must miss, hit, bypass, clear and place its tensors on the caller's device,
round-trip a wtt problem bit for bit, and never read JAX's entries (nor
JAX the port's) in a shared directory.
"""

import math
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from _torch_ref import np_fields, to_np

from tpu3drecon.benchmark import datasets as j_datasets
from tpu3drecon.dataset.synthetic import make_scene
from tpu3drecon.utils import problem_cache as j_cache
from tpu3drecon.utils import visualization as j_viz

from tpu3drecon_torch.benchmark import datasets as t_datasets
from tpu3drecon_torch.utils import problem_cache as t_cache
from tpu3drecon_torch.utils import visualization as t_viz
from tpu3drecon_torch.utils.multiprocess import ListMultiProcessor


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_cameras=5, n_points=100, seed=91)


def _ks(scene):
    return np.stack([
        [[scene.fx_fy[c, 0], 0, scene.cx_cy_skew[c, 0]],
         [0, scene.fx_fy[c, 1], scene.cx_cy_skew[c, 1]],
         [0, 0, 1]]
        for c in range(scene.n_cameras)
    ])


def _export(viz, scene, out, colors):
    return viz.export_scene(
        str(out), scene.points3d, scene.rmats, scene.tvecs, _ks(scene),
        [scene.width] * scene.n_cameras, [scene.height] * scene.n_cameras,
        colors=colors, frustum_depth=1.5,
    )


def test_frustum_corners_equal_jax(scene):
    for c in range(scene.n_cameras):
        args = (scene.rmats[c], scene.tvecs[c], _ks(scene)[c], scene.width, scene.height, 2.0)
        got = t_viz.frustum_corners(*args)
        np.testing.assert_array_equal(got, j_viz.frustum_corners(*args))
        np.testing.assert_allclose(got[0], -scene.rmats[c].T @ scene.tvecs[c], atol=1e-9)
        np.testing.assert_allclose(((got[1:] - got[0]) @ scene.rmats[c].T)[:, 2], 2.0,
                                   atol=1e-9)


@pytest.mark.parametrize("with_colors", [False, True], ids=["plain", "colored"])
def test_ply_and_obj_bytes_equal_jax(scene, tmp_path, with_colors):
    colors = (np.random.default_rng(3).integers(0, 256, (scene.n_points, 3))
              if with_colors else None)
    got = _export(t_viz, scene, tmp_path / "port", colors)
    want = _export(j_viz, scene, tmp_path / "jax", colors)
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g
    header = open(got[0]).read().split("end_header")[0]
    assert f"element vertex {scene.n_points}" in header
    assert open(got[1]).read().count("\nl ") == scene.n_cameras * 8


def test_dataset_export_matches_jax(tmp_path):
    """``export_dataset_scene`` of the registry's synthetic_small: the PLY is
    JAX's byte for byte; the frusta agree to 1e-12 (the poses come from
    each package's quaternion-to-matrix conversion of the same file)."""
    t_ply, t_obj = t_viz.export_dataset_scene(t_datasets.get_dataset("synthetic_small"),
                                              str(tmp_path / "port"))
    j_ply, j_obj = j_viz.export_dataset_scene(j_datasets.get_dataset("synthetic_small"),
                                              str(tmp_path / "jax"))
    assert open(t_ply, "rb").read() == open(j_ply, "rb").read()

    def obj_rows(path):
        lines = open(path).read().splitlines()
        verts = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                          if ln.startswith("v ")])
        return verts, [ln for ln in lines if not ln.startswith("v ")]

    tv, tl = obj_rows(t_obj)
    jv, jl = obj_rows(j_obj)
    assert tl == jl
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=1e-12)


def test_matplotlib_quicklook(scene, tmp_path):
    pytest.importorskip("matplotlib")
    path = t_viz.plot_scene_matplotlib(
        scene.points3d, np.einsum("cji,cj->ci", scene.rmats, -scene.tvecs),
        str(tmp_path / "scene.png"))
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("workers", [1, 2])
def test_list_processor_matches_serial(workers):
    """The spawn pool (2 workers) and the serial path give the serial map."""
    items = list(range(40))
    seen = []
    out = ListMultiProcessor(items, math.factorial, num_processes=workers,
                             progress=lambda i, n: seen.append((i, n))).process()
    assert out == [math.factorial(x) for x in items]
    if workers > 1:
        assert seen[-1] == (40, 40)
    assert ListMultiProcessor([], math.factorial, num_processes=workers).process() == []


# ---- the problem cache -------------------------------------------------------


def _wtt_flat():
    from tpu3drecon_torch.dataset.synthetic import (
        make_sequential_scene,
        perturb_scene,
        scene_to_ba_problem,
    )

    scene = make_sequential_scene(n_cameras=12, points_per_camera=40, track_span=3, seed=5)
    noisy = perturb_scene(scene, seed=6, point2d_noise=0.3)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=torch.float32, device="cpu")
    return flat


def test_cache_miss_hit_and_numpy_storage(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return {"a": torch.arange(5, dtype=torch.float32), "b": (torch.ones(2, 3, dtype=torch.int16),),
                "c": torch.tensor([1.5, -2.0], dtype=torch.bfloat16), "static": 7}

    before = dict(t_cache.COUNTS)
    out1 = t_cache.cached_problem("k1_v1", build, cache_dir=tmp_path, device="cpu")
    out2 = t_cache.cached_problem("k1_v1", build, cache_dir=tmp_path, device="cpu")
    assert len(calls) == 1
    assert t_cache.COUNTS["miss"] - before["miss"] == 1
    assert t_cache.COUNTS["hit"] - before["hit"] == 1
    for out in (out1, out2):
        assert out["a"].dtype == torch.float32 and out["b"][0].dtype == torch.int16
        assert out["c"].dtype == torch.bfloat16 and out["static"] == 7
        torch.testing.assert_close(out["c"], torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    torch.testing.assert_close(out1["a"], out2["a"], rtol=0, atol=0)
    # On disk: numpy arrays only, in the port's own file name.
    (entry,) = tmp_path.iterdir()
    assert entry == t_cache.entry_path("k1_v1", tmp_path)
    assert entry.name.endswith(".torch.pickle")
    with open(entry, "rb") as f:
        stored = pickle.load(f)
    assert isinstance(stored["a"].array, np.ndarray) and stored["a"].dtype == "float32"
    t_cache.cached_problem("k2_v1", build, cache_dir=tmp_path, device="cpu")
    assert len(calls) == 2


def test_cache_places_on_the_callers_device(tmp_path, monkeypatch):
    """A hit needs no device of its own: the tensors go where ``device``
    says (``meta`` here), and with no device and no card the call raises."""
    build = lambda: {"a": torch.arange(4.0)}  # noqa: E731
    t_cache.cached_problem("kd_v1", build, cache_dir=tmp_path, device="cpu")
    out = t_cache.cached_problem("kd_v1", lambda: 1 / 0, cache_dir=tmp_path, device="meta")
    assert out["a"].device.type == "meta" and out["a"].shape == (4,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cache.cached_problem("kd_v1", build, cache_dir=tmp_path)


def test_cache_disable_env_and_clear(tmp_path, monkeypatch):
    calls = []

    def build():
        calls.append(1)
        return torch.zeros(3)

    monkeypatch.setenv("TPU3DRECON_PROBLEM_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("TPU3DRECON_PROBLEM_CACHE_DISABLE", "1")
    t_cache.cached_problem("kx_v1", build, device="cpu")
    t_cache.cached_problem("kx_v1", build, device="cpu")
    assert len(calls) == 2 and not list(tmp_path.iterdir())
    monkeypatch.setenv("TPU3DRECON_PROBLEM_CACHE_DISABLE", "0")
    t_cache.cached_problem("kx_v1", build, device="cpu")
    t_cache.cached_problem("ky_v1", build, device="cpu")
    assert len(calls) == 4 and len(list(tmp_path.iterdir())) == 2
    assert t_cache.clear() == 2 and not list(tmp_path.iterdir())


def test_corrupt_entry_rebuilds(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return {"a": torch.arange(3, dtype=torch.float32)}

    t_cache.cached_problem("kc_v1", build, cache_dir=tmp_path, device="cpu")
    t_cache.entry_path("kc_v1", tmp_path).write_bytes(b"not a pickle")
    out = t_cache.cached_problem("kc_v1", build, cache_dir=tmp_path, device="cpu")
    assert len(calls) == 2
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(3, dtype=np.float32))
    t_cache.cached_problem("kc_v1", lambda: 1 / 0, cache_dir=tmp_path, device="cpu")


def test_jax_and_port_caches_keep_to_their_own_entries(tmp_path):
    """One directory, one key: each package builds once and then reads only
    its own entry; each ``clear`` removes only its own; a JAX pickle put
    under the port's file name is refused (its classes are never loaded)
    and rebuilt."""
    import jax.numpy as jnp

    j_calls, t_calls = [], []

    def j_build():
        j_calls.append(1)
        return {"a": jnp.arange(3.0)}

    def t_build():
        t_calls.append(1)
        return {"a": torch.arange(3.0) + 10}

    for _ in range(2):
        j_out = j_cache.cached_problem("shared_v1", j_build, cache_dir=tmp_path)
        t_out = t_cache.cached_problem("shared_v1", t_build, cache_dir=tmp_path, device="cpu")
        assert isinstance(j_out["a"], np.ndarray) and isinstance(t_out["a"], torch.Tensor)
        np.testing.assert_array_equal(j_out["a"], [0.0, 1.0, 2.0])
        np.testing.assert_array_equal(t_out["a"].numpy(), [10.0, 11.0, 12.0])
    assert len(j_calls) == 1 and len(t_calls) == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and sum(n.endswith(".torch.pickle") for n in names) == 1

    # A JAX entry (numpy leaves, but pickled by JAX's package) in the
    # port's place: refused, dropped, rebuilt.
    (j_entry,) = tmp_path.glob("*.pkl")
    from tpu3drecon.problems.packing import CameraParams as JCameraParams

    with open(t_cache.entry_path("shared_v1", tmp_path), "wb") as f:
        pickle.dump(JCameraParams(*([np.zeros(1)] * 5)), f)
    t_out = t_cache.cached_problem("shared_v1", t_build, cache_dir=tmp_path, device="cpu")
    assert len(t_calls) == 2 and isinstance(t_out["a"], torch.Tensor)

    assert j_cache.clear(tmp_path) == 1 and j_entry.exists() is False
    assert t_cache.entry_path("shared_v1", tmp_path).exists()
    assert t_cache.clear(tmp_path) == 1 and not list(tmp_path.iterdir())


def test_wtt_problem_round_trips(tmp_path):
    """A full wtt problem (nested dataclasses, static fields, deferred
    one-hots) survives the numpy round trip bit for bit and solves to the
    same loss, as tests/test_utils.py holds JAX's."""
    from tpu3drecon_torch.problems.wtt import wtt_from_flat
    from tpu3drecon_torch.solvers.ba_wtt import make_wtt_ba_solver
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    flat = _wtt_flat()

    def build():
        return wtt_from_flat(flat, point_chunk=16, defer_onehot=True, device="cpu")

    direct = build()
    missed = t_cache.cached_problem("wtt_rt_v1", build, cache_dir=tmp_path, device="cpu")
    loaded = t_cache.cached_problem("wtt_rt_v1", lambda: 1 / 0, cache_dir=tmp_path,
                                    device="cpu")

    def assert_same(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                assert_same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                assert_same(x, y, f"{path}[{i}]")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert a == b, path

    for other in (missed, loaded):
        assert_same(np_fields(direct), np_fields(other))
    cfg = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=5,
                   matvec_kernel="index", linearize_kernel="index")
    solver = make_wtt_ba_solver(cfg)
    assert float(solver(direct)[2].loss) == float(solver(loaded)[2].loss)


@pytest.fixture
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU3DRECON_PROBLEM_CACHE_DIR", str(tmp_path))
    return tmp_path


def test_balscale_builders_go_through_the_cache(isolated_cache, monkeypatch):
    """``bal_sequential_wtt`` misses once per build parameter set, then hits
    with the same problem; its keys name every parameter."""
    from tpu3drecon_torch.benchmark import balscale

    builds = []
    real = balscale.bal_sequential_flat

    def counted(*a, **kw):
        builds.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(balscale, "bal_sequential_flat", counted)
    first = balscale.bal_sequential_wtt(points_per_camera=4, verbose=False, device="cpu")
    again = balscale.bal_sequential_wtt(points_per_camera=4, verbose=False, device="cpu")
    split = balscale.bal_sequential_wtt(points_per_camera=4, split_windows=True,
                                        verbose=False, device="cpu")
    assert len(builds) == 2
    assert len(list(isolated_cache.glob("*.torch.pickle"))) == 2
    torch.testing.assert_close(first.points3d, again.points3d, rtol=0, atol=0)
    assert len(split.buckets) != len(first.buckets) or split.window != first.window
    assert to_np(first.buckets[0].wcam).dtype == np.int16


def test_output_grabber_captures_fd_writes(capfd):
    from tpu3drecon_torch.benchmark.adapters.output_grabber import OutputGrabber

    with capfd.disabled():
        g = OutputGrabber(sys.stdout)
        with g:
            os.write(sys.stdout.fileno(), b"native-report-line\n")
        unthreaded = OutputGrabber(sys.stdout, threaded=False)
        with unthreaded:
            os.write(sys.stdout.fileno(), b"second-line\n")
    assert "native-report-line" in g.capturedtext
    assert unthreaded.capturedtext == "second-line\n"
