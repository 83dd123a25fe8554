"""The port's COLMAP codecs, native reader and packers against JAX's.

A synthetic scene (12 cameras, 400 points, seed 71, numpy) exported as a
COLMAP model by both packages; the port's model is carried across from
JAX's records with ``problems.convert.colmap_model_from_numpy``.  Writers
must write JAX's bytes (binary and text), the port's native and numpy
readers must return each other's and JAX's records exactly, truncated
files must raise in both readers, and the packers must build JAX's
problems (f64, ``device="cpu"``).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.io import colmap as j_cio
from tpu3drecon.problems import packing as j_pack

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.io import colmap as t_cio
from tpu3drecon_torch.io.colmap import binary as t_bin
from tpu3drecon_torch.io.colmap import native
from tpu3drecon_torch.problems import packing as t_pack
from tpu3drecon_torch.problems.convert import camera_params_from_numpy, colmap_model_from_numpy

FILES = ("cameras", "images", "points3D")


def colmap_fields(model) -> dict:
    """A JAX ``ColmapModel`` as the input of ``colmap_model_from_numpy``."""
    return dict(
        cameras={cid: dict(camera_id=c.camera_id, model=int(c.model), width=c.width,
                           height=c.height, params=np.asarray(c.params))
                 for cid, c in model.cameras.items()},
        images={f.name: getattr(model.images, f.name)
                for f in dataclasses.fields(model.images)},
        points={f.name: getattr(model.points, f.name)
                for f in dataclasses.fields(model.points)},
    )


def assert_same_model(got, want):
    assert list(got.cameras) == list(want.cameras)
    for cid, c in want.cameras.items():
        g = got.cameras[cid]
        assert (g.camera_id, int(g.model), g.width, g.height) == (
            c.camera_id, int(c.model), c.width, c.height)
        np.testing.assert_array_equal(g.params, c.params)
    for group in ("images", "points"):
        for f in dataclasses.fields(getattr(want, group)):
            w = getattr(getattr(want, group), f.name)
            g = getattr(getattr(got, group), f.name)
            if isinstance(w, list):
                assert g == w, f.name
            else:
                assert g.dtype == w.dtype and g.shape == w.shape, f.name
                np.testing.assert_array_equal(g, w, err_msg=f"{group}.{f.name}")


def _model_with_unobserved(model):
    """The model with every 7th keypoint made a point-less observation (-1)
    and one keypoint pointing at a missing point id."""
    ids = model.images.p2d_point3d_ids.copy()
    ids[::7] = -1
    ids[3] = 10**9
    return dataclasses.replace(model, images=dataclasses.replace(model.images,
                                                                 p2d_point3d_ids=ids))


@pytest.fixture(scope="module")
def models():
    scene = j_syn.make_scene(n_cameras=12, n_points=400, obs_per_camera=120, seed=71)
    jm = _model_with_unobserved(j_syn.scene_to_colmap_model(scene))
    return jm, colmap_model_from_numpy(colmap_fields(jm))


@pytest.fixture(scope="module")
def written(models, tmp_path_factory):
    jm, _ = models
    out = {}
    for binary in (True, False):
        d = tmp_path_factory.mktemp("bin" if binary else "txt")
        j_cio.write_model(jm, str(d), binary=binary)
        out[binary] = str(d)
    return out


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_writers_write_jax_bytes(models, tmp_path, binary):
    jm, tm = models
    j_cio.write_model(jm, str(tmp_path / "j"), binary=binary)
    t_cio.write_model(tm, str(tmp_path / "t"), binary=binary)
    ext = ".bin" if binary else ".txt"
    for name in FILES:
        assert ((tmp_path / "t" / f"{name}{ext}").read_bytes()
                == (tmp_path / "j" / f"{name}{ext}").read_bytes()), name


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_read_model_matches_jax(models, written, binary):
    jm, _ = models
    got = t_cio.read_model(written[binary])  # auto-detects the format
    assert_same_model(got, j_cio.read_model(written[binary], binary=binary))
    assert_same_model(got, colmap_model_from_numpy(colmap_fields(jm)))


def test_native_and_numpy_readers_agree(written):
    d = written[True]
    native.COUNTS.reset()
    ni = t_bin.read_images_bin(f"{d}/images.bin")
    npts = t_bin.read_points3d_bin(f"{d}/points3D.bin")
    assert native.COUNTS.native == {"images": 1, "points3d": 1} and native.COUNTS.numpy == {}
    pi = t_bin.read_images_bin(f"{d}/images.bin", use_native=False)
    ppts = t_bin.read_points3d_bin(f"{d}/points3D.bin", use_native=False)
    assert native.COUNTS.numpy == {"images": 1, "points3d": 1}
    ji = j_cio.read_images_bin(f"{d}/images.bin", use_native=False)
    jpts = j_cio.read_points3d_bin(f"{d}/points3D.bin", use_native=False)
    for got in (ni, pi):
        assert_same_model(
            dataclasses.replace(t_cio.read_model(d), images=got),
            dataclasses.replace(j_cio.read_model(d), images=ji))
    for got in (npts, ppts):
        assert_same_model(
            dataclasses.replace(t_cio.read_model(d), points=got),
            dataclasses.replace(j_cio.read_model(d), points=jpts))


def test_no_native_env_uses_numpy(written, monkeypatch):
    monkeypatch.setenv("TPU3DRECON_NO_NATIVE", "1")
    native.COUNTS.reset()
    t_cio.read_model(written[True])
    assert native.COUNTS.native == {} and native.COUNTS.numpy == {"images": 1, "points3d": 1}


@pytest.mark.parametrize("name", ["images", "points3D"])
def test_truncated_files_raise_in_both_readers(written, tmp_path, name):
    data = open(f"{written[True]}/{name}.bin", "rb").read()
    reader = t_bin.read_images_bin if name == "images" else t_bin.read_points3d_bin
    cuts = sorted(random.Random(0).sample(range(9, len(data) - 1), 10)) + [4]
    for cut in cuts:
        bad = tmp_path / f"{name}.bin"
        bad.write_bytes(data[:cut])
        for use_native in (True, False):
            with pytest.raises(Exception):
                reader(str(bad), use_native=use_native)


def test_native_builds_from_the_ports_source(tmp_path, monkeypatch):
    """The library compiles from ``tpu3drecon_torch/native/colmap_io.cpp``
    into the build directory, under a name keyed by the source."""
    assert native.SOURCE.parts[-3:] == ("tpu3drecon_torch", "native", "colmap_io.cpp")
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("tpu3drecon_torch", "_build")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build()
    assert path.parent == tmp_path and path.name.startswith("libcolmap_io_")
    assert [p.name for p in tmp_path.iterdir()] == [path.name]  # no temporary left
    assert native.build() == path  # cached


def test_scene_to_colmap_model_matches_jax():
    kw = dict(n_cameras=6, n_points=200, obs_per_camera=80, seed=5)
    jm = j_syn.scene_to_colmap_model(j_syn.make_scene(**kw))
    tm = t_syn.scene_to_colmap_model(t_syn.make_scene(**kw))
    np.testing.assert_allclose(tm.images.qvecs, jm.images.qvecs, rtol=0, atol=1e-15)
    tm.images.qvecs = jm.images.qvecs
    assert_same_model(tm, jm)


@pytest.mark.parametrize("kw", [{}, dict(camera_limit=7, points_per_camera_limit=50),
                                dict(min_track_len=3)])
def test_ba_problem_from_colmap_matches_jax(models, kw):
    jm, tm = models
    jp, jmeta = j_pack.ba_problem_from_colmap(jm, dtype=jnp.float64, **kw)
    tp, tmeta = t_pack.ba_problem_from_colmap(tm, dtype=torch.float64, device="cpu", **kw)
    want = np_fields(jp)
    for key in ("points3d", "cam_idx", "pt_idx", "uv", "mask", "avg_cam_width"):
        np.testing.assert_array_equal(getattr(tp, key).numpy(), want[key], err_msg=key)
    for key, w in want["cameras"].items():
        np.testing.assert_allclose(getattr(tp.cameras, key).numpy(), w, rtol=1e-14,
                                   atol=1e-15, err_msg=key)
    for key in ("camera_ids", "point_ids", "widths"):
        np.testing.assert_array_equal(getattr(tmeta, key), getattr(jmeta, key), err_msg=key)
    assert tmeta.n_real_obs == jmeta.n_real_obs


@pytest.mark.parametrize("camera_limit", [None, 5])
def test_pose_problem_from_colmap_matches_jax(models, camera_limit):
    jm, tm = models
    jp, jmeta = j_pack.pose_problem_from_colmap(jm, camera_limit=camera_limit,
                                                dtype=jnp.float64)
    tp, tmeta = t_pack.pose_problem_from_colmap(tm, camera_limit=camera_limit,
                                                dtype=torch.float64, device="cpu")
    want = np_fields(jp)
    for key in ("points3d", "points2d", "mask", "avg_cam_width"):
        np.testing.assert_array_equal(getattr(tp, key).numpy(), want[key], err_msg=key)
    for key, w in want["cameras"].items():
        np.testing.assert_allclose(getattr(tp.cameras, key).numpy(), w, rtol=1e-14,
                                   atol=1e-15, err_msg=key)
    np.testing.assert_array_equal(tmeta.camera_ids, jmeta.camera_ids)
    assert tmeta.n_real_obs == jmeta.n_real_obs


def test_colmap_model_with_solution_matches_jax(models, tmp_path):
    """A moved solution of the first 10 images written back by both
    packages: the same records, and the port's binary write of them reads
    back unchanged."""
    jm, tm = models
    jp, jmeta = j_pack.ba_problem_from_colmap(jm, dtype=jnp.float64, camera_limit=10)
    _, tmeta = t_pack.ba_problem_from_colmap(tm, dtype=torch.float64, device="cpu",
                                             camera_limit=10)
    rng = np.random.default_rng(9)
    cams = np_fields(jp.cameras)
    ang = rng.normal(scale=0.05, size=3)
    rot = np.array([[1.0, -ang[2], ang[1]], [ang[2], 1.0, -ang[0]], [-ang[1], ang[0], 1.0]])
    u, _, vt = np.linalg.svd(rot)
    cams["rmats"] = (u @ vt) @ cams["rmats"]
    cams["tvecs"] = cams["tvecs"] + rng.normal(scale=0.01, size=cams["tvecs"].shape)
    cams["fx_fy"] = cams["fx_fy"] + rng.uniform(size=cams["fx_fy"].shape)
    pts = np.asarray(jp.points3d) + rng.normal(scale=0.01, size=jp.points3d.shape)
    jc = dataclasses.replace(jp.cameras, **{k: jnp.asarray(v) for k, v in cams.items()})
    want = j_pack.colmap_model_with_solution(jm, jc, jnp.asarray(pts), jmeta)
    got = t_pack.colmap_model_with_solution(
        tm, camera_params_from_numpy(cams, "cpu"), torch.from_numpy(pts), tmeta)
    np.testing.assert_allclose(got.images.qvecs, want.images.qvecs, rtol=0, atol=1e-15)
    got.images.qvecs = want.images.qvecs
    assert_same_model(got, want)
    assert tm.images.tvecs is not got.images.tvecs  # the input is untouched
    np.testing.assert_array_equal(tm.points.xyz, jm.points.xyz)
    t_cio.write_model(got, str(tmp_path), binary=True)
    assert_same_model(t_cio.read_model(str(tmp_path)), got)


def test_solve_colmap_path_matches_jax(tmp_path):
    """The CLI's ``solve-colmap`` path in both packages on one model written
    by JAX: ``read_model`` -> ``ba_problem_from_colmap`` -> ``grid_from_flat``
    -> ``ba_solve_grid`` (4 LM iterations, 0.5 px noise) ->
    ``colmap_model_with_solution`` -> ``write_model``.  The written models
    agree to rtol 1e-7 in poses, focals and points, exactly elsewhere."""
    from tpu3drecon.problems.grid import grid_from_flat as j_grid_from_flat
    from tpu3drecon.solvers.ba_grid import ba_solve_grid as j_solve
    from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

    from tpu3drecon_torch.problems.grid import grid_from_flat as t_grid_from_flat
    from tpu3drecon_torch.solvers.ba_grid import ba_solve_grid as t_solve
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

    scene = j_syn.make_scene(n_cameras=8, n_points=300, seed=7)
    noisy = j_syn.perturb_scene(scene, seed=8, point2d_noise=0.5)
    j_cio.write_model(j_syn.scene_to_colmap_model(noisy), str(tmp_path / "in"))
    kw = dict(maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)

    jm = j_cio.read_model(str(tmp_path / "in"))
    jp, jmeta = j_pack.ba_problem_from_colmap(jm, dtype=jnp.float64)
    jcams, jpts, jstate = j_solve(j_grid_from_flat(jp), JConfig(**kw))
    j_cio.write_model(j_pack.colmap_model_with_solution(jm, jcams, jpts, jmeta),
                      str(tmp_path / "j"))
    tm = t_cio.read_model(str(tmp_path / "in"))
    tp, tmeta = t_pack.ba_problem_from_colmap(tm, dtype=torch.float64, device="cpu")
    tcams, tpts, tstate = t_solve(t_grid_from_flat(tp), TConfig(**kw))
    t_cio.write_model(t_pack.colmap_model_with_solution(tm, tcams, tpts, tmeta),
                      str(tmp_path / "t"))

    assert (tstate.iter_num, int(tstate.accepted)) == (4, int(jstate.accepted))
    got, want = t_cio.read_model(str(tmp_path / "t")), j_cio.read_model(str(tmp_path / "j"))
    for cid, c in want.cameras.items():
        np.testing.assert_allclose(got.cameras[cid].params, c.params, rtol=1e-7)
    for group, field in (("images", "qvecs"), ("images", "tvecs"), ("points", "xyz")):
        np.testing.assert_allclose(getattr(getattr(got, group), field),
                                   getattr(getattr(want, group), field), rtol=1e-7, atol=1e-9)
        setattr(getattr(got, group), field, getattr(getattr(want, group), field))
    got.cameras = want.cameras
    assert_same_model(got, want)
