"""The port's dataset object model, pose algebra and alignment against JAX's.

Inputs are built from seeds with numpy, and the COLMAP files are written by
the JAX package from a synthetic scene (5 cameras, 60 points, seed 41, as
tests/test_dataset_objects.py).  Pose conversions, projections, inlier
masks, alignments and the Dataset / CameraSet operations of the port must
equal JAX's at f64 (rtol 1e-12, atol 1e-12 on quantities of order 1, or
exactly where both packages run the same numpy), and the packers from a
Dataset must build JAX's problems.
"""

import dataclasses
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields, to_np

from tpu3drecon import dataset as j_ds
from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry import alignment as j_align
from tpu3drecon.geometry import pose as j_pose
from tpu3drecon.io import colmap as j_cio
from tpu3drecon.problems import from_dataset as j_from

from tpu3drecon_torch import dataset as t_ds
from tpu3drecon_torch.dataset import loader as t_loader
from tpu3drecon_torch.geometry import alignment as t_align
from tpu3drecon_torch.geometry import pose as t_pose
from tpu3drecon_torch.io import colmap as t_cio
from tpu3drecon_torch.problems import from_dataset as t_from

TOL = dict(rtol=1e-12, atol=1e-12)


def close(got, want, **kw):
    np.testing.assert_allclose(to_np(got), to_np(want), **{**TOL, **kw})


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


@pytest.fixture(scope="module")
def sparse_dir(tmp_path_factory):
    model = j_syn.scene_to_colmap_model(j_syn.make_scene(n_cameras=5, n_points=60, seed=41))
    d = tmp_path_factory.mktemp("sparse")
    j_cio.write_model(model, str(d), binary=True)
    return str(d)


@pytest.fixture(scope="module")
def datasets(sparse_dir):
    return (j_ds.load_colmap_dataset(sparse_dir, binary=True),
            t_ds.load_colmap_dataset(sparse_dir, binary=True))


# ---- geometry/pose ---------------------------------------------------------

def test_pose_functions_match_jax():
    rng = np.random.default_rng(0)
    ra, rb = _rotations(rng, 2)
    ta, tb = rng.normal(size=(2, 3))
    xyz = rng.normal(size=(7, 3))
    T = torch.from_numpy
    pairs = {
        "inverse": (t_pose.pose_inverse(T(ra), T(ta)), j_pose.pose_inverse(ra, ta)),
        "compose": (t_pose.pose_compose(T(ra), T(ta), T(rb), T(tb)),
                    j_pose.pose_compose(ra, ta, rb, tb)),
        "convert": (t_pose.pose_convert_coordinate_system(T(ra), T(ta)),
                    j_pose.pose_convert_coordinate_system(ra, ta)),
        "apply": ((t_pose.pose_apply(T(ra), T(ta), T(xyz)),),
                  (j_pose.pose_apply(ra, ta, xyz),)),
        "3x4": ((t_pose.pose_to_matrix_3x4(T(ra), T(ta)),),
                (j_pose.pose_to_matrix_3x4(ra, ta),)),
        "4x4": ((t_pose.pose_to_matrix_4x4(T(ra), T(ta)),),
                (j_pose.pose_to_matrix_4x4(ra, ta),)),
        "center": ((t_pose.camera_center(T(ra), T(ta)),), (j_pose.camera_center(ra, ta),)),
        "geodesic": ((t_pose.rotation_geodesic_angle(T(ra), T(rb)),),
                     (j_pose.rotation_geodesic_angle(ra, rb),)),
        "identity": ((t_pose.rotation_identity_error(T(ra), T(rb)),),
                     (j_pose.rotation_identity_error(ra, rb),)),
        "position": ((t_pose.position_error(T(ta), T(tb)),), (j_pose.position_error(ta, tb),)),
    }
    for name, (got, want) in pairs.items():
        for g, w in zip(got, want):
            close(g, w, err_msg=name)
    close(t_pose.CONVERSION_MATRIX, j_pose.CONVERSION_MATRIX)
    # Same and opposite rotations: the clip keeps the angle finite at 0 and pi.
    flip = np.diag([1.0, -1.0, -1.0])
    for rb_ in (ra, flip @ ra):
        close(t_pose.rotation_geodesic_angle(T(ra), T(rb_)),
              j_pose.rotation_geodesic_angle(ra, rb_), atol=1e-7)


def test_batched_pose_functions_match_jax():
    rng = np.random.default_rng(1)
    r, t = _rotations(rng, 6), rng.normal(size=(6, 3))
    T = torch.from_numpy
    for got, want in [
        (t_pose.pose_inverse_batch(T(r), T(t)), j_pose.pose_inverse_batch(r, t)),
        (t_pose.pose_convert_coordinate_system_batch(T(r), T(t)),
         j_pose.pose_convert_coordinate_system_batch(r, t)),
        ((t_pose.pose_to_matrix_3x4_batch(T(r), T(t)),), (j_pose.pose_to_matrix_3x4_batch(r, t),)),
        ((t_pose.camera_center_batch(T(r), T(t)),), (j_pose.camera_center_batch(r, t),)),
        ((t_pose.rotation_geodesic_angle_batch(T(r), T(r[::-1].copy())),),
         (j_pose.rotation_geodesic_angle_batch(r, r[::-1]),)),
    ]:
        for g, w in zip(got, want):
            close(g, w)


# ---- geometry/alignment ----------------------------------------------------

def _similar_sets(rng, n, noise=0.0):
    src = rng.normal(size=(n, 3)) * 3.0
    rot = _rotations(rng, 1)[0]
    tgt = 1.7 * src @ rot.T + np.array([2.0, -1.0, 0.5]) + rng.normal(size=(n, 3)) * noise
    return src, tgt


@pytest.mark.parametrize("method", ["umeyama_alignment", "horn_quaternion_alignment"])
@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_closed_form_alignment_matches_jax(method, with_scale, noise):
    src, tgt = _similar_sets(np.random.default_rng(2), 30, noise)
    got = getattr(t_align, method)(torch.from_numpy(src), torch.from_numpy(tgt), with_scale)
    want = getattr(j_align, method)(jnp.asarray(src), jnp.asarray(tgt), with_scale)
    for name in ("scale", "rotation", "translation"):
        close(getattr(got, name), getattr(want, name), atol=1e-10, err_msg=name)
    close(t_align.alignment_errors(got, torch.from_numpy(src), torch.from_numpy(tgt)),
          j_align.alignment_errors(want, jnp.asarray(src), jnp.asarray(tgt)), atol=1e-10)


def test_umeyama_reflection_guard_matches_jax():
    src, _ = _similar_sets(np.random.default_rng(3), 12)
    tgt = src * np.array([1.0, 1.0, -1.0])  # a reflection: the guard keeps det +1
    got = t_align.umeyama_alignment(torch.from_numpy(src), torch.from_numpy(tgt))
    want = j_align.umeyama_alignment(jnp.asarray(src), jnp.asarray(tgt))
    close(got.rotation, want.rotation, atol=1e-10)
    assert np.linalg.det(got.rotation.numpy()) > 0


@pytest.mark.parametrize("n", [20, 21], ids=["even", "odd"])
def test_robust_alignment_matches_jax(n):
    """The same subsets from one seed in both packages, and the same pick:
    with an even count the median is the midpoint of the two middle
    errors, as ``jnp.median``'s."""
    rng = np.random.default_rng(4)
    src, tgt = _similar_sets(rng, n, noise=0.01)
    tgt[:5] += rng.normal(size=(5, 3)) * 20.0  # outliers
    got = t_align.robust_alignment(src, tgt, n_trials=60, seed=11)
    want = j_align.robust_alignment(src, tgt, n_trials=60, seed=11)
    for name in ("scale", "rotation", "translation"):
        close(getattr(got, name), getattr(want, name), atol=1e-10, err_msg=name)
    resid = t_align.alignment_errors(got, torch.from_numpy(src), torch.from_numpy(tgt))
    med = float(torch.quantile(resid, 0.5, interpolation="midpoint"))
    srt = np.sort(resid.numpy())
    assert med == float(jnp.median(jnp.asarray(srt))) == (srt[(n - 1) // 2] + srt[n // 2]) / 2


# ---- CameraPose, Camera ----------------------------------------------------

def _pose_pair(seed=3):
    rng = np.random.default_rng(seed)
    r, t = _rotations(rng, 1)[0], rng.normal(size=3)
    return (j_ds.CameraPose(r, t, identifier="p"), t_ds.CameraPose(r, t, identifier="p"))


def _same_pose(got, want):
    close(got.rotation, want.rotation)
    close(got.translation, want.translation)
    assert got.coordinate_system.name == want.coordinate_system.name
    assert got.direction.name == want.direction.name
    assert got.identifier == want.identifier


def test_camera_pose_conversions_match_jax():
    jp, tp = _pose_pair()
    _same_pose(tp.inverse(), jp.inverse())
    _same_pose(tp.in_coordinate_system(t_ds.CoordinateSystem.RH),
               jp.in_coordinate_system(j_ds.CoordinateSystem.RH))
    _same_pose(tp.in_direction(t_ds.TransformationDirection.W2C),
               jp.in_direction(j_ds.TransformationDirection.W2C))
    close(tp.wxyz_quaternion, jp.wxyz_quaternion)
    close(tp.position, jp.position)
    close(tp.transformation_translation_matrix, jp.transformation_translation_matrix)
    jq, tq = _pose_pair(5)
    for fn in ("compute_position_error", "compute_rotation_error",
               "compute_rotation_error_in_rad", "compute_rotation_error_in_degrees"):
        close(getattr(t_ds.CameraPose, fn)(tp, tq), getattr(j_ds.CameraPose, fn)(jp, jq),
              err_msg=fn)
    # In place: a move of the center in either direction, a 4x4 transform.
    m4 = np.eye(4)
    m4[:3, :3] = _rotations(np.random.default_rng(6), 1)[0] * 1.01
    m4[:3, 3] = [0.5, -0.2, 1.0]
    for direction in ("C2W", "W2C"):
        jd = jp.in_direction(j_ds.TransformationDirection[direction])
        td = tp.in_direction(t_ds.TransformationDirection[direction])
        jd.apply_move(np.array([0.3, 0.1, -0.2]))
        td.apply_move(np.array([0.3, 0.1, -0.2]))
        _same_pose(td, jd)
        jd.apply_transform_4d(m4)
        td.apply_transform_4d(m4)
        _same_pose(td, jd)


@pytest.mark.parametrize("fmt", ["QT", "RT", "T"])
def test_camera_pose_strings_and_files_match_jax(tmp_path, fmt):
    jp, tp = _pose_pair()
    tp.to_file(tmp_path / "t.txt", pose_format=t_ds.PoseFormat[fmt])
    jp.to_file(tmp_path / "j.txt", pose_format=j_ds.PoseFormat[fmt])
    if fmt != "QT":  # the quaternion string may differ in the last bit
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    _same_pose(t_ds.CameraPose.from_formatted_file(tmp_path / "j.txt"),
               j_ds.CameraPose.from_formatted_file(tmp_path / "j.txt"))
    text = (tmp_path / "j.txt").read_text()
    _same_pose(t_ds.CameraPose.from_formatted_string(text, identifier="p"),
               j_ds.CameraPose.from_formatted_string(text, identifier="p"))
    with pytest.raises(t_ds.InvalidInputFormatErr):
        t_ds.CameraPose.from_string("1 2 3", pose_format=t_ds.PoseFormat[fmt])
    with pytest.raises(t_ds.InvalidInputFormatErr):
        t_ds.CameraPose.from_formatted_string("QT LH\n1 0 0 0 1 2 3")


def test_camera_projection_and_inlier_masks_match_jax(datasets):
    jd, td = datasets
    for je, te in zip(jd.datasetEntries, td.datasetEntries):
        p2d, p3d = te.map2d_3d(td.points3D_mapped, zipped=False, np=True)
        p2d = [p + np.array([0.5, -0.25]) * (i % 3) for i, p in enumerate(p2d)]
        if len(p2d) % 2:  # an even count: the median of the errors is a midpoint
            p2d, p3d = p2d[:-1], p3d[:-1]
        close(te.camera.project(td.points3D[0]), je.camera.project(jd.points3D[0]))
        close(te.camera.project(p3d[1]), je.camera.project(p3d[1]))
        for fn, args in (("compute_inlier_mask", (p2d, p3d, 0.3)),
                         ("compute_inlier_mask_mod", (p2d, p3d)),
                         ("compute_projection_errors_alt", (p2d, p3d, np.sqrt))):
            got = getattr(te.camera, fn)(*args)
            want = getattr(je.camera, fn)(*args)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=fn)
        for k, v in j_ds.Camera.difference(je.camera, jd.datasetEntries[0].camera).items():
            close(t_ds.Camera.difference(te.camera, td.datasetEntries[0].camera)[k], v,
                  err_msg=k)


# ---- loader, Dataset --------------------------------------------------------

def _same_dataset(got, want, **tol):
    assert [p.identifier for p in got.points3D] == [p.identifier for p in want.points3D]
    close([p.xyz for p in got.points3D], [p.xyz for p in want.points3D], **tol)
    assert len(got.datasetEntries) == len(want.datasetEntries)
    for g, w in zip(got.datasetEntries, want.datasetEntries):
        assert dataclasses.asdict(g.image_metadata) == dataclasses.asdict(w.image_metadata)
        assert [(p.identifier, p.point3D_identifier) for p in g.points2D] == [
            (p.identifier, p.point3D_identifier) for p in w.points2D]
        close([p.xy for p in g.points2D], [p.xy for p in w.points2D], **tol)
        _same_pose(g.camera.camera_pose, w.camera.camera_pose)
        close(g.camera.camera_intrinsics.camera_intrinsics_matrix,
              w.camera.camera_intrinsics.camera_intrinsics_matrix, **tol)


def test_load_colmap_dataset_matches_jax(datasets, sparse_dir):
    jd, td = datasets
    _same_dataset(td, jd)
    jc = j_ds.load_colmap_cameras(sparse_dir, binary=True)
    tc = t_ds.load_colmap_cameras(sparse_dir, binary=True)
    assert list(tc) == list(jc)
    for k in jc:
        _same_pose(tc[k].camera_pose, jc[k].camera_pose)
    for rec in j_cio.read_model(sparse_dir).cameras.values():
        trec = t_cio.read_model(sparse_dir).cameras[rec.camera_id]
        close(t_ds.get_intrinsics(trec).camera_intrinsics_matrix,
              j_ds.get_intrinsics(rec).camera_intrinsics_matrix)


@pytest.mark.parametrize("binary", [True, False])
def test_export_round_trip_matches_jax(datasets, tmp_path, binary):
    jd, td = datasets
    t_ds.export_in_colmap_format(td, str(tmp_path / "t"), binary=binary)
    j_ds.export_in_colmap_format(jd, str(tmp_path / "j"), binary=binary)
    back = t_ds.load_colmap_dataset(str(tmp_path / "t"), binary=binary)
    _same_dataset(back, td)
    _same_dataset(back, j_ds.load_colmap_dataset(str(tmp_path / "j"), binary=binary))
    tm, jm = t_cio.read_model(str(tmp_path / "t")), j_cio.read_model(str(tmp_path / "j"))
    close(tm.images.qvecs, jm.images.qvecs, atol=1e-15)
    for f in ("p2d_offsets", "p2d_xy", "p2d_point3d_ids"):
        np.testing.assert_array_equal(getattr(tm.images, f), getattr(jm.images, f))
    for f in dataclasses.fields(jm.points):
        np.testing.assert_array_equal(getattr(tm.points, f.name), getattr(jm.points, f.name))


def test_with_noise_and_reduction_match_jax(datasets):
    jd, td = datasets
    jn = j_ds.Dataset.with_noise(jd, rng=np.random.default_rng(5))
    tn = t_ds.Dataset.with_noise(td, rng=np.random.default_rng(5))
    _same_dataset(tn, jn, rtol=1e-12, atol=1e-9)
    for je, te in zip(jn.datasetEntries, tn.datasetEntries):
        close(te.camera.camera_intrinsics.camera_intrinsics_matrix,
              je.camera.camera_intrinsics.camera_intrinsics_matrix)
    _same_dataset(td, jd)  # the inputs are untouched
    jr, tr = jd.make_reduced_dataset(3, 20), td.make_reduced_dataset(3, 20)
    _same_dataset(tr, jr)
    assert (td.get_reduced_dataset_2d_ids_per_camera(3, 20, as_list=True)
            == jd.get_reduced_dataset_2d_ids_per_camera(3, 20, as_list=True))
    for k, v in jn.compute_reprojection_errors_alt(lambda x: x).items():
        close(tn.compute_reprojection_errors_alt(lambda x: x)[k], v, atol=1e-9)
    assert tn.avg_num_3d_points_per_image() == jn.avg_num_3d_points_per_image()


@pytest.mark.parametrize("kw", [{}, dict(min_track_len=3)])
def test_ba_problem_from_dataset_matches_jax(datasets, kw):
    jd, td = datasets
    jp, jmeta = j_from.ba_problem_from_dataset(jd, dtype=jnp.float64, **kw)
    tp, tmeta = t_from.ba_problem_from_dataset(td, dtype=torch.float64, device="cpu", **kw)
    want = np_fields(jp)
    for key in ("points3d", "cam_idx", "pt_idx", "uv", "mask", "avg_cam_width"):
        np.testing.assert_array_equal(getattr(tp, key).numpy(), want[key], err_msg=key)
    for key, w in want["cameras"].items():
        close(getattr(tp.cameras, key), w, err_msg=key)
    np.testing.assert_array_equal(tmeta.point_ids, jmeta.point_ids)
    assert tmeta.n_real_obs == jmeta.n_real_obs


def test_pose_problem_from_dataset_matches_jax(datasets):
    jd, td = datasets
    jp, jmeta = j_from.pose_problem_from_dataset(jd, dtype=jnp.float64)
    tp, tmeta = t_from.pose_problem_from_dataset(td, dtype=torch.float64, device="cpu")
    want = np_fields(jp)
    for key in ("points3d", "points2d", "mask", "avg_cam_width"):
        np.testing.assert_array_equal(getattr(tp, key).numpy(), want[key], err_msg=key)
    for key, w in want["cameras"].items():
        close(getattr(tp.cameras, key), w, err_msg=key)
    assert tmeta.n_real_obs == jmeta.n_real_obs


# ---- CameraSet ---------------------------------------------------------------

def _moved_sets(pkg, sparse_dir):
    base = pkg.CameraSet.from_sparse_folder(sparse_dir, name="a")
    rot = _rotations(np.random.default_rng(7), 1)[0]
    moved = [pkg.CameraPose(p.rotation @ rot.T, 1.7 * (rot @ p.position) + [2.0, -1.0, 0.5],
                            identifier=p.identifier, coordinate_system=p.coordinate_system,
                            direction=p.direction) for p in base.poses]
    return base, pkg.CameraSet(moved, name="b")


def test_camera_set_alignment_matches_jax(sparse_dir):
    ja, jb = _moved_sets(j_ds, sparse_dir)
    ta, tb = _moved_sets(t_ds, sparse_dir)
    close(ta.positions(), ja.positions())
    assert ta.identifiers() == ja.identifiers()
    for fn in ("compute_pose_matrix", "compute_pose_quaternion"):
        got, want = getattr(ta, fn)(tb), getattr(ja, fn)(jb)
        for name in ("scale", "rotation", "translation"):
            close(getattr(got, name), getattr(want, name), atol=1e-9, err_msg=f"{fn} {name}")
    got, want = ta.compute_robust_pose(tb, n_trials=20, seed=3), ja.compute_robust_pose(
        jb, n_trials=20, seed=3)
    close(got.rotation, want.rotation, atol=1e-9)
    errs_t, errs_j = ta.compute_set_errors(tb), ja.compute_set_errors(jb)
    assert list(errs_t) == list(errs_j)
    for k in errs_j:
        for m, v in errs_j[k].items():
            close(errs_t[k][m], v, atol=1e-8, err_msg=f"{k} {m}")


def test_camera_set_sparse_model_with_database_matches_jax(sparse_dir, tmp_path):
    """``create_sparse_model`` remapped through a small COLMAP sqlite
    database written here: the same ids, names and poses as JAX's."""
    ja = j_ds.CameraSet.from_sparse_folder(sparse_dir)
    ta = t_ds.CameraSet.from_sparse_folder(sparse_dir)
    db = tmp_path / "database.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE images (image_id INTEGER PRIMARY KEY, name TEXT)")
    for i, p in zip((17, 4, 99), [ja.poses[i] for i in (0, 2, 4)]):
        conn.execute("INSERT INTO images VALUES (?, ?)", (i, f"{p.identifier}.jpg"))
    conn.commit()
    conn.close()
    k = np.array([[1000.0, 0, 640], [0, 1000.0, 480], [0, 0, 1]])
    for db_path in (None, str(db)):
        ta.create_sparse_model(str(tmp_path / "t"), k, 1280, 960, database_path=db_path)
        ja.create_sparse_model(str(tmp_path / "j"), k, 1280, 960, database_path=db_path)
        tm, jm = t_cio.read_model(str(tmp_path / "t")), j_cio.read_model(str(tmp_path / "j"))
        np.testing.assert_array_equal(tm.images.image_ids, jm.images.image_ids)
        assert tm.images.names == jm.images.names
        close(tm.images.qvecs, jm.images.qvecs, atol=1e-15)
        close(tm.images.tvecs, jm.images.tvecs)
        assert ((tmp_path / "t" / "cameras.bin").read_bytes()
                == (tmp_path / "j" / "cameras.bin").read_bytes())
    assert sorted(tm.images.image_ids.tolist()) == [4, 17, 99]
    back = t_ds.CameraSet.from_sparse_folder(str(tmp_path / "t"))
    assert len(back) == 3


def test_colmap_gui_needs_the_binary(datasets, monkeypatch, tmp_path):
    monkeypatch.setenv("COLMAP_BIN", str(tmp_path / "no_colmap_here"))
    with pytest.raises(RuntimeError, match="colmap binary not found"):
        t_loader.show_in_colmap(str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match="colmap binary not found"):
        t_loader.open_dataset_in_colmap(datasets[1], str(tmp_path / "export"))
    assert not (tmp_path / "export").exists()
