"""The port's BAL reader, writer and packer (``io/bal.py``) against JAX's.

BAL files are written here from a seed with numpy, their observations
made by BAL's own camera model (P = R X + t, p = -P/P.z, pixel = f r(p) p,
as in tests/test_bal.py).  The port's readers (the C++ tokenizer and
Python's ``split``) must return JAX's arrays exactly, plain and ``.bz2``;
``ba_problem_from_bal`` must build JAX's problem exactly (host float64
conversions, tensors last), ``write_bal`` / ``export_bal`` must write JAX's
bytes, and corrupt files must raise JAX's exception types.
"""

import bz2
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields, to_np

from tpu3drecon.io import bal as j_bal

from tpu3drecon_torch.io import bal as t_bal
from tpu3drecon_torch.io.colmap import native
from tpu3drecon_torch.problems.convert import camera_params_from_numpy
from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse


def _rodrigues(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _bal_scene(seed=77, n_cams=6, n_pts=150, k1k2=(0.0, 0.0), rot=0.05):
    """BAL cameras looking down -z at a cloud, observations by BAL's
    published projection."""
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(n_pts, 3)) * np.array([2.0, 2.0, 0.8]) + np.array([0, 0, -6.0])
    rvecs = rng.normal(size=(n_cams, 3)) * rot
    tvecs = rng.normal(size=(n_cams, 3)) * 0.2
    f = 500.0 + rng.uniform(size=n_cams) * 100.0
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = []
    for c in range(n_cams):
        P = points @ _rodrigues(rvecs[c]).T + tvecs[c]
        p = -P[:, :2] / P[:, 2:3]
        r2 = np.sum(p * p, axis=1, keepdims=True)
        uv.append(f[c] * (1.0 + k1k2[0] * r2 + k1k2[1] * r2 * r2) * p)
    cam_params = np.concatenate(
        [rvecs, tvecs, f[:, None], np.full((n_cams, 1), k1k2[0]),
         np.full((n_cams, 1), k1k2[1])], axis=1)
    return cam_idx, pt_idx, np.concatenate(uv), cam_params, points


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bal")
    out = {}
    for name, kw in {"pinhole": {}, "radial": dict(seed=88, k1k2=(-0.12, 0.02))}.items():
        path = d / f"{name}.txt"
        t_bal.write_bal(str(path), *_bal_scene(**kw))
        out[name] = str(path)
    bz = d / "radial.txt.bz2"
    bz.write_bytes(bz2.compress(open(out["radial"], "rb").read()))
    out["bz2"] = str(bz)
    return out


@pytest.mark.parametrize("kw", [{}, dict(seed=88, k1k2=(-0.12, 0.02), rot=3.0)])
def test_write_bal_same_bytes(tmp_path, kw):
    arrays = _bal_scene(**kw)
    t_bal.write_bal(str(tmp_path / "t.txt"), *arrays)
    j_bal.write_bal(str(tmp_path / "j.txt"), *arrays)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("name", ["pinhole", "radial", "bz2"])
@pytest.mark.parametrize("use_native", [True, False])
def test_read_bal_matches_jax(files, name, use_native):
    native.COUNTS.reset()
    got = t_bal.read_bal(files[name], use_native=use_native)
    assert native.COUNTS.native.get("bal", 0) == int(use_native)
    assert native.COUNTS.numpy.get("bal", 0) == int(not use_native)
    for jax_native in (True, False):
        want = j_bal.read_bal(files[name], use_native=jax_native)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["pinhole", "radial"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_problem_from_bal_matches_jax(files, name, dtype):
    jp, jmeta = j_bal.ba_problem_from_bal(files[name], dtype=getattr(jnp, dtype))
    tp, tmeta = t_bal.ba_problem_from_bal(files[name], dtype=getattr(torch, dtype),
                                          device="cpu")
    want = np_fields(jp)
    for key in ("points3d", "cam_idx", "pt_idx", "uv", "mask", "avg_cam_width"):
        got = getattr(tp, key).numpy()
        assert got.dtype == want[key].dtype, key
        np.testing.assert_array_equal(got, want[key], err_msg=key)
    for key, w in want["cameras"].items():
        np.testing.assert_array_equal(getattr(tp.cameras, key).numpy(), w, err_msg=key)
    for key in ("camera_ids", "point_ids", "widths", "distortion"):
        np.testing.assert_array_equal(getattr(tmeta, key), getattr(jmeta, key), err_msg=key)
    assert tmeta.n_real_obs == jmeta.n_real_obs


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_export_bal_same_bytes(files, tmp_path, dtype):
    """The loaded problem and a moved solution (rotations past pi/2 taken
    through the quaternion branch) export to JAX's bytes."""
    jp, _ = j_bal.ba_problem_from_bal(files["radial"], dtype=getattr(jnp, dtype))
    tp, _ = t_bal.ba_problem_from_bal(files["radial"], dtype=getattr(torch, dtype),
                                      device="cpu")
    t_bal.export_bal(str(tmp_path / "t.txt"), tp)
    j_bal.export_bal(str(tmp_path / "j.txt"), jp)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()

    rng = np.random.default_rng(4)
    cams = np_fields(jp.cameras)
    flip = np.array([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])  # pi about z
    cams["rmats"] = (flip @ cams["rmats"]).astype(cams["rmats"].dtype)
    cams["fx_fy"] = cams["fx_fy"] + rng.uniform(size=cams["fx_fy"].shape).astype(
        cams["fx_fy"].dtype)
    pts = np.asarray(jp.points3d) + rng.normal(size=jp.points3d.shape).astype(
        np.asarray(jp.points3d).dtype)
    jc = dataclasses.replace(jp.cameras, **{k: jnp.asarray(v) for k, v in cams.items()})
    t_bal.export_bal(str(tmp_path / "t2.txt"), tp, camera_params_from_numpy(cams, "cpu"),
                     torch.from_numpy(pts))
    j_bal.export_bal(str(tmp_path / "j2.txt"), jp, jc, jnp.asarray(pts))
    assert (tmp_path / "t2.txt").read_bytes() == (tmp_path / "j2.txt").read_bytes()


def test_export_round_trip(files, tmp_path):
    tp, _ = t_bal.ba_problem_from_bal(files["radial"], dtype=torch.float64, device="cpu")
    t_bal.export_bal(str(tmp_path / "out.txt"), tp)
    back, _ = t_bal.ba_problem_from_bal(str(tmp_path / "out.txt"), dtype=torch.float64,
                                        device="cpu")
    for key in ("rmats", "tvecs", "fx_fy", "dist"):
        np.testing.assert_allclose(getattr(back.cameras, key).numpy(),
                                   getattr(tp.cameras, key).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=key)
    np.testing.assert_array_equal(back.uv.numpy(), tp.uv.numpy())


@pytest.mark.parametrize("name", ["pinhole", "radial"])
def test_loader_matches_bal_model(files, name):
    """At ground truth the loaded problem's residuals vanish: the
    conjugation and the v flip match BAL's published model."""
    tp, _ = t_bal.ba_problem_from_bal(files[name], dtype=torch.float64, device="cpu")
    rmse = float(reprojection_rmse(tp, tp.cameras, tp.points3d))
    assert rmse < 1e-9, rmse
    if name == "radial":
        np.testing.assert_allclose(to_np(tp.cameras.dist[0]), [-0.12, 0.02])


CORRUPT = {
    "empty": b"",
    "short_header": b"3 2\n",
    "bad_header": b"3 x 1\n0 0 1.0 2.0\n",
    "truncated": b"3 2 1\n0 0 1.0",
    "bad_token": b"1 1 1\n0 0 1.0 abc\n" + b"0.0\n" * 12,
}


@pytest.mark.parametrize("case", list(CORRUPT))
@pytest.mark.parametrize("use_native", [True, False])
def test_corrupt_files_raise_as_jax(tmp_path, case, use_native):
    path = tmp_path / "bad.txt"
    path.write_bytes(CORRUPT[case])
    with pytest.raises(Exception) as want:
        j_bal.read_bal(str(path), use_native=use_native)
    with pytest.raises(type(want.value)) as got:
        t_bal.read_bal(str(path), use_native=use_native)
    assert ("corrupt BAL file" in str(got.value)) == ("corrupt BAL file" in str(want.value))


def test_problem_from_bal_defaults_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bal.ba_problem_from_bal(files["pinhole"])


def test_ladybug49_generator_writes_the_examples_file(tmp_path):
    """``benchmark/file_cells.write_ladybug49_like`` is a copy of the
    generator of examples/bal_pipeline.py: the same file from seed 49."""
    import importlib.util
    from pathlib import Path

    from tpu3drecon_torch.benchmark.file_cells import write_ladybug49_like

    src = Path(__file__).resolve().parent.parent / "examples" / "bal_pipeline.py"
    spec = importlib.util.spec_from_file_location("bal_pipeline_example", src)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.make_ladybug49_like(str(tmp_path / "j.txt"), seed=49)
    info = write_ladybug49_like(str(tmp_path / "t.txt"), seed=49)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert (info["cameras"], info["points"]) == (49, 7776)
    assert info["observations"] == len(t_bal.read_bal(str(tmp_path / "t.txt"))[0])


def test_solve_bal_path_matches_jax(tmp_path):
    """The CLI's ``solve-bal`` path in both packages: ``ba_problem_from_bal``
    -> ``grid_from_flat`` -> ``ba_solve_grid`` (4 LM iterations, 0.5 px
    noise) -> ``export_bal``; the exported files agree to rtol 1e-7 (the
    solve's parameter tolerance) and exactly in their observations."""
    from tpu3drecon.problems.grid import grid_from_flat as j_grid_from_flat
    from tpu3drecon.solvers.ba_grid import ba_solve_grid as j_solve
    from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

    from tpu3drecon_torch.problems.grid import grid_from_flat as t_grid_from_flat
    from tpu3drecon_torch.solvers.ba_grid import ba_solve_grid as t_solve
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

    rng = np.random.default_rng(12)
    cam_idx, pt_idx, uv, cam_params, points = _bal_scene(seed=88, k1k2=(-0.12, 0.02))
    cam_params[:, :6] += rng.normal(scale=[2e-3] * 3 + [1e-2] * 3, size=(len(cam_params), 6))
    path = str(tmp_path / "in.txt")
    t_bal.write_bal(path, cam_idx, pt_idx, uv + rng.normal(scale=0.5, size=uv.shape),
                    cam_params, points + rng.normal(scale=0.02, size=points.shape))
    kw = dict(maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4, optimize_focal=False)

    jp, _ = j_bal.ba_problem_from_bal(path, dtype=jnp.float64)
    jcams, jpts, jstate = j_solve(j_grid_from_flat(jp), JConfig(**kw))
    j_bal.export_bal(str(tmp_path / "j.txt"), jp, jcams, jpts)
    tp, _ = t_bal.ba_problem_from_bal(path, dtype=torch.float64, device="cpu")
    tcams, tpts, tstate = t_solve(t_grid_from_flat(tp), TConfig(**kw))
    t_bal.export_bal(str(tmp_path / "t.txt"), tp, tcams, tpts)

    assert (tstate.iter_num, int(tstate.accepted)) == (4, int(jstate.accepted))
    got, want = t_bal.read_bal(str(tmp_path / "t.txt")), j_bal.read_bal(str(tmp_path / "j.txt"))
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-9)
    assert float(reprojection_rmse(tp, tcams, tpts)) < float(
        reprojection_rmse(tp, tp.cameras, tp.points3d))
