"""The port's reference-API surface (``tpu3drecon_torch.compat``) against
JAX's ``tpu3drecon.compat``.

Case for case as tests/test_compat.py: a scene from seed 51 (4 cameras,
120 points) perturbed with seed 52, clean observations.  At f64,
``prepare_params`` must equal JAX's to 1e-12, ``optimize`` of both classes
JAX's solutions (poses to rtol 1e-8; BA parameters to 1e-7, the solution
floating along its gauge at ~1e-8, and the converged loss, ~2.5e-12, to
1e-14), the utils functions JAX's to 1e-12 and
``get_reprojection_residuals_cpu`` JAX's exactly (both numpy).
``to_gpu`` raises without a card.
"""

import numpy as np
import pytest
import torch

from _torch_ref import to_np

from tpu3drecon import compat as j_compat
from tpu3drecon.dataset.synthetic import make_scene, perturb_scene

from tpu3drecon_torch import compat as t_compat


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_cameras=4, n_points=120, seed=51)


@pytest.fixture(scope="module")
def noisy(scene):
    return perturb_scene(
        scene, point3d_noise=2e-2, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=5.0,
        point2d_noise=0.0, seed=52,
    )


def _per_camera(scene, fill):
    """Per-camera padded arrays of the clean observations."""
    B = scene.n_cameras
    n_max = int(np.bincount(scene.cam_idx, minlength=B).max())
    out = fill(B, n_max)
    for c in range(B):
        sel = scene.cam_idx == c
        for arr, value in zip(out, (scene.points3d[scene.pt_idx[sel]], scene.uv[sel],
                                    scene.pt_idx[sel], 1.0)):
            arr[c, : int(sel.sum())] = value
    return out


def _inputs(scene, noisy):
    poses0 = np.concatenate([noisy.rmats, noisy.tvecs[:, :, None]], axis=2)
    intr0 = np.concatenate([noisy.fx_fy, scene.cx_cy_skew], axis=1)
    return poses0, intr0


def close(got, want, **kw):
    np.testing.assert_allclose(to_np(got), np.asarray(want), **{"rtol": 1e-12, "atol": 1e-12,
                                                                  **kw})


class TestUtilsCompat:
    @pytest.mark.parametrize("vec", [[0.1, -0.2, 0.3], [0.0, 0.0, 0.0], [1e-9, 2e-9, -1e-9]])
    def test_rot_mat_from_vec(self, vec):
        close(t_compat.rot_mat_from_vec(vec), j_compat.rot_mat_from_vec(vec))

    def test_pose_round_trip(self):
        from scipy.spatial.transform import Rotation

        pose = np.c_[Rotation.from_rotvec([0.2, 0.1, -0.4]).as_matrix(), [1.0, 2.0, 3.0]]
        vec = t_compat.pose_mat_to_vec(pose)
        close(vec, j_compat.pose_mat_to_vec(pose))
        close(t_compat.parse_cam_pose(vec), j_compat.parse_cam_pose(np.asarray(vec)))
        close(t_compat.parse_cam_pose(vec), pose, atol=1e-7)

    def test_parse_intrinsics(self):
        k = t_compat.parse_intrinsics([1000.0, 990.0], [320.0, 240.0, 0.5])
        close(k, j_compat.parse_intrinsics([1000.0, 990.0], [320.0, 240.0, 0.5]))
        close(k, [[1000.0, 0.5, 320.0], [0.0, 990.0, 240.0], [0.0, 0.0, 1.0]])

    def test_cpu_residual_oracle_equals_jax(self):
        from scipy.spatial.transform import Rotation

        rng = np.random.default_rng(2)
        rot = Rotation.random(random_state=np.random.RandomState(2)).as_matrix()
        pose44 = np.r_[np.c_[rot, [0.1, 0.2, 5.0]], [[0, 0, 0, 1]]]
        k = np.array([[500.0, 0, 250], [0, 500.0, 250], [0, 0, 1]])
        hom = np.c_[rng.normal(size=(10, 3)) + [0, 0, 2.0], np.ones(10)]
        obs = rng.normal(size=(10, 2)) * 3 + 250
        mask = rng.random(10) > 0.3
        got = t_compat.get_reprojection_residuals_cpu(pose44, hom, obs, k, mask)
        np.testing.assert_array_equal(
            got, j_compat.get_reprojection_residuals_cpu(pose44, hom, obs, k, mask))
        assert np.all(got[~mask] == 0)

    def test_loss_enums(self):
        assert [m.name for m in t_compat.JaxLossFunction] == \
            [m.name for m in j_compat.JaxLossFunction]
        assert t_compat.JaxLossFunction.L2.value.name == "TRIVIAL"
        x = np.array([0.0, 0.5, 3.0])
        for name in ("CAUCHY_LOSS", "TRIVIAL_LOSS"):
            np.testing.assert_array_equal(getattr(t_compat.LossFunction, name)(x),
                                          getattr(j_compat.LossFunction, name)(x))

    def test_to_gpu_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_compat.to_gpu(np.zeros(3))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_compat.JaxPoseOptimizer(avg_cam_width=500.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_compat.JaxBundleAdjustment(cam_num=2, avg_cam_width=500.0)
        out = t_compat.to_gpu([np.zeros(2), np.ones(2)], device="cpu")
        assert out.shape == (2, 2) and out.dtype == torch.float64


class TestJaxPoseOptimizerCompat:
    def test_equals_jax(self, scene, noisy):
        poses0, intr0 = _inputs(scene, noisy)
        t_opt = t_compat.JaxPoseOptimizer(avg_cam_width=scene.width, device="cpu")
        j_opt = j_compat.JaxPoseOptimizer(avg_cam_width=scene.width)
        t_params, t_ccs = t_opt.prepare_params(poses0, intr0)
        j_params, j_ccs = j_opt.prepare_params(poses0, intr0)
        assert t_params.shape == (scene.n_cameras, 8)
        close(t_params, j_params)
        close(t_ccs, j_ccs)

        pts, obs, _, mask = _per_camera(scene, lambda b, n: (
            np.zeros((b, n, 3)), np.zeros((b, n, 2)), np.zeros((b, n)), np.zeros((b, n))))
        t_out, t_state = t_opt.optimize(t_params, pts, obs, t_ccs, mask)
        j_out, j_state = j_opt.optimize(j_params, pts, obs, j_ccs, mask)
        np.testing.assert_array_equal(to_np(t_state.iter_num), to_np(j_state.iter_num))
        close(t_out, j_out, rtol=1e-8, atol=1e-10)
        # Points were held at the truth: the focals come back.
        np.testing.assert_allclose(to_np(t_out[:, 6:8]), scene.fx_fy, rtol=5e-2)


class TestJaxBundleAdjustmentCompat:
    def test_equals_jax(self, scene, noisy):
        B = scene.n_cameras
        poses0, intr0 = _inputs(scene, noisy)
        t_ba = t_compat.JaxBundleAdjustment(cam_num=B, avg_cam_width=scene.width, device="cpu")
        j_ba = j_compat.JaxBundleAdjustment(cam_num=B, avg_cam_width=scene.width)
        t_params, t_ccs = t_ba.prepare_params(poses0, intr0, noisy.points3d)
        j_params, j_ccs = j_ba.prepare_params(poses0, intr0, noisy.points3d)
        assert t_params.shape == (B * 8 + scene.n_points * 3,)
        close(t_params, j_params)
        close(t_ccs, j_ccs)

        _, p2d, pidx, mask = _per_camera(scene, lambda b, n: (
            np.zeros((b, n, 3)), np.zeros((b, n, 2)), np.zeros((b, n), np.int32),
            np.zeros((b, n))))
        t_out, t_state = t_ba.optimize(t_params, p2d, pidx, t_ccs, mask)
        j_out, j_state = j_ba.optimize(j_params, p2d, pidx, j_ccs, mask)
        assert t_out.shape == t_params.shape
        assert int(t_state.iter_num) == int(j_state.iter_num)
        assert int(t_state.accepted) == int(j_state.accepted)
        close(t_out, j_out, rtol=1e-7, atol=1e-7)
        # Both converge to the f64 floor (~2.5e-12 here).
        np.testing.assert_allclose(float(t_state.loss), float(j_state.loss), rtol=0,
                                   atol=1e-14)
        assert float(t_state.loss) < 1e-6


def test_reference_names_importable():
    for name in (
        "Dataset", "DatasetEntry", "Camera", "CameraIntrinsics", "Point2D",
        "Point3D", "ImageMetadata", "CameraPose", "CameraSet", "CoordinateSystem",
        "PoseFormat", "TransformationDirection", "load_colmap_dataset",
        "load_colmap_cameras", "export_in_colmap_format", "LossFunction",
        "JaxLossFunction", "JaxPoseOptimizer", "JaxBundleAdjustment", "to_gpu",
        "RobustLoss", "cauchy_loss", "l2_loss", "ListMultiProcessor", "OutputGrabber",
    ):
        assert hasattr(t_compat, name), name
        assert hasattr(j_compat, name), name
    assert t_compat.Dataset.__module__.startswith("tpu3drecon_torch.")
