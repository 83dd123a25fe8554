"""The port's intrinsics refinement (``solvers/intrinsics_refine.py``) against JAX.

The scenes of tests/test_intrinsics_refine.py, built once from a seed with
numpy by the JAX package (f64) and carried across with
``problems.convert``: 6 cameras with radial distortion (-0.15, 0.03), focal
lengths perturbed by up to 2 % and distortion zeroed, observed with 0.5 px
noise (a nonzero optimum); and the calibration scene (6 cameras, 300
points, distortion (-0.12, 0.02), a pinhole init).  Each solve must give
the same ``iter_num`` and ``accepted`` per camera (and ``cg_iters`` for a
BA), loss to rtol 1e-8 and parameters to rtol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import CAM_FIELDS, assert_close, assert_same_solve, np_fields, to_np

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.solvers import intrinsics_refine as j_intr
from tpu3drecon.solvers.bundle_adjust import BAConfig as JBA
from tpu3drecon.solvers.lm_core import LMConfig as JConfig

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.problems.convert import ba_problem_from_numpy, pose_problem_from_numpy
from tpu3drecon_torch.solvers import intrinsics_refine as t_intr
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TBA
from tpu3drecon_torch.solvers.lm_core import LMConfig as TConfig

LM = dict(maxiter=80, gtol=1e-10)


@pytest.fixture(scope="module")
def distorted():
    """(JAX problem, port problem, true fx_fy, true dist)."""
    scene = j_syn.make_scene(n_cameras=6, n_points=400, seed=101, dist=(-0.15, 0.03))
    observed = j_syn.perturb_scene(scene, point3d_noise=0.0, camera_rotation_noise=0.0,
                                   camera_translation_noise=0.0, camera_intrinsics_noise=0.0,
                                   point2d_noise=0.5, seed=4)
    problem, _ = j_syn.scene_to_pose_problem(scene, observed=observed, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    bad = dataclasses.replace(problem, cameras=dataclasses.replace(
        problem.cameras,
        fx_fy=problem.cameras.fx_fy * jnp.asarray(1.0 + rng.uniform(-0.02, 0.02, (6, 2))),
        dist=jnp.zeros_like(problem.cameras.dist),
    ))
    return bad, pose_problem_from_numpy(np_fields(bad), device="cpu"), scene


@pytest.mark.parametrize("refine_distortion", [True, False])
def test_refine_intrinsics_matches_jax(distorted, refine_distortion):
    jprob, tprob, scene = distorted
    jcams, jstate = j_intr.refine_intrinsics(jprob, config=JConfig(**LM),
                                             refine_distortion=refine_distortion)
    cams, state = t_intr.refine_intrinsics(tprob, config=TConfig(**LM),
                                           refine_distortion=refine_distortion, device="cpu")
    np.testing.assert_array_equal(to_np(state.iter_num), np.asarray(jstate.iter_num))
    np.testing.assert_array_equal(to_np(state.accepted), np.asarray(jstate.accepted))
    np.testing.assert_allclose(to_np(state.loss), np.asarray(jstate.loss), rtol=1e-8)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(to_np(getattr(cams, name)), np.asarray(getattr(jcams, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    if refine_distortion:
        # Recovered to the noise: focal and k1 near the truth (k2 is weakly
        # determined under 0.5 px noise).
        np.testing.assert_allclose(to_np(cams.fx_fy), scene.fx_fy, rtol=1e-3)
        np.testing.assert_allclose(to_np(cams.dist[:, 0]), scene.dist[:, 0], atol=3e-2)
    else:
        assert torch.equal(cams.dist, tprob.cameras.dist)  # frozen: exactly the input
        assert int(to_np(state.accepted).min()) > 0


@pytest.mark.parametrize("loss", ["TRIVIAL", "CAUCHY"])
def test_focal_only_jacobian_has_zero_k_columns(distorted, loss):
    """refine_distortion=False: ``.detach()`` of (k1, k2) under jacfwd gives
    zero k columns (JAX's ``stop_gradient``); the focal columns, and every
    column of the full residual, equal jax.jacfwd's."""
    jprob, tprob, _ = distorted
    c = 2
    p0 = np.concatenate([np.asarray(jprob.cameras.fx_fy[c]), [-0.1, 0.02]])
    jargs = (jprob.cameras.rmats[c], jprob.cameras.tvecs[c], jprob.cameras.cx_cy_skew[c],
             jprob.points3d[c], jprob.points2d[c], jprob.mask[c], jprob.avg_cam_width)
    targs = (tprob.cameras.rmats[c], tprob.cameras.tvecs[c], tprob.cameras.cx_cy_skew[c],
             tprob.points3d[c], tprob.points2d[c], tprob.mask[c], tprob.avg_cam_width)
    want = jax.jacfwd(lambda p: j_intr.intrinsics_residuals(p, *jargs, loss=JLoss[loss]))(
        jnp.asarray(p0))
    full = torch.func.jacfwd(
        lambda p: t_intr.intrinsics_residuals(p, *targs, loss=TLoss[loss]))(torch.tensor(p0))
    frozen = torch.func.jacfwd(
        lambda p: t_intr._focal_only(p, *targs, loss=TLoss[loss]))(torch.tensor(p0))
    assert_close(full, want, 1e-10, atol_rel=1e-12)
    assert_close(frozen[:, :2], np.asarray(want)[:, :2], 1e-10, atol_rel=1e-12)
    assert torch.count_nonzero(frozen[:, 2:]) == 0


def test_pose_problem_from_ba_matches_jax():
    scene = j_syn.make_scene(n_cameras=5, n_points=200, obs_per_camera=90, seed=12)
    jflat, _ = j_syn.scene_to_ba_problem(j_syn.perturb_scene(scene, seed=13), observed=scene,
                                         dtype=jnp.float64)
    tflat = ba_problem_from_numpy(np_fields(jflat), device="cpu")
    pts = np.asarray(jflat.points3d) * 1.01
    want = np_fields(j_intr.pose_problem_from_ba(jflat, points3d=jnp.asarray(pts)))
    got = t_intr.pose_problem_from_ba(tflat, points3d=torch.tensor(pts))
    for name in ("points3d", "points2d", "mask", "avg_cam_width"):
        np.testing.assert_array_equal(to_np(getattr(got, name)), want[name], err_msg=name)
        assert getattr(got, name).dtype == torch.float64
    for name in CAM_FIELDS:
        np.testing.assert_array_equal(to_np(getattr(got.cameras, name)),
                                      want["cameras"][name], err_msg=name)


def test_ba_with_intrinsics_calibration_matches_jax():
    """Two rounds of the alternation (flat BA, then intrinsics) and the last
    BA, with bounded iterations (5 LM / 8 CG per BA, 10 per intrinsics
    solve) so every accept test stays above float64 rounding."""
    scene = j_syn.make_scene(n_cameras=6, n_points=300, seed=201, dist=(-0.12, 0.02))
    noisy = j_syn.perturb_scene(scene, seed=202, point2d_noise=0.0, camera_intrinsics_noise=5.0)
    jflat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    jflat = dataclasses.replace(jflat, cameras=dataclasses.replace(
        jflat.cameras, dist=jnp.zeros_like(jflat.cameras.dist)))
    tflat = ba_problem_from_numpy(np_fields(jflat), device="cpu")
    ba = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
    lm = dict(maxiter=10, gtol=1e-9)
    ref = j_intr.ba_with_intrinsics_calibration(jflat, JBA(**ba), JConfig(**lm), rounds=2)
    port = t_intr.ba_with_intrinsics_calibration(tflat, TBA(**ba), TConfig(**lm), rounds=2,
                                                 device="cpu")
    assert_same_solve(port, ref, 5)
    # The distortion moved off the pinhole init toward the truth.
    assert np.all(to_np(port[0].dist[:, 0]) < -0.01)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA default")
def test_entry_points_default_to_the_card(distorted):
    _, tprob, _ = distorted
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_intr.refine_intrinsics(tprob)
