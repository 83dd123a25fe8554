"""The dense-LM solvers' configurations: the JAX suite's PnP-parity and
tracking cells and the intrinsics tests' scenes.

Counterpart of ``tpu3drecon/benchmark/suite.py:66-180`` (config #1,
``run_pnp_parity``) and ``:258-285`` (config #4, ``run_tracking``): the
same scenes, perturbations and LM configurations, and the PnP cell's
in-run parity oracle, scipy's ``least_squares`` on the identical masked
width-normalized residual, solved per camera on the host.  Then the
scenes of ``tests/test_intrinsics_refine.py``: its focal/distortion
recovery on the tracking cell's 500 frames, and its calibration scene.
Every problem is built on the CUDA card unless ``device`` says otherwise.
``chip_smoke.py`` and ``benchmark/profile_solve.py`` drive them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu3drecon_torch.solvers.lm_core import LMConfig

# xtol stops once steps collapse (suite.py:96-103).
PNP_CONFIG = LMConfig(maxiter=100, gtol=1e-10, ftol=1e-10, xtol=1e-8)
TRACKING_CONFIG = LMConfig(maxiter=50, gtol=1e-12)


def pnp_problem(device=None, dtype: torch.dtype = torch.float32, n_cameras: int = 8,
                n_points: int = 2300, seed: int = 5):
    """Config #1: ``n_cameras`` PnP problems of ``n_points`` matches each.
    Returns (PoseProblem, the perturbed scene the solve starts from)."""
    from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene, scene_to_pose_problem

    scene = make_scene(n_cameras=n_cameras, n_points=n_points, obs_per_camera=n_points,
                       seed=seed)
    noisy = perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=5.0,
        point2d_noise=0.0, seed=seed + 1,
    )
    problem, _ = scene_to_pose_problem(noisy, observed=scene, dtype=dtype, device=device)
    return problem, noisy


def pnp_scipy_oracle(problem, noisy):
    """scipy ``least_squares`` (LM) per camera on the same residual as the
    port's per-axis TRIVIAL form, from the same start.  Returns (rotation
    vectors, tvecs, fx_fy, host seconds)."""
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    p3 = problem.points3d.double().cpu().numpy()
    p2 = problem.points2d.double().cpu().numpy()
    mask = problem.mask.cpu().numpy()
    width = float(problem.avg_cam_width)
    n = p3.shape[0]
    sol_r, sol_t, sol_f = np.zeros((n, 3)), np.zeros((n, 3)), np.zeros((n, 2))
    t0 = time.perf_counter()
    for c in range(n):
        m = mask[c] > 0
        xyz, uv = p3[c][m], p2[c][m]
        cx, cy, skew = np.asarray(noisy.cx_cy_skew[c])
        x0 = np.concatenate([Rotation.from_matrix(noisy.rmats[c]).as_rotvec(),
                             noisy.tvecs[c], noisy.fx_fy[c]])

        def residuals(p, xyz=xyz, uv=uv, cx=cx, cy=cy, skew=skew):
            rot = Rotation.from_rotvec(p[:3]).as_matrix()
            xc = xyz @ rot.T + p[3:6]
            xn = xc[:, :2] / xc[:, 2:3]
            proj = np.stack([p[6] * xn[:, 0] + skew * xn[:, 1] + cx, p[7] * xn[:, 1] + cy],
                            axis=1)
            return ((proj - uv) / width).ravel()

        sol = least_squares(residuals, x0, method="lm", xtol=1e-15, ftol=1e-15)
        sol_r[c], sol_t[c], sol_f[c] = sol.x[:3], sol.x[3:6], sol.x[6:8]
    return sol_r, sol_t, sol_f, time.perf_counter() - t0


def pnp_parity(cameras, oracle) -> dict:
    """Max geodesic rotation error (rad, from the skew part of R^T R_scipy,
    as suite.py:163-171), max |tvec| and max |focal| error against the
    oracle's solution."""
    from scipy.spatial.transform import Rotation

    sol_r, sol_t, sol_f, _ = oracle
    ours_r = cameras.rmats.double().cpu().numpy()
    rel = np.einsum("cji,cjk->cik", ours_r, Rotation.from_rotvec(sol_r).as_matrix())
    skew = 0.5 * (rel - np.transpose(rel, (0, 2, 1)))
    s = np.sqrt(skew[:, 0, 1] ** 2 + skew[:, 0, 2] ** 2 + skew[:, 1, 2] ** 2)
    return dict(
        max_rot_geodesic_err_rad=float(np.max(np.arcsin(np.clip(s, 0.0, 1.0)))),
        max_tvec_err=float(np.max(np.abs(cameras.tvecs.double().cpu().numpy() - sol_t))),
        max_focal_err=float(np.max(np.abs(cameras.fx_fy.double().cpu().numpy() - sol_f))),
    )


def tracking_problem(device=None, dtype: torch.dtype = torch.float32, n_frames: int = 500,
                     n_obs: int = 1000, seed: int = 81):
    """Config #4: ``n_frames`` frames of ``n_obs`` observations each (padded
    to ``bucket_size(n_obs, 256)``).  Returns (PoseProblem, the clean
    scene)."""
    from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene, scene_to_pose_problem

    scene = make_scene(n_cameras=n_frames, n_points=n_obs, obs_per_camera=n_obs, seed=seed)
    noisy = perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=0.0,
        point2d_noise=0.0, seed=seed + 1,
    )
    problem, _ = scene_to_pose_problem(noisy, observed=scene, dtype=dtype, device=device)
    return problem, scene


INTRINSICS_CONFIG = LMConfig(maxiter=80, gtol=1e-14)
INTRINSICS_DIST = (-0.15, 0.03)


def intrinsics_problem(device=None, dtype: torch.dtype = torch.float64, n_frames: int = 500,
                       n_obs: int = 1000, seed: int = 81):
    """The tracking cell's scene with radial distortion ``INTRINSICS_DIST``
    and clean observations, its focal lengths perturbed by up to 2 % and its
    distortion zeroed (tests/test_intrinsics_refine.py:14-33 at 6 cameras).
    Returns (PoseProblem, the scene with the true intrinsics)."""
    import dataclasses

    from tpu3drecon_torch.dataset.synthetic import make_scene, scene_to_pose_problem

    scene = make_scene(n_cameras=n_frames, n_points=n_obs, obs_per_camera=n_obs, seed=seed,
                       dist=INTRINSICS_DIST)
    problem, _ = scene_to_pose_problem(scene, dtype=dtype, device=device)
    rng = np.random.default_rng(3)
    scale = torch.as_tensor(1.0 + rng.uniform(-0.02, 0.02, (n_frames, 2)), dtype=dtype,
                            device=problem.mask.device)
    cams = dataclasses.replace(problem.cameras, fx_fy=problem.cameras.fx_fy * scale,
                               dist=torch.zeros_like(problem.cameras.dist))
    return dataclasses.replace(problem, cameras=cams), scene


CALIB_DIST = (-0.12, 0.02)


def calib_problem(device=None, dtype: torch.dtype = torch.float64):
    """The calibration scene of tests/test_intrinsics_refine.py:60-74: 6
    cameras, 300 points, distortion ``CALIB_DIST``, perturbed geometry and
    focal, clean observations, and an init that claims pinhole."""
    import dataclasses

    from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem

    scene = make_scene(n_cameras=6, n_points=300, seed=201, dist=CALIB_DIST)
    noisy = perturb_scene(scene, seed=202, point2d_noise=0.0, camera_intrinsics_noise=5.0)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=dtype, device=device)
    cams = dataclasses.replace(problem.cameras, dist=torch.zeros_like(problem.cameras.dist))
    return dataclasses.replace(problem, cameras=cams)
