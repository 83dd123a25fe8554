"""Input files of the file-to-solve-to-file paths (``chip_smoke.py`` phase 12).

``write_ladybug49_like`` writes a BAL problem with the published shape of
Ladybug problem-49 (49 cameras, 7,776 points, about 31,800 observations;
Agarwal et al., "Bundle Adjustment in the Large") in BAL's own camera
model: p = -P / P.z, r(p) = 1 + k1 |p|^2 + k2 |p|^4, cameras along a
vehicle arc looking sideways, 0.5 px observation noise and a "-pre"-style
perturbed initial geometry.  It is the port's copy of the generator of
``examples/bal_pipeline.py``: the same draws in the same order from
``np.random.default_rng(seed)``, so both packages write the same file from
a seed.
"""

from __future__ import annotations

import numpy as np

from tpu3drecon_torch.io.bal import write_bal

LADYBUG49 = dict(n_cams=49, n_pts=7776, target_obs=31843)


def _rodrigues(rv: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(rv)
    if th < 1e-12:
        return np.eye(3)
    k = rv / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def write_ladybug49_like(path: str, seed: int = 49) -> dict:
    """Write the BAL file to ``path``; returns its camera, point and
    observation counts."""
    rng = np.random.default_rng(seed)
    n_cams, n_pts, target_obs = (LADYBUG49[k] for k in ("n_cams", "n_pts", "target_obs"))

    # Cameras along a gentle arc looking sideways-down, points along the
    # corridor at street depth.
    s = np.linspace(0.0, 30.0, n_cams)
    cam_pos = np.stack([s, 0.1 * np.sin(s * 0.3), 0.02 * s], axis=1)
    points = np.stack(
        [
            rng.uniform(-3.0, 33.0, n_pts),
            rng.uniform(-4.0, 4.0, n_pts),
            rng.uniform(3.0, 14.0, n_pts),
        ],
        axis=1,
    )

    # BAL cameras look down -z: base orientation diag(1, -1, -1) with a
    # small jitter per camera, t = -R C.
    base = np.diag([1.0, -1.0, -1.0])
    rvecs = np.zeros((n_cams, 3))
    tvecs = np.zeros((n_cams, 3))
    rots = np.zeros((n_cams, 3, 3))
    for c in range(n_cams):
        R = _rodrigues(rng.normal(scale=0.03, size=3)) @ base
        rots[c] = R
        tvecs[c] = -R @ cam_pos[c]
        ang = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        n = np.linalg.norm(axis)
        rvecs[c] = (ang / n) * axis if n > 1e-12 else np.zeros(3)

    f = 700.0 + rng.uniform(-20, 20, n_cams)
    k1 = np.full(n_cams, -0.33) + rng.normal(scale=0.01, size=n_cams)
    k2 = np.full(n_cams, 0.11) + rng.normal(scale=0.005, size=n_cams)

    # Each camera sees its nearest points along the corridor.
    per_cam = target_obs // n_cams
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        P = points @ rots[c].T + tvecs[c]
        visible = np.nonzero(P[:, 2] < -1.0)[0]
        d = np.abs(points[visible, 0] - cam_pos[c, 0])
        take = visible[np.argsort(d)[:per_cam]]
        Pc = P[take]
        p = -Pc[:, :2] / Pc[:, 2:3]
        r2 = np.sum(p * p, axis=1, keepdims=True)
        uv = f[c] * (1 + k1[c] * r2 + k2[c] * r2 * r2) * p
        inside = np.all(np.abs(uv) < 500, axis=1)
        cam_idx.append(np.full(inside.sum(), c, np.int32))
        pt_idx.append(take[inside].astype(np.int32))
        uvs.append(uv[inside] + rng.normal(scale=0.5, size=(inside.sum(), 2)))
    cam_idx = np.concatenate(cam_idx)
    pt_idx = np.concatenate(pt_idx)
    uvs = np.concatenate(uvs)

    # "-pre"-style perturbed initial geometry (what the solver starts from).
    rvecs_n = rvecs + rng.normal(scale=2e-3, size=rvecs.shape)
    tvecs_n = tvecs + rng.normal(scale=1e-2, size=tvecs.shape)
    points_n = points + rng.normal(scale=2e-2, size=points.shape)
    cam_params = np.concatenate(
        [rvecs_n, tvecs_n, f[:, None], k1[:, None], k2[:, None]], axis=1
    )
    write_bal(path, cam_idx, pt_idx, uvs, cam_params, points_n)
    return dict(cameras=n_cams, points=n_pts, observations=int(len(cam_idx)),
                observed_points=int(len(np.unique(pt_idx))))
