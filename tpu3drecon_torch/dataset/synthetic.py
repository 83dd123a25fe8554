"""Synthetic scenes with known ground truth.

Counterpart of ``tpu3drecon/dataset/synthetic.py``.  Every scene is
drawn from numpy RNGs with the same draws in the same order as the JAX
package, so both packages build identical arrays from a seed; only
``scene_to_ba_problem`` and ``scene_to_pose_problem`` produce tensors.
``scene_to_colmap_model`` exports a scene as COLMAP records (float64 on
the host).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.rotations import matrix_to_quat_batch
from tpu3drecon_torch.io.colmap.records import (
    CameraModelType,
    ColmapCamera,
    ColmapImages,
    ColmapModel,
    ColmapPoints,
)
from tpu3drecon_torch.problems.packing import (
    BAProblem,
    CameraParams,
    PoseProblem,
    ProblemMeta,
    bucket_size,
)


@dataclass(frozen=True)
class SyntheticScene:
    """Host-side ground-truth scene."""

    rmats: np.ndarray  # (C, 3, 3) W2C
    tvecs: np.ndarray  # (C, 3) W2C
    fx_fy: np.ndarray  # (C, 2)
    cx_cy_skew: np.ndarray  # (C, 3)
    width: int
    height: int
    points3d: np.ndarray  # (P, 3)
    # Flat observation list (exact projections of points3d).
    cam_idx: np.ndarray  # (N,) int32
    pt_idx: np.ndarray  # (N,) int32
    uv: np.ndarray  # (N, 2)
    dist: Optional[np.ndarray] = None  # (C, 2) radial (k1, k2); None = pinhole

    @property
    def dist_or_zeros(self) -> np.ndarray:
        return self.dist if self.dist is not None else np.zeros((self.n_cameras, 2))

    @property
    def n_cameras(self) -> int:
        return len(self.rmats)

    @property
    def n_points(self) -> int:
        return len(self.points3d)


def _look_at_w2c(center: np.ndarray, target: np.ndarray, up: np.ndarray):
    """W2C extrinsics for a camera at ``center`` looking at ``target``."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_c2w = np.stack([right, down, fwd], axis=1)  # columns = camera axes
    rmat = r_c2w.T
    tvec = -rmat @ center
    return rmat, tvec


def _project_inside(points, pt_rows, rmat, tvec, f, ccs, dist_row, w, h):
    """Exact projections of ``points[pt_rows]`` into one camera; returns the
    rows and uv of the observations in front of it and inside the image."""
    xyz_cam = points[pt_rows] @ rmat.T + tvec
    in_front = xyz_cam[:, 2] > 0.1
    pt_rows, xyz_cam = pt_rows[in_front], xyz_cam[in_front]
    xy = xyz_cam[:, :2] / xyz_cam[:, 2:3]
    r2 = np.sum(xy * xy, axis=1, keepdims=True)
    xy = (1.0 + dist_row[0] * r2 + dist_row[1] * r2 * r2) * xy
    u = f[0] * xy[:, 0] + ccs[2] * xy[:, 1] + ccs[0]
    v = f[1] * xy[:, 1] + ccs[1]
    uv = np.stack([u, v], axis=1)
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return pt_rows[inside].astype(np.int32), uv[inside]


def _random_intrinsics(rng, focal, w, h):
    f = focal * rng.uniform(0.95, 1.05)
    fx_fy = (f, f * rng.uniform(0.99, 1.01))
    ccs = (w / 2 + rng.normal(scale=2), h / 2 + rng.normal(scale=2), 0.0)
    return fx_fy, ccs


def make_scene(
    n_cameras: int = 8,
    n_points: int = 500,
    obs_per_camera: Optional[int] = None,
    image_size: Tuple[int, int] = (1280, 960),
    focal: float = 1100.0,
    ring_radius: float = 10.0,
    cloud_radius: float = 2.0,
    seed: int = 0,
    dist: Tuple[float, float] = (0.0, 0.0),
) -> SyntheticScene:
    """Cameras on a ring around a Gaussian point cloud, exact projections."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    points = rng.normal(scale=cloud_radius / 2.0, size=(n_points, 3))
    dist_rows = np.tile(np.asarray(dist, np.float64), (n_cameras, 1))

    rmats = np.zeros((n_cameras, 3, 3))
    tvecs = np.zeros((n_cameras, 3))
    fx_fy = np.zeros((n_cameras, 2))
    cx_cy_skew = np.zeros((n_cameras, 3))
    for c in range(n_cameras):
        angle = 2.0 * np.pi * c / n_cameras
        elev = 0.2 * np.sin(3.0 * angle)
        center = ring_radius * np.array(
            [np.cos(angle), elev, np.sin(angle)]
        ) + rng.normal(scale=0.1, size=3)
        rmats[c], tvecs[c] = _look_at_w2c(
            center, np.zeros(3) + rng.normal(scale=0.05, size=3), np.array([0.0, 1.0, 0.0])
        )
        fx_fy[c], cx_cy_skew[c] = _random_intrinsics(rng, focal, w, h)

    cam_chunks, pt_chunks, uv_chunks = [], [], []
    for c in range(n_cameras):
        if obs_per_camera is None or obs_per_camera >= n_points:
            pt_rows = np.arange(n_points)
        elif n_points >= 500_000:
            # Same large-scene sampling as the JAX package (with
            # replacement + dedup), so draws stay identical.
            pt_rows = np.unique(rng.integers(0, n_points, size=obs_per_camera))
        else:
            pt_rows = rng.choice(n_points, size=obs_per_camera, replace=False)
        rows, uv = _project_inside(
            points, pt_rows, rmats[c], tvecs[c], fx_fy[c], cx_cy_skew[c],
            dist_rows[c], w, h,
        )
        cam_chunks.append(np.full(len(rows), c, np.int32))
        pt_chunks.append(rows)
        uv_chunks.append(uv)

    return SyntheticScene(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, cx_cy_skew=cx_cy_skew,
        width=w, height=h, points3d=points,
        cam_idx=np.concatenate(cam_chunks),
        pt_idx=np.concatenate(pt_chunks),
        uv=np.concatenate(uv_chunks),
        dist=dist_rows,
    )


def make_sequential_scene(
    n_cameras: int = 160,
    points_per_camera: int = 30,
    track_span: int = 4,
    image_size: Tuple[int, int] = (1280, 960),
    focal: float = 1100.0,
    spacing: float = 0.5,
    seed: int = 0,
    dist: Tuple[float, float] = (0.0, 0.0),
) -> SyntheticScene:
    """Sequential-capture scene: cameras along a line, camera-LOCAL tracks
    (point block ``p`` is observed by cameras ``[h, h + track_span)`` with
    ``h = p // points_per_camera``)."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    n_points = n_cameras * points_per_camera
    dist_rows = np.tile(np.asarray(dist, np.float64), (n_cameras, 1))

    rmats = np.zeros((n_cameras, 3, 3))
    tvecs = np.zeros((n_cameras, 3))
    fx_fy = np.zeros((n_cameras, 2))
    cx_cy_skew = np.zeros((n_cameras, 3))
    for c in range(n_cameras):
        center = np.array([spacing * c, 0.0, 0.0]) + rng.normal(scale=0.02, size=3)
        target = np.array([spacing * c + 0.3, 0.0, 6.0]) + rng.normal(
            scale=0.05, size=3
        )
        rmats[c], tvecs[c] = _look_at_w2c(center, target, np.array([0.0, 1.0, 0.0]))
        fx_fy[c], cx_cy_skew[c] = _random_intrinsics(rng, focal, w, h)

    home = np.repeat(np.arange(n_cameras), points_per_camera)
    points = np.stack(
        [
            spacing * home + rng.normal(scale=1.0, size=n_points),
            rng.normal(scale=1.0, size=n_points),
            6.0 + rng.normal(scale=1.0, size=n_points),
        ],
        axis=1,
    )

    cam_chunks, pt_chunks, uv_chunks = [], [], []
    for c in range(n_cameras):
        lo = max(0, (c - track_span + 1)) * points_per_camera
        hi = min(n_cameras, c + 1) * points_per_camera
        pt_rows = np.arange(lo, hi)
        pt_rows = pt_rows[home[pt_rows] + track_span > c]
        rows, uv = _project_inside(
            points, pt_rows, rmats[c], tvecs[c], fx_fy[c], cx_cy_skew[c],
            dist_rows[c], w, h,
        )
        cam_chunks.append(np.full(len(rows), c, np.int32))
        pt_chunks.append(rows)
        uv_chunks.append(uv)

    return SyntheticScene(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, cx_cy_skew=cx_cy_skew,
        width=w, height=h, points3d=points,
        cam_idx=np.concatenate(cam_chunks),
        pt_idx=np.concatenate(pt_chunks),
        uv=np.concatenate(uv_chunks),
        dist=dist_rows,
    )


def make_hub_scene(
    n_cameras: int = 160,
    points_per_camera: int = 30,
    track_span: int = 4,
    hub_fraction: float = 0.05,
    hub_obs: int = 2000,
    image_size: Tuple[int, int] = (1280, 960),
    focal: float = 1100.0,
    spacing: float = 0.5,
    seed: int = 0,
) -> SyntheticScene:
    """Core-periphery (photo-tourism) scene: a sequential backbone of local
    cameras (``make_sequential_scene``) plus ``hub_fraction`` overview hub
    cameras, far behind the scene line, that each observe ``hub_obs``
    random points scene-wide.  Camera ids come out interleaved by a seeded
    permutation, so the packer must find the hub/global split itself
    (``problems.reorder.plan_hub_camera_order``).  Projections are exact."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    n_hubs = max(1, int(round(n_cameras * hub_fraction)))
    n_locals = n_cameras - n_hubs
    base = make_sequential_scene(
        n_cameras=n_locals, points_per_camera=points_per_camera, track_span=track_span,
        image_size=image_size, focal=focal, spacing=spacing, seed=seed, dist=(0.0, 0.0),
    )
    n_points = base.n_points

    # Hubs: far behind (z << 0), looking at the middle of the scene line; the
    # distance scales with the scene's extent, so the frustum covers it.
    extent = spacing * n_locals
    hub_r = np.zeros((n_hubs, 3, 3))
    hub_t = np.zeros((n_hubs, 3))
    hub_f = np.zeros((n_hubs, 2))
    hub_c = np.zeros((n_hubs, 3))
    hub_cam, hub_pt, hub_uv = [], [], []
    for j in range(n_hubs):
        center = np.array([extent * (j + 0.5) / n_hubs, -0.3 * extent, -1.2 * extent])
        target = np.array([extent / 2, 0.0, 6.0]) + rng.normal(scale=0.1, size=3)
        hub_r[j], hub_t[j] = _look_at_w2c(center, target, np.array([0.0, 1.0, 0.0]))
        hub_f[j], hub_c[j] = _random_intrinsics(rng, focal, w, h)
        rows, uv = _project_inside(
            base.points3d, np.unique(rng.integers(0, n_points, size=hub_obs)), hub_r[j],
            hub_t[j], hub_f[j], hub_c[j], np.zeros(2), w, h,
        )
        hub_cam.append(np.full(len(rows), n_locals + j, np.int32))
        hub_pt.append(rows)
        hub_uv.append(uv)

    # Interleave the hub ids among the local ids (photo-tourism labelling).
    perm = rng.permutation(n_cameras)  # perm[packed] = emitted id
    inv = np.empty(n_cameras, np.int64)
    inv[perm] = np.arange(n_cameras)
    cam_idx = inv[np.concatenate([base.cam_idx] + hub_cam).astype(np.int64)]
    return SyntheticScene(
        rmats=np.concatenate([base.rmats, hub_r])[perm],
        tvecs=np.concatenate([base.tvecs, hub_t])[perm],
        fx_fy=np.concatenate([base.fx_fy, hub_f])[perm],
        cx_cy_skew=np.concatenate([base.cx_cy_skew, hub_c])[perm],
        width=w, height=h, points3d=base.points3d,
        cam_idx=cam_idx.astype(np.int32),
        pt_idx=np.concatenate([base.pt_idx] + hub_pt),
        uv=np.concatenate([base.uv] + hub_uv),
        dist=np.zeros((n_cameras, 2)),
    )


def perturb_scene(
    scene: SyntheticScene,
    point3d_noise: float = 3e-2,
    camera_rotation_noise: float = 5e-2,
    camera_translation_noise: float = 5e-2,
    camera_intrinsics_noise: float = 10.0,
    point2d_noise: float = 1.0,
    seed: int = 1,
) -> SyntheticScene:
    """Unit-direction noise of fixed magnitude on points, poses, intrinsics
    and observations."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)

    def unit_rows(n, d):
        v = rng.normal(size=(n, d))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    points = scene.points3d + unit_rows(scene.n_points, 3) * point3d_noise
    dr = Rotation.from_rotvec(unit_rows(scene.n_cameras, 3) * camera_rotation_noise)
    rmats = np.einsum("cij,cjk->cik", dr.as_matrix(), scene.rmats)
    tvecs = (
        np.einsum("cij,cj->ci", dr.as_matrix(), scene.tvecs)
        + unit_rows(scene.n_cameras, 3) * camera_translation_noise
    )
    fx_fy = scene.fx_fy + rng.uniform(0, camera_intrinsics_noise, size=scene.fx_fy.shape)
    uv = scene.uv + unit_rows(len(scene.uv), 2) * point2d_noise
    return replace(
        scene, points3d=points, rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, uv=uv
    )


def scene_to_ba_problem(
    scene: SyntheticScene,
    observed: Optional[SyntheticScene] = None,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 1024,
    device=None,
) -> Tuple[BAProblem, ProblemMeta]:
    """Packed BA problem on ``device`` (default: the CUDA card, see
    ``tpu3drecon_torch.device``): parameters from ``scene`` (typically
    the perturbed initialization), observations from ``observed``
    (typically the clean ground truth)."""
    device = resolve_device(device)
    obs = observed if observed is not None else scene
    n_obs = len(obs.uv)
    n_pad = bucket_size(max(n_obs, 1), pad_multiple)
    pad = n_pad - n_obs

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    problem = BAProblem(
        cameras=CameraParams(
            rmats=t(scene.rmats),
            tvecs=t(scene.tvecs),
            fx_fy=t(scene.fx_fy),
            cx_cy_skew=t(scene.cx_cy_skew),
            dist=t(scene.dist_or_zeros),
        ),
        points3d=t(scene.points3d),
        cam_idx=t(np.concatenate([obs.cam_idx, np.zeros(pad, np.int32)]), torch.int32),
        pt_idx=t(np.concatenate([obs.pt_idx, np.zeros(pad, np.int32)]), torch.int32),
        uv=t(np.concatenate([obs.uv, np.zeros((pad, 2))])),
        mask=t(np.concatenate([np.ones(n_obs), np.zeros(pad)])),
        avg_cam_width=t(float(scene.width)),
    )
    meta = ProblemMeta(
        camera_ids=np.arange(1, scene.n_cameras + 1),
        point_ids=np.arange(1, scene.n_points + 1),
        widths=np.full(scene.n_cameras, scene.width),
        n_real_obs=n_obs,
    )
    return problem, meta


def scene_to_pose_problem(
    scene: SyntheticScene,
    observed: Optional[SyntheticScene] = None,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 256,
    device=None,
) -> Tuple[PoseProblem, ProblemMeta]:
    """Per-camera PnP problems on ``device`` (default: the CUDA card): 3D
    points fixed at ``scene`` values, observations from ``observed``
    (clean), initial poses from ``scene``."""
    device = resolve_device(device)
    obs = observed if observed is not None else scene
    counts = np.bincount(obs.cam_idx, minlength=scene.n_cameras)
    max_n = bucket_size(int(counts.max()), pad_multiple)
    B = scene.n_cameras
    pts3 = np.zeros((B, max_n, 3))
    pts2 = np.zeros((B, max_n, 2))
    mask = np.zeros((B, max_n))
    # Each camera's observations in their list order (a stable sort by
    # camera), as the JAX package's per-camera boolean selection.
    order = np.argsort(obs.cam_idx, kind="stable")
    cams = obs.cam_idx[order]
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    local = np.arange(len(order)) - starts[cams]
    pts3[cams, local] = scene.points3d[obs.pt_idx[order]]
    pts2[cams, local] = obs.uv[order]
    mask[cams, local] = 1.0

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    problem = PoseProblem(
        cameras=CameraParams(
            rmats=t(scene.rmats),
            tvecs=t(scene.tvecs),
            fx_fy=t(scene.fx_fy),
            cx_cy_skew=t(scene.cx_cy_skew),
            dist=t(scene.dist_or_zeros),
        ),
        points3d=t(pts3),
        points2d=t(pts2),
        mask=t(mask),
        avg_cam_width=t(float(scene.width)),
    )
    meta = ProblemMeta(
        camera_ids=np.arange(1, B + 1),
        point_ids=np.zeros(0, np.int64),
        widths=np.full(B, scene.width),
        n_real_obs=int(counts.sum()),
    )
    return problem, meta


def scene_to_colmap_model(scene: SyntheticScene) -> ColmapModel:
    """A synthetic scene as a COLMAP model of PINHOLE cameras (image and
    camera ids 1..C, point ids 1..P); quaternions in float64 on the
    CPU."""
    cameras = {
        c + 1: ColmapCamera(
            camera_id=c + 1,
            model=CameraModelType.PINHOLE,
            width=scene.width,
            height=scene.height,
            params=np.array(
                [
                    scene.fx_fy[c, 0],
                    scene.fx_fy[c, 1],
                    scene.cx_cy_skew[c, 0],
                    scene.cx_cy_skew[c, 1],
                ]
            ),
        )
        for c in range(scene.n_cameras)
    }

    qvecs = matrix_to_quat_batch(
        torch.as_tensor(np.asarray(scene.rmats, np.float64))).numpy()

    order = np.argsort(scene.cam_idx, kind="stable")
    cam_sorted = scene.cam_idx[order]
    pt_sorted = scene.pt_idx[order]
    uv_sorted = scene.uv[order]
    counts = np.bincount(cam_sorted, minlength=scene.n_cameras)
    offsets = np.zeros(scene.n_cameras + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    images = ColmapImages(
        image_ids=np.arange(1, scene.n_cameras + 1, dtype=np.int32),
        qvecs=qvecs,
        tvecs=scene.tvecs.astype(np.float64),
        camera_ids=np.arange(1, scene.n_cameras + 1, dtype=np.int32),
        names=[f"synthetic_{c:04d}.jpg" for c in range(scene.n_cameras)],
        p2d_offsets=offsets,
        p2d_xy=uv_sorted.astype(np.float64),
        p2d_point3d_ids=(pt_sorted + 1).astype(np.int64),
    )

    # Tracks: for each point, the (image_id, p2d_idx) pairs that observe it.
    local_idx = np.arange(len(cam_sorted), dtype=np.int64) - offsets[cam_sorted]
    porder = np.argsort(pt_sorted, kind="stable")
    p_of = pt_sorted[porder]
    img_of = cam_sorted[porder] + 1
    loc_of = local_idx[porder]
    pcounts = np.bincount(p_of, minlength=scene.n_points)
    poffsets = np.zeros(scene.n_points + 1, np.int64)
    np.cumsum(pcounts, out=poffsets[1:])

    points = ColmapPoints(
        ids=np.arange(1, scene.n_points + 1, dtype=np.int64),
        xyz=scene.points3d.astype(np.float64),
        rgb=np.full((scene.n_points, 3), 128, np.uint8),
        error=np.zeros(scene.n_points),
        track_offsets=poffsets,
        track_image_ids=img_of.astype(np.int32),
        track_p2d_idxs=loc_of.astype(np.int32),
    )
    return ColmapModel(cameras=cameras, images=images, points=points)
