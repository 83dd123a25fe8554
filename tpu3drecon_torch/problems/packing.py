"""Packed, static-shape problem containers and the COLMAP packers.

Counterpart of ``tpu3drecon/problems/packing.py``: the camera parameter
block, the batched single-camera pose problem and the flat-observation
(BAL) bundle-adjustment problem, as dataclasses of tensors
(``.to(device)`` moves every tensor); the vectorized packers from a COLMAP
model (``pose_problem_from_colmap``, ``ba_problem_from_colmap``), which
build their tensors on ``device`` (default: the CUDA card), and the
write-back of a solution into a new model (``colmap_model_with_solution``,
poses converted in host float64).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.rotations import matrix_to_quat_batch, quat_to_matrix_batch
from tpu3drecon_torch.io.colmap.records import CameraModelType, ColmapModel


def bucket_size(n: int, multiple: int = 256) -> int:
    """Round n up to a shape bucket (>= 1 multiple)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _to(obj, device):
    """Copy of a dataclass with every tensor field moved to ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = v.to(device)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            changes[f.name] = tuple(b.to(device) for b in v)
    return dataclasses.replace(obj, **changes)


@dataclass(frozen=True)
class CameraParams:
    """Packed per-camera parameters (W2C extrinsics + intrinsics).

    ``dist = (k1, k2)`` is the polynomial radial distortion on normalized
    coordinates; cx/cy/skew and dist are frozen under optimization unless
    the solver config says otherwise.
    """

    rmats: torch.Tensor  # (B, 3, 3)
    tvecs: torch.Tensor  # (B, 3)
    fx_fy: torch.Tensor  # (B, 2)
    cx_cy_skew: torch.Tensor  # (B, 3)
    dist: torch.Tensor  # (B, 2)

    @property
    def n_cameras(self) -> int:
        return self.rmats.shape[0]

    def to(self, device) -> "CameraParams":
        return _to(self, device)


def zero_distortion(n: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """(n, 2) zero radial-distortion rows for pinhole cameras."""
    return torch.zeros((n, 2), dtype=dtype, device=device)


@dataclass(frozen=True)
class PoseProblem:
    """B independent single-camera pose-refinement problems, padded to a
    common (bucketed) point count with 0/1 masks."""

    cameras: CameraParams
    points3d: torch.Tensor  # (B, N, 3) fixed 3D points per camera
    points2d: torch.Tensor  # (B, N, 2) observations
    mask: torch.Tensor  # (B, N) 1.0 = real observation
    avg_cam_width: torch.Tensor  # () residual normalizer

    @property
    def batch(self) -> int:
        return self.points3d.shape[0]

    @property
    def max_points(self) -> int:
        return self.points3d.shape[1]

    def to(self, device) -> "PoseProblem":
        return _to(self, device)


@dataclass(frozen=True)
class BAProblem:
    """One bundle-adjustment problem in flat-observation (BAL) layout."""

    cameras: CameraParams
    points3d: torch.Tensor  # (P, 3)
    cam_idx: torch.Tensor  # (N_obs,) int32 row into cameras
    pt_idx: torch.Tensor  # (N_obs,) int32 row into points3d
    uv: torch.Tensor  # (N_obs, 2) observations
    mask: torch.Tensor  # (N_obs,) 1.0 = real observation
    avg_cam_width: torch.Tensor  # ()

    @property
    def n_cameras(self) -> int:
        return self.cameras.rmats.shape[0]

    @property
    def n_points(self) -> int:
        return self.points3d.shape[0]

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]

    def to(self, device) -> "BAProblem":
        return _to(self, device)


@dataclass(frozen=True)
class ProblemMeta:
    """Host-side bookkeeping for mapping solver rows back to model ids."""

    camera_ids: np.ndarray
    point_ids: np.ndarray
    widths: np.ndarray
    n_real_obs: int = 0
    distortion: Optional[np.ndarray] = None


def _camera_arrays_from_model(
    model: ColmapModel, image_rows: np.ndarray, dtype, device
) -> Tuple[CameraParams, np.ndarray, np.ndarray]:
    """Packed camera params (+ widths, ids) of the given image rows."""
    qvecs = np.asarray(model.images.qvecs)[image_rows]
    tvecs = np.asarray(model.images.tvecs)[image_rows]
    intr = np.zeros((len(image_rows), 5))
    dist = np.zeros((len(image_rows), 2))
    widths = np.zeros(len(image_rows))
    for k, row in enumerate(image_rows):
        cam = model.cameras[int(model.images.camera_ids[row])]
        intr[k] = cam.intrinsics_tuple()
        # SIMPLE_RADIAL's k maps to (k, 0); RADIAL gives (k1, k2): the
        # polynomial on normalized coordinates the solver applies.
        d = cam.distortion_params()
        dist[k, : min(2, len(d))] = d[:2]
        widths[k] = cam.width

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    cameras = CameraParams(
        rmats=quat_to_matrix_batch(t(qvecs)),
        tvecs=t(tvecs),
        fx_fy=t(intr[:, :2]),
        cx_cy_skew=t(intr[:, 2:]),
        dist=t(dist),
    )
    return cameras, widths, np.asarray(model.images.image_ids)[image_rows]


def _searchsorted_hits(
    sorted_ids: np.ndarray, ids: np.ndarray, pos: np.ndarray
) -> np.ndarray:
    """Mask of ids actually present in sorted_ids (pos = searchsorted
    result): searchsorted alone maps a missing id to a neighboring row."""
    if len(sorted_ids) == 0:
        return np.zeros(len(ids), dtype=bool)
    return (pos < len(sorted_ids)) & (
        sorted_ids[np.minimum(pos, len(sorted_ids) - 1)] == ids
    )


def pose_problem_from_colmap(
    model: ColmapModel,
    camera_limit: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 256,
    device=None,
) -> Tuple[PoseProblem, ProblemMeta]:
    """Per-image PnP problems of a COLMAP model on ``device`` (default: the
    CUDA card); observations of point ids absent from the model's points
    are dropped."""
    device = resolve_device(device)
    n_images = len(model.images)
    rows = np.arange(n_images if camera_limit is None else min(camera_limit, n_images))

    cameras, widths, image_ids = _camera_arrays_from_model(model, rows, dtype, device)

    sorted_pids = np.asarray(model.points.ids)
    order = np.argsort(sorted_pids)
    sorted_ids = sorted_pids[order]
    xyz_sorted = np.asarray(model.points.xyz)[order]

    per_cam_xy = []
    per_cam_xyz = []
    for row in rows:
        xy, p3d_ids = model.images.points2d_of(int(row))
        sel = p3d_ids >= 0
        xy = xy[sel]
        pid = p3d_ids[sel]
        pos = np.searchsorted(sorted_ids, pid)
        matched = _searchsorted_hits(sorted_ids, pid, pos)
        per_cam_xy.append(xy[matched])
        per_cam_xyz.append(xyz_sorted[pos[matched]])

    max_n = bucket_size(max((len(x) for x in per_cam_xy), default=1), pad_multiple)
    B = len(rows)
    pts3 = np.zeros((B, max_n, 3))
    pts2 = np.zeros((B, max_n, 2))
    mask = np.zeros((B, max_n))
    for k in range(B):
        n = len(per_cam_xy[k])
        pts2[k, :n] = per_cam_xy[k]
        pts3[k, :n] = per_cam_xyz[k]
        mask[k, :n] = 1.0

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    problem = PoseProblem(
        cameras=cameras,
        points3d=t(pts3),
        points2d=t(pts2),
        mask=t(mask),
        avg_cam_width=t(float(np.mean(widths))),
    )
    meta = ProblemMeta(
        camera_ids=image_ids,
        point_ids=np.zeros(0, np.int64),
        widths=widths,
        n_real_obs=int(sum(len(x) for x in per_cam_xy)),
    )
    return problem, meta


def ba_problem_from_colmap(
    model: ColmapModel,
    camera_limit: Optional[int] = None,
    points_per_camera_limit: Optional[int] = None,
    min_track_len: int = 2,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 1024,
    device=None,
) -> Tuple[BAProblem, ProblemMeta]:
    """Flat-observation BA problem of a COLMAP model on ``device``
    (default: the CUDA card): optional camera / points-per-camera caps,
    only 3D points observed >= ``min_track_len`` times among the selected
    observations, the point table sorted by id."""
    device = resolve_device(device)
    n_images = len(model.images)
    rows = np.arange(n_images if camera_limit is None else min(camera_limit, n_images))

    cameras, widths, image_ids = _camera_arrays_from_model(model, rows, dtype, device)

    cam_idx_chunks, xy_chunks, pid_chunks = [], [], []
    for k, row in enumerate(rows):
        xy, p3d_ids = model.images.points2d_of(int(row))
        sel = np.nonzero(p3d_ids >= 0)[0]
        if points_per_camera_limit is not None:
            sel = sel[:points_per_camera_limit]
        cam_idx_chunks.append(np.full(len(sel), k, np.int32))
        xy_chunks.append(xy[sel])
        pid_chunks.append(p3d_ids[sel])
    cam_idx = np.concatenate(cam_idx_chunks) if cam_idx_chunks else np.zeros(0, np.int32)
    uv = np.concatenate(xy_chunks) if xy_chunks else np.zeros((0, 2))
    pids = np.concatenate(pid_chunks) if pid_chunks else np.zeros(0, np.int64)

    # Drop observations of point ids absent from the model's points.
    all_sorted = np.sort(np.asarray(model.points.ids))
    present = _searchsorted_hits(all_sorted, pids, np.searchsorted(all_sorted, pids))
    cam_idx, uv, pids = cam_idx[present], uv[present], pids[present]

    uniq, inverse, counts = np.unique(pids, return_inverse=True, return_counts=True)
    keep_point = counts >= min_track_len
    keep_obs = keep_point[inverse]
    cam_idx, uv, pids = cam_idx[keep_obs], uv[keep_obs], pids[keep_obs]

    kept_ids = uniq[keep_point]
    pt_idx = np.searchsorted(kept_ids, pids).astype(np.int32)

    order = np.argsort(np.asarray(model.points.ids))
    xyz_rows = np.asarray(model.points.xyz)[order][np.searchsorted(all_sorted, kept_ids)]

    n_obs = len(cam_idx)
    n_pad = bucket_size(max(n_obs, 1), pad_multiple)
    pad = n_pad - n_obs
    # Padding rows point at camera 0 / point 0 with mask 0.
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int32)])
    pt_idx = np.concatenate([pt_idx, np.zeros(pad, np.int32)])
    uv = np.concatenate([uv, np.zeros((pad, 2))])
    mask = np.concatenate([np.ones(n_obs), np.zeros(pad)])

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    problem = BAProblem(
        cameras=cameras,
        points3d=t(xyz_rows),
        cam_idx=t(cam_idx, torch.int32),
        pt_idx=t(pt_idx, torch.int32),
        uv=t(uv),
        mask=t(mask),
        avg_cam_width=t(float(np.mean(widths))),
    )
    meta = ProblemMeta(
        camera_ids=image_ids,
        point_ids=kept_ids,
        widths=widths,
        n_real_obs=n_obs,
    )
    return problem, meta


def _host64(x) -> np.ndarray:
    return x.detach().cpu().double().numpy()


def colmap_model_with_solution(
    model: ColmapModel,
    cameras: CameraParams,
    points3d: torch.Tensor,
    meta: ProblemMeta,
) -> ColmapModel:
    """A BA solution written back into a new COLMAP model (the input is
    untouched).  Packed camera rows map to image ids through
    ``meta.camera_ids``, packed point rows to point ids through
    ``meta.point_ids``; what the problem did not cover keeps its values.
    Poses are converted in host float64."""
    rmats = _host64(cameras.rmats)
    tvecs = _host64(cameras.tvecs)
    qvecs_new = matrix_to_quat_batch(torch.from_numpy(rmats)).numpy()

    image_ids = np.asarray(model.images.image_ids)
    row_of_image = {int(i): r for r, i in enumerate(image_ids)}
    qvecs = np.asarray(model.images.qvecs).copy()
    tvecs_out = np.asarray(model.images.tvecs).copy()
    fx_fy = _host64(cameras.fx_fy)
    new_cameras = dict(model.cameras)
    for packed_row, image_id in enumerate(np.asarray(meta.camera_ids)):
        r = row_of_image.get(int(image_id))
        if r is None:
            continue
        qvecs[r] = qvecs_new[packed_row]
        tvecs_out[r] = tvecs[packed_row]
        # Solved focal lengths go back into the (possibly shared) camera
        # record; with shared cameras the last packed row wins.
        cam_id = int(model.images.camera_ids[r])
        cam = new_cameras[cam_id]
        params = np.asarray(cam.params, np.float64).copy()
        if cam.model in (CameraModelType.PINHOLE, CameraModelType.OPENCV):
            params[0:2] = fx_fy[packed_row]
        else:  # single-focal families (SIMPLE_PINHOLE, SIMPLE_RADIAL, ...)
            params[0] = fx_fy[packed_row, 0]
        new_cameras[cam_id] = dataclasses.replace(cam, params=params)

    xyz = np.asarray(model.points.xyz).copy()
    pts = _host64(points3d)
    if len(meta.point_ids):
        rows = np.asarray(
            [model.point_row_of_id(int(pid)) for pid in np.asarray(meta.point_ids)]
        )
        xyz[rows] = pts[: len(rows)]

    return dataclasses.replace(
        model,
        cameras=new_cameras,
        images=dataclasses.replace(model.images, qvecs=qvecs, tvecs=tvecs_out),
        points=dataclasses.replace(model.points, xyz=xyz),
    )
