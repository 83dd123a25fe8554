"""Pack problems straight from the object-level Dataset.

Counterpart of ``tpu3drecon/problems/from_dataset.py``: the thin object
layer (``tpu3drecon_torch.dataset``) into the packed containers, tensors
built on ``device`` (default: the CUDA card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu3drecon_torch.dataset.camera_pose import TransformationDirection
from tpu3drecon_torch.dataset.scene import Dataset
from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.problems.packing import (
    BAProblem,
    CameraParams,
    PoseProblem,
    ProblemMeta,
    bucket_size,
)


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _camera_arrays(ds: Dataset, dtype, device):
    n = len(ds.datasetEntries)
    rmats = np.zeros((n, 3, 3))
    tvecs = np.zeros((n, 3))
    fx_fy = np.zeros((n, 2))
    ccs = np.zeros((n, 3))
    widths = np.zeros(n)
    for i, e in enumerate(ds.datasetEntries):
        w2c = e.camera.camera_pose.in_direction(TransformationDirection.W2C)
        rmats[i] = w2c.rotation
        tvecs[i] = w2c.translation
        intr = e.camera.camera_intrinsics
        fx_fy[i] = (intr.focal_x, intr.focal_y)
        ccs[i] = (intr.center_x, intr.center_y, intr.skew_factor or 0.0)
        widths[i] = e.camera.width
    cams = CameraParams(
        rmats=_t(rmats, dtype, device),
        tvecs=_t(tvecs, dtype, device),
        fx_fy=_t(fx_fy, dtype, device),
        cx_cy_skew=_t(ccs, dtype, device),
        dist=torch.zeros((n, 2), dtype=dtype, device=device),  # pinhole (Camera.project)
    )
    return cams, widths


def pose_problem_from_dataset(
    ds: Dataset, dtype: torch.dtype = torch.float32, pad_multiple: int = 256, device=None
) -> Tuple[PoseProblem, ProblemMeta]:
    """Per-image PnP problems of a Dataset on ``device`` (default: the CUDA
    card)."""
    device = resolve_device(device)
    cams, widths = _camera_arrays(ds, dtype, device)
    per_xy, per_xyz = [], []
    for e in ds.datasetEntries:
        p2d, p3d = e.map2d_3d(ds.points3D_mapped, zipped=False, np=True)
        per_xy.append(np.asarray(p2d).reshape(-1, 2))
        per_xyz.append(np.asarray(p3d).reshape(-1, 3))
    max_n = bucket_size(max((len(x) for x in per_xy), default=1), pad_multiple)
    B = len(per_xy)
    pts3 = np.zeros((B, max_n, 3))
    pts2 = np.zeros((B, max_n, 2))
    mask = np.zeros((B, max_n))
    for k in range(B):
        n = len(per_xy[k])
        pts2[k, :n] = per_xy[k]
        pts3[k, :n] = per_xyz[k]
        mask[k, :n] = 1.0
    problem = PoseProblem(
        cameras=cams,
        points3d=_t(pts3, dtype, device),
        points2d=_t(pts2, dtype, device),
        mask=_t(mask, dtype, device),
        avg_cam_width=_t(float(np.mean(widths)), dtype, device),
    )
    meta = ProblemMeta(
        camera_ids=np.arange(len(ds.datasetEntries)),
        point_ids=np.zeros(0, np.int64),
        widths=widths,
        n_real_obs=int(sum(len(x) for x in per_xy)),
    )
    return problem, meta


def ba_problem_from_dataset(
    ds: Dataset,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 1024,
    min_track_len: int = 2,
    device=None,
) -> Tuple[BAProblem, ProblemMeta]:
    """Flat BA problem of a Dataset on ``device`` (default: the CUDA card):
    points observed >= ``min_track_len`` times, the point table sorted by
    id."""
    device = resolve_device(device)
    cams, widths = _camera_arrays(ds, dtype, device)

    cam_chunks, xy_chunks, pid_chunks = [], [], []
    for i, e in enumerate(ds.datasetEntries):
        pts = e.points_with_3d()
        cam_chunks.append(np.full(len(pts), i, np.int32))
        xy_chunks.append(np.array([[p.x, p.y] for p in pts]).reshape(-1, 2))
        pid_chunks.append(np.array([p.point3D_identifier for p in pts], np.int64))
    cam_idx = np.concatenate(cam_chunks)
    uv = np.concatenate(xy_chunks)
    pids = np.concatenate(pid_chunks)

    uniq, inverse, counts = np.unique(pids, return_inverse=True, return_counts=True)
    keep_point = counts >= min_track_len
    keep_obs = keep_point[inverse]
    cam_idx, uv, pids = cam_idx[keep_obs], uv[keep_obs], pids[keep_obs]
    kept_ids = uniq[keep_point]
    pt_idx = np.searchsorted(kept_ids, pids).astype(np.int32)
    xyz = np.stack([ds.points3D_mapped[int(pid)].xyz for pid in kept_ids])

    n_obs = len(cam_idx)
    n_pad = bucket_size(max(n_obs, 1), pad_multiple)
    pad = n_pad - n_obs
    problem = BAProblem(
        cameras=cams,
        points3d=_t(xyz, dtype, device),
        cam_idx=_t(np.concatenate([cam_idx, np.zeros(pad, np.int32)]), torch.int32, device),
        pt_idx=_t(np.concatenate([pt_idx, np.zeros(pad, np.int32)]), torch.int32, device),
        uv=_t(np.concatenate([uv, np.zeros((pad, 2))]), dtype, device),
        mask=_t(np.concatenate([np.ones(n_obs), np.zeros(pad)]), dtype, device),
        avg_cam_width=_t(float(np.mean(widths)), dtype, device),
    )
    meta = ProblemMeta(
        camera_ids=np.arange(len(ds.datasetEntries)),
        point_ids=kept_ids,
        widths=widths,
        n_real_obs=n_obs,
    )
    return problem, meta
