"""Packed, static-shape problem containers.

Counterpart of ``tpu3drecon/problems/packing.py:36-118``: the camera
parameter block and the flat-observation (BAL) bundle-adjustment problem,
as dataclasses of tensors.  ``.to(device)`` moves every tensor.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


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
