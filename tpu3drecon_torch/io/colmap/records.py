"""COLMAP sparse-model records in packed struct-of-arrays (CSR) form.

Counterpart of ``tpu3drecon/io/colmap/records.py``, a copy of its numpy
dataclasses: a parsed model is three flat record groups whose ragged
per-image / per-track data is CSR-packed into contiguous numpy arrays, so
problem packing (``tpu3drecon_torch.problems.packing``) is a vectorized
pass.  The records are numpy on both sides; nothing here touches torch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


class CameraModelType(enum.IntEnum):
    """COLMAP camera model ids (reference cameras.py:21-33)."""

    SIMPLE_PINHOLE = 0
    PINHOLE = 1
    SIMPLE_RADIAL = 2
    RADIAL = 3
    OPENCV = 4
    OPENCV_FISHEYE = 5
    FULL_OPENCV = 6
    FOV = 7
    SIMPLE_RADIAL_FISHEYE = 8
    RADIAL_FISHEYE = 9
    THIN_PRISM_FISHEYE = 10


# Number of parameters per model (reference cameras.py:36-46).
CAMERA_MODEL_NUM_PARAMS: Dict[CameraModelType, int] = {
    CameraModelType.SIMPLE_PINHOLE: 3,
    CameraModelType.PINHOLE: 4,
    CameraModelType.SIMPLE_RADIAL: 4,
    CameraModelType.RADIAL: 5,
    CameraModelType.OPENCV: 8,
    CameraModelType.OPENCV_FISHEYE: 8,
    CameraModelType.FULL_OPENCV: 12,
    CameraModelType.FOV: 5,
    CameraModelType.SIMPLE_RADIAL_FISHEYE: 4,
    CameraModelType.RADIAL_FISHEYE: 5,
    CameraModelType.THIN_PRISM_FISHEYE: 12,
}

# COLMAP writes "no 3D point" as uint64 max; we normalize to -1.
INVALID_POINT3D_ID = -1


@dataclass
class ColmapCamera:
    """One COLMAP camera (intrinsics record)."""

    camera_id: int
    model: CameraModelType
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64

    def intrinsics_tuple(self):
        """Return (fx, fy, cx, cy, skew) for the pinhole family.

        SIMPLE_RADIAL/RADIAL keep the shared focal; distortion parameters are
        carried separately (reference get_intrinsics, loader.py:32-41, drops
        them the same way).
        """
        p = self.params
        if self.model in (CameraModelType.SIMPLE_PINHOLE, CameraModelType.SIMPLE_RADIAL,
                          CameraModelType.RADIAL, CameraModelType.SIMPLE_RADIAL_FISHEYE,
                          CameraModelType.RADIAL_FISHEYE):
            return float(p[0]), float(p[0]), float(p[1]), float(p[2]), 0.0
        # PINHOLE and the OPENCV family lead with fx, fy, cx, cy.
        return float(p[0]), float(p[1]), float(p[2]), float(p[3]), 0.0

    def distortion_params(self) -> np.ndarray:
        """Distortion coefficients beyond the pinhole block (may be empty)."""
        if self.model in (CameraModelType.SIMPLE_RADIAL, CameraModelType.SIMPLE_RADIAL_FISHEYE):
            return self.params[3:4]
        if self.model in (CameraModelType.RADIAL, CameraModelType.RADIAL_FISHEYE):
            return self.params[3:5]
        if self.model in (CameraModelType.OPENCV, CameraModelType.OPENCV_FISHEYE,
                          CameraModelType.FULL_OPENCV, CameraModelType.THIN_PRISM_FISHEYE):
            return self.params[4:]
        return np.zeros(0, dtype=np.float64)


@dataclass
class ColmapImages:
    """All registered images, CSR-packed.

    ``p2d_offsets[i]:p2d_offsets[i+1]`` indexes image i's keypoint rows in
    ``p2d_xy`` / ``p2d_point3d_ids``.
    """

    image_ids: np.ndarray  # (N,) int32
    qvecs: np.ndarray  # (N, 4) float64 wxyz, W2C
    tvecs: np.ndarray  # (N, 3) float64, W2C
    camera_ids: np.ndarray  # (N,) int32
    names: List[str]
    p2d_offsets: np.ndarray  # (N + 1,) int64
    p2d_xy: np.ndarray  # (total_p2d, 2) float64
    p2d_point3d_ids: np.ndarray  # (total_p2d,) int64, -1 = no 3D point

    def __len__(self) -> int:
        return len(self.image_ids)

    def num_points2d(self, i: int) -> int:
        return int(self.p2d_offsets[i + 1] - self.p2d_offsets[i])

    def points2d_of(self, i: int):
        s, e = int(self.p2d_offsets[i]), int(self.p2d_offsets[i + 1])
        return self.p2d_xy[s:e], self.p2d_point3d_ids[s:e]


@dataclass
class ColmapPoints:
    """All 3D points, CSR-packed tracks."""

    ids: np.ndarray  # (P,) int64
    xyz: np.ndarray  # (P, 3) float64
    rgb: np.ndarray  # (P, 3) uint8
    error: np.ndarray  # (P,) float64
    track_offsets: np.ndarray  # (P + 1,) int64
    track_image_ids: np.ndarray  # (total_track,) int32
    track_p2d_idxs: np.ndarray  # (total_track,) int32

    def __len__(self) -> int:
        return len(self.ids)

    def track_of(self, i: int):
        s, e = int(self.track_offsets[i]), int(self.track_offsets[i + 1])
        return self.track_image_ids[s:e], self.track_p2d_idxs[s:e]


@dataclass
class ColmapModel:
    """A full COLMAP sparse model: cameras + images + 3D points."""

    cameras: Dict[int, ColmapCamera]
    images: ColmapImages
    points: ColmapPoints

    _id_to_point_row: Dict[int, int] = field(default=None, repr=False, compare=False)

    def point_row_of_id(self, point3d_id: int) -> int:
        if self._id_to_point_row is None:
            self._id_to_point_row = {
                int(pid): row for row, pid in enumerate(self.points.ids)
            }
        return self._id_to_point_row[int(point3d_id)]


def empty_images() -> ColmapImages:
    return ColmapImages(
        image_ids=np.zeros(0, np.int32),
        qvecs=np.zeros((0, 4), np.float64),
        tvecs=np.zeros((0, 3), np.float64),
        camera_ids=np.zeros(0, np.int32),
        names=[],
        p2d_offsets=np.zeros(1, np.int64),
        p2d_xy=np.zeros((0, 2), np.float64),
        p2d_point3d_ids=np.zeros(0, np.int64),
    )


def empty_points() -> ColmapPoints:
    return ColmapPoints(
        ids=np.zeros(0, np.int64),
        xyz=np.zeros((0, 3), np.float64),
        rgb=np.zeros((0, 3), np.uint8),
        error=np.zeros(0, np.float64),
        track_offsets=np.zeros(1, np.int64),
        track_image_ids=np.zeros(0, np.int32),
        track_p2d_idxs=np.zeros(0, np.int32),
    )
