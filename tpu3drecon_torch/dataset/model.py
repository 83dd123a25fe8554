"""Thin object-level scene model: cameras, points, entries.

Counterpart of ``tpu3drecon/dataset/model.py`` (pure numpy): the object
layer for users of the reference's object model, with the numerical work
(projection, reprojection errors) vectorized over a camera's points; the
packed problems of ``tpu3drecon_torch.problems`` are the hot path.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from tpu3drecon_torch.dataset.camera_pose import (
    CameraPose,
    TransformationDirection,
)


@dataclass
class ImageMetadata:
    """Reference imageMetadata.py:5-10."""

    identifier: str
    image_path: Optional[str]
    width: int
    height: int


@dataclass
class Point2D:
    """Reference point.py:8-27."""

    identifier: int
    x: float
    y: float
    point3D_identifier: Optional[int]
    metadata: Dict = field(default_factory=dict)

    @property
    def xy(self) -> np.ndarray:
        return np.array([self.x, self.y])

    def translate_np(self, xy) -> None:
        self.x += float(xy[0])
        self.y += float(xy[1])

    def translated_np(self, xy) -> "Point2D":
        new = copy.deepcopy(self)
        new.translate_np(xy)
        return new


@dataclass
class Point3D:
    """Reference point.py:30-71."""

    identifier: int
    x: float
    y: float
    z: float
    metadata: Dict = field(default_factory=dict)

    @property
    def xyz(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z])

    def translate(self, x, y, z) -> None:
        self.x += x
        self.y += y
        self.z += z

    def translate_np(self, xyz) -> None:
        self.translate(float(xyz[0]), float(xyz[1]), float(xyz[2]))

    def translated_np(self, xyz) -> "Point3D":
        new = copy.deepcopy(self)
        new.translate_np(xyz)
        return new

    def __key(self):
        return self.x, self.y, self.z, self.identifier, str(self.metadata)

    def __hash__(self):
        return hash(self.__key())

    def __eq__(self, other):
        if isinstance(other, Point3D):
            return self.__key() == other.__key()
        return NotImplemented


@dataclass
class CameraIntrinsics:
    """Reference camera.py:14-47."""

    camera_intrinsics_matrix: Optional[np.ndarray]
    focal_length: Union[float, Tuple[float, float], None]
    skew_factor: Optional[float]
    center_x: Optional[float]
    center_y: Optional[float]

    @property
    def focal_x(self) -> float:
        if isinstance(self.focal_length, tuple):
            return self.focal_length[0]
        return self.focal_length

    @property
    def focal_y(self) -> float:
        if isinstance(self.focal_length, tuple):
            return self.focal_length[1]
        return self.focal_length

    def apply_noise(self, noise_matrix: np.ndarray, masked: bool = True) -> None:
        """Perturb fx, fy, cx, cy, skew by the corresponding entries of a 3x3
        noise matrix (reference camera.py:30-47 semantics)."""
        if self.camera_intrinsics_matrix is None:
            return
        nm = np.asarray(noise_matrix)
        if masked:
            for (i, j) in [(0, 0), (1, 1), (0, 2), (1, 2), (0, 1)]:
                self.camera_intrinsics_matrix[i, j] += nm[i, j]
        else:
            self.camera_intrinsics_matrix += nm
        if isinstance(self.focal_length, tuple):
            self.focal_length = (
                self.focal_length[0] + nm[0, 0],
                self.focal_length[1] + nm[1, 1],
            )
        elif self.focal_length is not None:
            self.focal_length += nm[0, 0]
        self.skew_factor = (self.skew_factor or 0.0) + nm[0, 1]
        self.center_x = (self.center_x or 0.0) + nm[0, 2]
        self.center_y = (self.center_y or 0.0) + nm[1, 2]


def params_to_intrinsics(fx, fy, cx, cy, s=None) -> CameraIntrinsics:
    """Reference loader.py:27-29."""
    return CameraIntrinsics(
        camera_intrinsics_matrix=np.array(
            [[fx, s if s else 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]
        ),
        focal_length=(fx, fy),
        skew_factor=s if s else 0.0,
        center_x=cx,
        center_y=cy,
    )


@dataclass
class Camera:
    """Reference camera.py:50-94: pose + intrinsics + image size."""

    camera_pose: CameraPose
    camera_intrinsics: Optional[CameraIntrinsics]
    width: int
    height: int

    def project(self, point3D: Union[Point3D, np.ndarray]) -> np.ndarray:
        xyz = point3D.xyz if isinstance(point3D, Point3D) else np.asarray(point3D)
        w2c = self.camera_pose.in_direction(TransformationDirection.W2C)
        p = self.camera_intrinsics.camera_intrinsics_matrix @ (
            w2c.rotation @ xyz + w2c.translation
        )
        return p[:2] / p[2]

    def _project_many(self, p3d: np.ndarray) -> np.ndarray:
        """Vectorized projection (replaces the reference's per-point loops)."""
        w2c = self.camera_pose.in_direction(TransformationDirection.W2C)
        ke = self.camera_intrinsics.camera_intrinsics_matrix @ np.c_[
            w2c.rotation, w2c.translation
        ]
        hom = ke @ np.c_[p3d, np.ones(len(p3d))].T
        return (hom[:2] / hom[2]).T

    def compute_inlier_mask(self, p2d, p3d, max_error) -> List[bool]:
        errs = self.compute_projection_errors_alt(p2d, p3d, lambda x: x)
        return list(errs <= max_error)

    def compute_inlier_mask_mod(self, p2d, p3d) -> List[bool]:
        errs = self.compute_projection_errors_alt(p2d, p3d, lambda x: x)
        return list(errs <= np.median(errs))

    def compute_projection_errors_alt(
        self, p2d, p3d, loss_function: Callable[[np.ndarray], np.ndarray]
    ) -> np.ndarray:
        """Per-point sum over axes of loss(squared error) — the reference's
        evaluation metric (camera.py:78-85)."""
        p2d = np.asarray([np.asarray(p) for p in p2d])
        p3d = np.asarray([np.asarray(p) for p in p3d])
        reproj = self._project_many(p3d)
        return loss_function((p2d - reproj) ** 2).sum(axis=1)

    @staticmethod
    def difference(camera_1: "Camera", camera_2: "Camera") -> Dict[str, float]:
        return {
            "identity_error": CameraPose.compute_rotation_error(
                camera_1.camera_pose, camera_2.camera_pose
            ),
            "rad": CameraPose.compute_rotation_error_in_rad(
                camera_1.camera_pose, camera_2.camera_pose
            ),
            "degrees": CameraPose.compute_rotation_error_in_degrees(
                camera_1.camera_pose, camera_2.camera_pose
            ),
            "positional": CameraPose.compute_position_error(
                camera_1.camera_pose, camera_2.camera_pose
            ),
        }


@dataclass
class DatasetEntry:
    """Reference datasetEntry.py:9-53: one image + its 2D points + camera."""

    image_metadata: ImageMetadata
    points2D: List[Point2D]
    camera: Camera
    points2D_mapped: Dict = field(init=False)

    def __post_init__(self):
        self.refresh_mapping()

    def refresh_mapping(self) -> None:
        self.points2D_mapped = {p.identifier: p for p in self.points2D}

    def points_with_3d(self) -> List[Point2D]:
        return [p for p in self.points2D if p.point3D_identifier is not None and p.point3D_identifier >= 0]

    def map2d_3d(self, points3D_mapped: Dict, zipped: bool = True, np: bool = False):
        pts = self.points_with_3d()
        if zipped:
            if not np:
                return [(p, points3D_mapped.get(p.point3D_identifier)) for p in pts]
            return [
                (p.xy, points3D_mapped.get(p.point3D_identifier).xyz) for p in pts
            ]
        if not np:
            return pts, [points3D_mapped.get(p.point3D_identifier) for p in pts]
        return (
            [p.xy for p in pts],
            [points3D_mapped.get(p.point3D_identifier).xyz for p in pts],
        )

    @property
    def num_3d_points(self) -> int:
        return len(self.points_with_3d())

    @property
    def num_2d_points(self) -> int:
        return len(self.points2D)

    @property
    def identifier(self):
        return self.image_metadata.identifier
