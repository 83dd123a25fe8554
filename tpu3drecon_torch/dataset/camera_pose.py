"""Object-level camera pose with tagged coordinate-system semantics.

Counterpart of ``tpu3drecon/dataset/camera_pose.py``: LH ("UNITY") / RH
("COLMAP") coordinate systems, C2W / W2C directions, inverse and
conversion, QT / RT / T string and file (de)serialization with the same
metadata header grammar, and the rotation / position error metrics.
Rotations are float64 numpy matrices; conversions run through the port's
pose and rotation algebra on float64 CPU tensors.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path
from typing import Optional

import numpy as np

import torch

from tpu3drecon_torch.geometry import pose as _pose
from tpu3drecon_torch.geometry import rotations as _rot


def _f64(x) -> torch.Tensor:
    """A float64 CPU tensor of a numpy array."""
    return torch.as_tensor(np.asarray(x, np.float64))


class TransformationDirection(enum.Enum):
    C2W = "C2W"
    W2C = "W2C"

    @classmethod
    def get_enum_by_name(cls, name):
        return cls.__members__.get(name)

    def opposite(self) -> "TransformationDirection":
        return (
            TransformationDirection.W2C
            if self == TransformationDirection.C2W
            else TransformationDirection.C2W
        )


class CoordinateSystem(enum.Enum):
    """LH (Unity) vs RH (COLMAP); aliases match the reference enum
    (enums_and_types.py:20-24)."""

    LH = "LH"
    RH = "RH"

    @classmethod
    def get_enum_by_name(cls, name):
        aliases = {"UNITY": cls.LH, "COLMAP": cls.RH}
        return cls.__members__.get(name) or aliases.get(name)


# Reference-style aliases.
CoordinateSystem.UNITY = CoordinateSystem.LH
CoordinateSystem.COLMAP = CoordinateSystem.RH


class PoseFormat(enum.Enum):
    QT = "QT"  # wxyz quaternion + translation, one line
    RT = "RT"  # 3x4 rotation|translation matrix
    T = "T"  # 4x4 homogeneous matrix

    @classmethod
    def get_enum_by_name(cls, name):
        return cls.__members__.get(name)


class InvalidInputFormatErr(Exception):
    """Raised on malformed pose strings/files (exceptions.py:1-10)."""


def _parse_metadata(metadata: str):
    split = metadata.split()
    if len(split) != 3:
        raise InvalidInputFormatErr("Invalid Metadata")
    fmt = next((PoseFormat.get_enum_by_name(s) for s in split if PoseFormat.get_enum_by_name(s)), None)
    cs = next((CoordinateSystem.get_enum_by_name(s) for s in split if CoordinateSystem.get_enum_by_name(s)), None)
    d = next(
        (TransformationDirection.get_enum_by_name(s) for s in split if TransformationDirection.get_enum_by_name(s)),
        None,
    )
    if not (fmt and cs and d):
        raise InvalidInputFormatErr("Invalid Metadata Format")
    return fmt, cs, d


def _create_metadata(fmt: PoseFormat, cs: CoordinateSystem, d: TransformationDirection) -> str:
    return " ".join([fmt.name, cs.name, d.name])


class CameraPose:
    """Rotation matrix + translation with coordinate-system/direction tags."""

    def __init__(
        self,
        rotation: np.ndarray,
        translation: np.ndarray,
        identifier: Optional[str] = None,
        coordinate_system: CoordinateSystem = CoordinateSystem.UNITY,
        direction: TransformationDirection = TransformationDirection.C2W,
    ):
        self.rotation = np.asarray(rotation, dtype=np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, dtype=np.float64).reshape(3)
        self.identifier = identifier
        self.coordinate_system = coordinate_system
        self.direction = direction

    def __repr__(self):
        return (
            f"Rotation: \n{self.rotation.round(2)} \n"
            f"Translation {self.translation.round(2)}"
        )

    # ---- conversions -----------------------------------------------------

    def inverse(self) -> "CameraPose":
        r, t = _pose.pose_inverse(_f64(self.rotation), _f64(self.translation))
        return CameraPose(
            r.numpy(),
            t.numpy(),
            identifier=self.identifier,
            coordinate_system=self.coordinate_system,
            direction=self.direction.opposite(),
        )

    def in_coordinate_system(self, target: CoordinateSystem) -> "CameraPose":
        if self.coordinate_system == target:
            return CameraPose(
                self.rotation, self.translation, self.identifier,
                self.coordinate_system, self.direction,
            )
        r, t = _pose.pose_convert_coordinate_system(
            _f64(self.rotation), _f64(self.translation)
        )
        return CameraPose(r.numpy(), t.numpy(), self.identifier, target, self.direction)

    def in_direction(self, target: TransformationDirection) -> "CameraPose":
        if self.direction == target:
            return CameraPose(
                self.rotation, self.translation, self.identifier,
                self.coordinate_system, self.direction,
            )
        return self.inverse()

    def apply_transform_3d(self, matrix_3d: np.ndarray) -> None:
        self.rotation = np.asarray(matrix_3d) @ self.rotation
        self.translation = np.asarray(matrix_3d) @ self.translation

    def apply_translation(self, translation_vector: np.ndarray) -> None:
        self.translation = self.translation + np.asarray(translation_vector)

    def apply_move(self, translation_vector: np.ndarray) -> None:
        """Move the camera *center* by a world-space vector regardless of the
        stored direction (semantics of camera_pose.py:102-107)."""
        if self.direction == TransformationDirection.C2W:
            self.apply_translation(translation_vector)
        else:
            inv = self.inverse()
            inv.apply_translation(translation_vector)
            back = inv.inverse()
            self.rotation, self.translation = back.rotation, back.translation

    # ---- properties ------------------------------------------------------

    @property
    def position(self) -> np.ndarray:
        if self.direction == TransformationDirection.C2W:
            return self.translation
        return self.inverse().translation

    @property
    def rotation_matrix(self) -> np.ndarray:
        return self.rotation

    @property
    def rotation_translation_matrix(self) -> np.ndarray:
        return np.c_[self.rotation, self.translation]

    @property
    def transformation_translation_matrix(self) -> np.ndarray:
        return np.r_[self.rotation_translation_matrix, [[0.0, 0.0, 0.0, 1.0]]]

    @property
    def wxyz_quaternion(self) -> np.ndarray:
        return _rot.matrix_to_quat(_f64(self.rotation)).numpy()

    # ---- serialization ---------------------------------------------------

    def as_wxyz_quaternion_translation_str(self) -> str:
        q = self.wxyz_quaternion
        return " ".join(map(str, [*q, *self.translation]))

    def as_rotation_translation_str(self) -> str:
        return os.linesep.join(
            " ".join(map(str, row)) for row in self.rotation_translation_matrix
        )

    def as_transformation_translation_str(self) -> str:
        return os.linesep.join(
            " ".join(map(str, row)) for row in self.transformation_translation_matrix
        )

    def to_file(self, filepath, pose_format: PoseFormat = PoseFormat.QT, include_metadata: bool = True) -> None:
        with open(filepath, "w") as f:
            if include_metadata:
                f.write(
                    _create_metadata(pose_format, self.coordinate_system, self.direction)
                    + os.linesep
                )
            if pose_format == PoseFormat.QT:
                f.write(self.as_wxyz_quaternion_translation_str())
            elif pose_format == PoseFormat.RT:
                f.write(self.as_rotation_translation_str())
            elif pose_format == PoseFormat.T:
                f.write(self.as_transformation_translation_str())

    @classmethod
    def from_string_wxyz_quaternion_translation(
        cls, string: str, identifier=None,
        coordinate_system=CoordinateSystem.UNITY,
        direction=TransformationDirection.C2W,
    ) -> "CameraPose":
        content = string.split()
        if len(content) != 7:
            raise InvalidInputFormatErr(f"expected 7 values, got {len(content)}")
        try:
            vals = list(map(float, content))
        except ValueError as e:
            raise InvalidInputFormatErr from e
        q = np.array(vals[:4])
        q = q / np.linalg.norm(q)
        rotation = _rot.quat_to_matrix(_f64(q)).numpy()
        return cls(rotation, np.array(vals[4:7]), identifier, coordinate_system, direction)

    @classmethod
    def from_string_rotation_translation(
        cls, string: str, identifier=None,
        coordinate_system=CoordinateSystem.UNITY,
        direction=TransformationDirection.C2W,
    ) -> "CameraPose":
        rows = [r.split() for r in string.splitlines() if r.strip()]
        if len(rows) != 3 or any(len(r) != 4 for r in rows):
            raise InvalidInputFormatErr("RT format needs a 3x4 matrix")
        try:
            mat = np.array([[float(x) for x in r] for r in rows])
        except ValueError as e:
            raise InvalidInputFormatErr from e
        return cls(mat[:, :3], mat[:, 3], identifier, coordinate_system, direction)

    @classmethod
    def from_string_transformation_translation(
        cls, string: str, identifier=None,
        coordinate_system=CoordinateSystem.UNITY,
        direction=TransformationDirection.C2W,
    ) -> "CameraPose":
        rows = [r.split() for r in string.splitlines() if r.strip()]
        if len(rows) != 4 or any(len(r) != 4 for r in rows):
            raise InvalidInputFormatErr("T format needs a 4x4 matrix")
        try:
            mat = np.array([[float(x) for x in r] for r in rows])
        except ValueError as e:
            raise InvalidInputFormatErr from e
        return cls(mat[:3, :3], mat[:3, 3], identifier, coordinate_system, direction)

    @classmethod
    def from_string(
        cls, string: str, identifier=None,
        pose_format=PoseFormat.QT,
        coordinate_system=CoordinateSystem.UNITY,
        direction=TransformationDirection.C2W,
    ) -> "CameraPose":
        dispatch = {
            PoseFormat.QT: cls.from_string_wxyz_quaternion_translation,
            PoseFormat.RT: cls.from_string_rotation_translation,
            PoseFormat.T: cls.from_string_transformation_translation,
        }
        return dispatch[pose_format](
            string, identifier=identifier,
            coordinate_system=coordinate_system, direction=direction,
        )

    @classmethod
    def from_formatted_string(cls, string: str, identifier=None) -> "CameraPose":
        lines = string.splitlines()
        fmt, cs, d = _parse_metadata(lines[0])
        return cls.from_string(
            os.linesep.join(lines[1:]), identifier=identifier,
            pose_format=fmt, coordinate_system=cs, direction=d,
        )

    @classmethod
    def from_file(
        cls, filepath, pose_format=PoseFormat.QT,
        coordinate_system=CoordinateSystem.UNITY,
        direction=TransformationDirection.C2W,
    ) -> "CameraPose":
        with open(filepath) as f:
            return cls.from_string(
                f.read(), identifier=Path(filepath).stem,
                pose_format=pose_format,
                coordinate_system=coordinate_system, direction=direction,
            )

    @classmethod
    def from_formatted_file(cls, filepath) -> "CameraPose":
        with open(filepath) as f:
            metadata = f.readline().strip(os.linesep)
            fmt, cs, d = _parse_metadata(metadata)
            return cls.from_string(
                f.read(), identifier=Path(filepath).stem,
                pose_format=fmt, coordinate_system=cs, direction=d,
            )

    # ---- comparison metrics ---------------------------------------------

    @staticmethod
    def compute_position_error(a: "CameraPose", b: "CameraPose") -> float:
        return float(np.linalg.norm(a.position - b.position))

    @staticmethod
    def compute_rotation_error(a: "CameraPose", b: "CameraPose") -> float:
        """Frobenius distance of relative rotation from identity."""
        ra = a.in_direction(TransformationDirection.C2W).rotation
        rb = b.in_direction(TransformationDirection.C2W).rotation
        return float(np.linalg.norm(ra.T @ rb - np.eye(3)))

    @staticmethod
    def compute_rotation_error_in_rad(a: "CameraPose", b: "CameraPose") -> float:
        ra = a.in_direction(TransformationDirection.C2W).rotation
        rb = b.in_direction(TransformationDirection.C2W).rotation
        return float(
            _pose.rotation_geodesic_angle(_f64(ra), _f64(rb))
        )

    @staticmethod
    def compute_rotation_error_in_degrees(a: "CameraPose", b: "CameraPose") -> float:
        return CameraPose.compute_rotation_error_in_rad(a, b) * 180.0 / np.pi


def _orthonormalize(matrix_3d: np.ndarray) -> np.ndarray:
    """Project a near-rotation onto SO(3) via SVD."""
    u, _, vt = np.linalg.svd(matrix_3d)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    return r


def _camera_pose_apply_transform_4d(self: "CameraPose", matrix_4d: np.ndarray) -> None:
    """Apply a homogeneous 4x4 transform to this pose in place, with proper
    re-orthonormalization (the reference's apply_transform_4d,
    camera_pose.py:83-97, normalized rows r1,r1,r3 — a bug; here the product
    rotation is projected onto SO(3) by SVD)."""
    new = np.asarray(matrix_4d) @ self.transformation_translation_matrix
    self.rotation = _orthonormalize(new[:3, :3])
    self.translation = new[:3, 3]


CameraPose.apply_transform_4d = _camera_pose_apply_transform_4d
