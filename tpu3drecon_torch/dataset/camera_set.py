"""CameraSet: pose collections with alignment and COLMAP round trips.

Counterpart of ``tpu3drecon/dataset/camera_set.py``: poses normalized to
COLMAP / C2W, closed-form set alignments (Horn quaternion, Umeyama SVD,
random-subset robust) through ``tpu3drecon_torch.geometry.alignment`` on
float64 CPU tensors, pairwise set error reports, and COLMAP sparse models
of bare camera sets (optionally remapped to a COLMAP sqlite database).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tpu3drecon_torch.dataset.camera_pose import (
    CameraPose,
    CoordinateSystem,
    TransformationDirection,
)
from tpu3drecon_torch.geometry.alignment import (
    Similarity,
    alignment_errors,
    horn_quaternion_alignment,
    robust_alignment,
    umeyama_alignment,
)
from tpu3drecon_torch.geometry.rotations import matrix_to_quat
from tpu3drecon_torch.io import colmap as cio


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64))


class CameraSet:
    """A named set of camera poses, stored normalized to COLMAP / C2W
    (reference camera_set.py:33-38)."""

    def __init__(self, poses: List[CameraPose], name: Optional[str] = None):
        self.name = name
        self.poses: List[CameraPose] = [
            p.in_coordinate_system(CoordinateSystem.COLMAP).in_direction(
                TransformationDirection.C2W
            )
            for p in poses
        ]

    def __len__(self) -> int:
        return len(self.poses)

    def __iter__(self):
        return iter(self.poses)

    def identifiers(self) -> List[Optional[str]]:
        return [p.identifier for p in self.poses]

    def positions(self) -> np.ndarray:
        return np.stack([p.position for p in self.poses])

    # ---- alignment -------------------------------------------------------

    def compute_pose_quaternion(
        self, other: "CameraSet", with_scale: bool = True
    ) -> Similarity:
        """Horn's quaternion absolute orientation aligning self -> other
        (reference camera_set.py:168-237)."""
        return horn_quaternion_alignment(
            _f64(self.positions()), _f64(other.positions()), with_scale
        )

    def compute_pose_matrix(
        self, other: "CameraSet", with_scale: bool = True
    ) -> Similarity:
        """Umeyama SVD alignment (reference camera_set.py:239-295)."""
        return umeyama_alignment(
            _f64(self.positions()), _f64(other.positions()), with_scale
        )

    def compute_robust_pose(
        self, other: "CameraSet", n_trials: int = 300, seed: int = 0
    ) -> Similarity:
        """Random-subset robust alignment (reference camera_set.py:297-340)."""
        return robust_alignment(
            self.positions(), other.positions(), n_trials=n_trials, seed=seed
        )

    def compute_set_errors(
        self, other: "CameraSet", sim: Optional[Similarity] = None
    ) -> Dict[str, Dict[str, float]]:
        """Per-camera position/rotation errors after (optional) alignment
        (reference camera_set.py:342-396's pairwise error dicts)."""
        if sim is None:
            sim = self.compute_pose_matrix(other)
        pos_err = alignment_errors(
            sim, _f64(self.positions()), _f64(other.positions())
        ).numpy()
        out: Dict[str, Dict[str, float]] = {}
        for i, (a, b) in enumerate(zip(self.poses, other.poses)):
            key = a.identifier or str(i)
            out[key] = {
                "position_error": float(pos_err[i]),
                "rotation_error_rad": CameraPose.compute_rotation_error_in_rad(a, b),
                "rotation_error_deg": CameraPose.compute_rotation_error_in_degrees(a, b),
            }
        return out

    # ---- COLMAP round-trips ---------------------------------------------

    @classmethod
    def from_sparse_folder(cls, sparse_dir: str, name: Optional[str] = None) -> "CameraSet":
        """Load the camera poses of a COLMAP sparse model
        (reference camera_set.py:126-142)."""
        model = cio.read_model(sparse_dir)
        poses = []
        for row in range(len(model.images)):
            q = model.images.qvecs[row]
            t = model.images.tvecs[row]
            pose = CameraPose.from_string_wxyz_quaternion_translation(
                " ".join(map(str, [*q, *t])),
                identifier=model.images.names[row],
                coordinate_system=CoordinateSystem.COLMAP,
                direction=TransformationDirection.W2C,
            )
            poses.append(pose)
        return cls(poses, name=name)

    def create_sparse_model(
        self,
        output_dir: str,
        intrinsics: np.ndarray,
        width: int,
        height: int,
        binary: bool = True,
        database_path: Optional[str] = None,
    ) -> None:
        """Write a points-free COLMAP sparse model of this camera set
        (reference camera_set.py:61-124).

        With ``database_path`` set, image ids and filenames are remapped to
        the entries of that COLMAP sqlite feature database (matching the
        reference's behavior so a subsequent ``colmap point_triangulator``
        pass joins poses to the database's features), and poses whose
        identifier has no database row are dropped.  Without it, ids are
        positional (1..N).
        """
        id_name_by_identifier = None
        if database_path is not None:
            id_name_by_identifier = _read_image_db_mapping(database_path)

        k = np.asarray(intrinsics)
        cameras = {
            1: cio.ColmapCamera(
                camera_id=1,
                model=cio.CameraModelType.PINHOLE,
                width=width,
                height=height,
                params=np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2]]),
            )
        }
        poses = self.poses
        image_ids = None
        if id_name_by_identifier is not None:
            poses = [p_ for p_ in poses if p_.identifier in id_name_by_identifier]
            image_ids = np.asarray(
                [id_name_by_identifier[p_.identifier][0] for p_ in poses], np.int32
            )
        n = len(poses)
        qvecs = np.zeros((n, 4))
        tvecs = np.zeros((n, 3))
        names = []
        for i, pose in enumerate(poses):
            w2c = pose.in_direction(TransformationDirection.W2C)
            qvecs[i] = matrix_to_quat(_f64(w2c.rotation)).numpy()
            tvecs[i] = w2c.translation
            if id_name_by_identifier is not None:
                names.append(id_name_by_identifier[pose.identifier][1])
            else:
                names.append(pose.identifier or f"image_{i:04d}.jpg")
        images = cio.ColmapImages(
            image_ids=image_ids if image_ids is not None
            else np.arange(1, n + 1, dtype=np.int32),
            qvecs=qvecs,
            tvecs=tvecs,
            camera_ids=np.ones(n, np.int32),
            names=names,
            p2d_offsets=np.zeros(n + 1, np.int64),
            p2d_xy=np.zeros((0, 2)),
            p2d_point3d_ids=np.zeros(0, np.int64),
        )
        cio.write_model(
            cio.ColmapModel(cameras=cameras, images=images, points=cio.empty_points()),
            output_dir,
            binary=binary,
        )


def _read_image_db_mapping(database_path: str) -> dict:
    """identifier (filename stem) -> (image_id, filename) from a COLMAP
    sqlite database's images table (reference camera_set.py:63-76)."""
    import os
    import sqlite3

    conn = sqlite3.connect(database_path)
    try:
        rows = conn.execute("SELECT image_id, name FROM images").fetchall()
    finally:
        conn.close()
    return {os.path.splitext(name)[0]: (int(image_id), name) for image_id, name in rows}
