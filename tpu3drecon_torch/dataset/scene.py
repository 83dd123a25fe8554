"""The Dataset scene container: noising, reduction, evaluation.

Counterpart of ``tpu3drecon/dataset/scene.py``, the same public surface
(``with_noise``, ``make_reduced_dataset``,
``compute_reprojection_errors_alt``, stats) with noise drawn in bulk.  The
default generator is a module-level one, as in JAX; callers that need
reproducible draws pass their own ``np.random.Generator``.
"""

from __future__ import annotations

import copy
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpu3drecon_torch.dataset.model import Camera, DatasetEntry, Point2D, Point3D
from tpu3drecon_torch.geometry.rotations import rodrigues_to_matrix

# Deterministic module RNG (reference seeds global numpy at import,
# dataset/__init__.py:1-4; we keep determinism without the global).
SEED = 0
_rng = np.random.default_rng(SEED)


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    v = rng.random((n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@dataclass
class Dataset:
    """Scene container: 3D points + per-image entries."""

    points3D: List[Point3D]
    datasetEntries: List[DatasetEntry]
    name: Optional[str] = None
    points3D_mapped: Dict = field(init=False)

    def __post_init__(self):
        self.refresh_mapping()

    def refresh_mapping(self) -> None:
        self.points3D_mapped = {p.identifier: p for p in self.points3D}

    # ---- noise injection -------------------------------------------------

    @staticmethod
    def with_noise(
        dataset: "Dataset",
        point3d_noise: float = 3e-2,
        camera_rotation_noise: float = 5e-2,
        camera_translation_noise: float = 5e-2,
        camera_intrinsics_noise: float = 10.0,
        point2d_noise: float = 1.0,
        rng: Optional[np.random.Generator] = None,
    ) -> "Dataset":
        """Perturb points/poses/intrinsics/observations with unit-direction
        noise of fixed magnitude (reference dataset.py:43-63 semantics),
        drawn in bulk."""
        rng = rng or _rng
        new = copy.deepcopy(dataset)
        dirs = _unit_rows(rng, len(new.points3D), 3) * point3d_noise
        for p, d in zip(new.points3D, dirs):
            p.translate_np(d)
        for entry in new.datasetEntries:
            entry.camera.camera_pose.apply_move(
                _unit_rows(rng, 1, 3)[0] * camera_translation_noise
            )
            rotvec = _unit_rows(rng, 1, 3)[0] * camera_rotation_noise
            entry.camera.camera_pose.apply_transform_3d(
                rodrigues_to_matrix(torch.as_tensor(rotvec)).numpy()
            )
            entry.camera.camera_intrinsics.apply_noise(
                rng.random((3, 3)) * camera_intrinsics_noise
            )
            d2 = _unit_rows(rng, len(entry.points2D), 2) * point2d_noise
            for p2, dd in zip(entry.points2D, d2):
                p2.translate_np(dd)
            entry.refresh_mapping()
        new.refresh_mapping()
        return new

    # The reference needed a multiprocessing variant because its noiser
    # deep-copied per point (dataset.py:65-98); ours is vectorized, so the MP
    # variant is just an alias kept for API compatibility.
    with_noise_mp = with_noise

    # ---- evaluation ------------------------------------------------------

    def compute_reprojection_errors_alt(
        self, loss_function
    ) -> Dict[int, np.ndarray]:
        """Per-entry arrays of summed per-axis loss(squared error)
        (reference dataset.py:116-123)."""
        fn = loss_function.value if hasattr(loss_function, "value") else loss_function
        out: Dict[int, np.ndarray] = {}
        for index, entry in enumerate(self.datasetEntries):
            p2d, p3d = entry.map2d_3d(self.points3D_mapped, zipped=False, np=True)
            if len(p2d) == 0:
                out[index] = np.zeros(0)
                continue
            out[index] = entry.camera.compute_projection_errors_alt(
                p2d=p2d, p3d=p3d, loss_function=fn
            )
        return out

    # ---- stats -----------------------------------------------------------

    def num_3d_points(self) -> int:
        return len(self.points3D)

    def num_images(self) -> int:
        return len(self.datasetEntries)

    def avg_num_3d_points_per_image(self) -> float:
        return float(np.mean([e.num_3d_points for e in self.datasetEntries]))

    def avg_num_2d_points_per_image(self) -> float:
        return float(np.mean([e.num_2d_points for e in self.datasetEntries]))

    @property
    def images_path(self) -> str:
        if self.datasetEntries and self.datasetEntries[0].image_metadata.image_path:
            return str(Path(self.datasetEntries[0].image_metadata.image_path).parent)
        return ""

    def __deepcopy__(self, memodict):
        return Dataset(
            points3D=[
                Point3D(p.identifier, p.x, p.y, p.z, dict(p.metadata))
                for p in self.points3D
            ],
            datasetEntries=[
                DatasetEntry(
                    image_metadata=e.image_metadata,
                    points2D=[
                        Point2D(p.identifier, p.x, p.y, p.point3D_identifier, dict(p.metadata))
                        for p in e.points2D
                    ],
                    camera=copy.deepcopy(e.camera),
                )
                for e in self.datasetEntries
            ],
            name=self.name,
        )

    # ---- reduction -------------------------------------------------------

    def make_reduced_dataset(self, camera_limit: int, points_limit: int) -> "Dataset":
        """Cap cameras and per-camera 3D observations; keep only 3D points
        observed >= 2 times among the kept observations (semantics of
        reference dataset.py:172-201, computed on id arrays).

        Unlike the reference this returns a fully independent copy (the
        reference returned a shallow copy sharing point objects, flagged in
        its own warning string)."""
        entries = self.datasetEntries[:camera_limit]

        counts = Counter()
        kept_ids_per_entry = []
        for e in entries:
            pts = e.points_with_3d()[:points_limit]
            ids = [p.point3D_identifier for p in pts]
            kept_ids_per_entry.append(set(ids))
            counts.update(ids)
        surviving = {pid for pid, c in counts.items() if c >= 2}

        new_points = [
            Point3D(p.identifier, p.x, p.y, p.z, dict(p.metadata))
            for p in self.points3D
            if p.identifier in surviving
        ]
        new_entries = []
        for e, kept in zip(entries, kept_ids_per_entry):
            allowed = kept & surviving
            pts2d = []
            for p in e.points2D:
                pid = p.point3D_identifier
                keep_assoc = pid in allowed
                pts2d.append(
                    Point2D(p.identifier, p.x, p.y, pid if keep_assoc else None, dict(p.metadata))
                )
            new_entries.append(
                DatasetEntry(
                    image_metadata=e.image_metadata,
                    points2D=pts2d,
                    camera=copy.deepcopy(e.camera),
                )
            )
        return Dataset(points3D=new_points, datasetEntries=new_entries, name=self.name)

    def get_reduced_dataset_2d_ids_per_camera(
        self, cameras_limit: int, points_limit: int, as_list: bool = False
    ):
        """Per-camera lists of the Point2D ids a reduction would keep
        (reference dataset.py:203-218)."""
        entries = self.datasetEntries[:cameras_limit]
        counts = Counter()
        for e in entries:
            counts.update(
                p.point3D_identifier for p in e.points_with_3d()[:points_limit]
            )
        surviving = {pid for pid, c in counts.items() if c >= 2}
        res = {
            index: [
                p.identifier
                for p in e.points_with_3d()[:points_limit]
                if p.point3D_identifier in surviving
            ]
            for index, e in enumerate(entries)
        }
        return list(res.values()) if as_list else res
