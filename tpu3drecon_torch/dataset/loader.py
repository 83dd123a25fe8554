"""Object-level COLMAP dataset loading and export.

Counterpart of ``tpu3drecon/dataset/loader.py``: ``load_colmap_dataset``,
``load_colmap_cameras`` and ``export_in_colmap_format`` with the
reference's semantics (COLMAP poses enter as RH ("COLMAP") W2C,
SIMPLE_RADIAL collapses to a single focal, image sizes come from the
camera records, PIL only where a record lacks them).  The packed codec in
``tpu3drecon_torch.io.colmap`` does the parsing; this module builds and
consumes the object layer.  ``show_in_colmap`` / ``open_dataset_in_colmap``
need a ``colmap`` binary and raise JAX's ``RuntimeError`` without one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from tpu3drecon_torch.dataset.camera_pose import (
    CameraPose,
    CoordinateSystem,
    TransformationDirection,
)
from tpu3drecon_torch.dataset.model import (
    Camera,
    CameraIntrinsics,
    DatasetEntry,
    ImageMetadata,
    Point2D,
    Point3D,
    params_to_intrinsics,
)
from tpu3drecon_torch.dataset.scene import Dataset
from tpu3drecon_torch.geometry.rotations import matrix_to_quat
from tpu3drecon_torch.io import colmap as cio


def get_intrinsics(camera: cio.ColmapCamera) -> CameraIntrinsics:
    """Reference loader.py:32-41: PINHOLE family -> full intrinsics;
    SIMPLE_RADIAL keeps the single focal."""
    if camera.model == cio.CameraModelType.SIMPLE_RADIAL:
        f, _, cx, cy, _ = camera.intrinsics_tuple()
        return CameraIntrinsics(
            camera_intrinsics_matrix=np.array(
                [[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]]
            ),
            focal_length=f,
            skew_factor=0.0,
            center_x=cx,
            center_y=cy,
        )
    fx, fy, cx, cy, s = camera.intrinsics_tuple()
    return params_to_intrinsics(fx, fy, cx, cy, s if s else None)


def _image_size(camera: cio.ColmapCamera, image_path: Optional[str]):
    if camera.width > 0 and camera.height > 0:
        return camera.width, camera.height
    if image_path and os.path.exists(image_path):
        from PIL import Image

        with Image.open(image_path) as im:
            return im.size
    raise ValueError(f"cannot determine image size for camera {camera.camera_id}")


def _pose_of(model_images: cio.ColmapImages, row: int) -> CameraPose:
    q = model_images.qvecs[row]
    t = model_images.tvecs[row]
    pose = CameraPose.from_string_wxyz_quaternion_translation(
        " ".join(map(str, [*q, *t])),
        coordinate_system=CoordinateSystem.COLMAP,
        direction=TransformationDirection.W2C,  # COLMAP stores W2C
    )
    return pose


def load_colmap_dataset(
    path_to_sparse_folder: str,
    path_to_images: str = "",
    binary: bool = False,
    name: Optional[str] = None,
) -> Dataset:
    """Reference loader.py:137-150 with identical signature."""
    model = cio.read_model(path_to_sparse_folder, binary=binary)

    points3D = [
        Point3D(
            int(model.points.ids[i]),
            float(model.points.xyz[i, 0]),
            float(model.points.xyz[i, 1]),
            float(model.points.xyz[i, 2]),
            metadata={
                "rgb": model.points.rgb[i].copy(),
                "error": float(model.points.error[i]),
                "track_entries": list(zip(*model.points.track_of(i))),
            },
        )
        for i in range(len(model.points))
    ]

    entries = []
    for row in range(len(model.images)):
        name_row = model.images.names[row]
        image_path = os.path.join(path_to_images, name_row) if path_to_images else None
        cam_rec = model.cameras[int(model.images.camera_ids[row])]
        width, height = _image_size(cam_rec, image_path)
        xy, p3d_ids = model.images.points2d_of(row)
        points2D = [
            Point2D(j, float(xy[j, 0]), float(xy[j, 1]),
                    int(p3d_ids[j]) if p3d_ids[j] >= 0 else None, {})
            for j in range(len(xy))
        ]
        pose = _pose_of(model.images, row)
        pose.identifier = os.path.basename(name_row)
        entries.append(
            DatasetEntry(
                image_metadata=ImageMetadata(
                    identifier=name_row,
                    image_path=image_path,
                    width=width,
                    height=height,
                ),
                points2D=points2D,
                camera=Camera(
                    camera_pose=pose,
                    camera_intrinsics=get_intrinsics(cam_rec),
                    width=width,
                    height=height,
                ),
            )
        )
    return Dataset(points3D=points3D, datasetEntries=entries, name=name)


def load_colmap_cameras(
    path_to_sparse_folder: str, path_to_images: str = "", binary: bool = False
) -> Dict[int, Camera]:
    """Cameras-only variant (reference loader.py:126-134), keyed by image id —
    used to evaluate external-solver output without points."""
    model = cio.read_model(path_to_sparse_folder, binary=binary)
    cameras: Dict[int, Camera] = {}
    for row in range(len(model.images)):
        cam_rec = model.cameras[int(model.images.camera_ids[row])]
        name_row = model.images.names[row]
        image_path = os.path.join(path_to_images, name_row) if path_to_images else None
        width, height = _image_size(cam_rec, image_path)
        pose = _pose_of(model.images, row)
        pose.identifier = os.path.basename(name_row)
        cameras[int(model.images.image_ids[row])] = Camera(
            camera_pose=pose,
            camera_intrinsics=get_intrinsics(cam_rec),
            width=width,
            height=height,
        )
    return cameras


def export_in_colmap_format(ds: Dataset, output_path: str, binary: bool = False) -> None:
    """Reference loader.py:153-212: Dataset -> COLMAP model on disk, with 3D
    point tracks rebuilt from the 2D associations."""
    cameras: Dict[int, cio.ColmapCamera] = {}
    n = len(ds.datasetEntries)

    image_ids = np.arange(1, n + 1, dtype=np.int32)
    qvecs = np.zeros((n, 4))
    tvecs = np.zeros((n, 3))
    names = []
    xy_chunks, pid_chunks = [], []

    for k, entry in enumerate(ds.datasetEntries, start=1):
        intr = entry.camera.camera_intrinsics
        cameras[k] = cio.ColmapCamera(
            camera_id=k,
            model=cio.CameraModelType.PINHOLE,
            width=entry.camera.width,
            height=entry.camera.height,
            params=np.array(
                [intr.focal_x, intr.focal_y, intr.center_x, intr.center_y]
            ),
        )
        w2c = entry.camera.camera_pose.in_direction(TransformationDirection.W2C)
        qvecs[k - 1] = matrix_to_quat(torch.as_tensor(w2c.rotation)).numpy()
        tvecs[k - 1] = w2c.translation
        names.append(entry.image_metadata.identifier)
        xy_chunks.append(np.array([[p.x, p.y] for p in entry.points2D]).reshape(-1, 2))
        pid_chunks.append(
            np.array(
                [
                    p.point3D_identifier if p.point3D_identifier is not None else -1
                    for p in entry.points2D
                ],
                dtype=np.int64,
            )
        )

    counts = np.array([len(c) for c in xy_chunks], np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    images = cio.ColmapImages(
        image_ids=image_ids,
        qvecs=qvecs,
        tvecs=tvecs,
        camera_ids=image_ids.copy(),
        names=names,
        p2d_offsets=offsets,
        p2d_xy=np.concatenate(xy_chunks) if xy_chunks else np.zeros((0, 2)),
        p2d_point3d_ids=np.concatenate(pid_chunks) if pid_chunks else np.zeros(0, np.int64),
    )

    # Rebuild tracks: (image_id, local p2d index) pairs per 3D point.
    track_map: Dict[int, list] = {}
    for k, entry in enumerate(ds.datasetEntries, start=1):
        for j, p in enumerate(entry.points2D):
            if p.point3D_identifier is not None and p.point3D_identifier >= 0:
                track_map.setdefault(p.point3D_identifier, []).append((k, j))

    pts = ds.points3D
    track_counts = np.array([len(track_map.get(p.identifier, [])) for p in pts], np.int64)
    t_offsets = np.zeros(len(pts) + 1, np.int64)
    np.cumsum(track_counts, out=t_offsets[1:])
    timg, tidx = [], []
    for p in pts:
        for img_id, j in track_map.get(p.identifier, []):
            timg.append(img_id)
            tidx.append(j)
    points = cio.ColmapPoints(
        ids=np.array([p.identifier for p in pts], np.int64),
        xyz=np.array([[p.x, p.y, p.z] for p in pts]).reshape(-1, 3),
        rgb=np.array(
            [
                p.metadata.get("rgb") if p.metadata.get("rgb") is not None else [255, 255, 255]
                for p in pts
            ],
            np.uint8,
        ).reshape(-1, 3),
        error=np.array(
            [p.metadata.get("error", 999.0) for p in pts], np.float64
        ),
        track_offsets=t_offsets,
        track_image_ids=np.array(timg, np.int32),
        track_p2d_idxs=np.array(tidx, np.int32),
    )

    cio.write_model(
        cio.ColmapModel(cameras=cameras, images=images, points=points),
        output_path,
        binary=binary,
    )


def _colmap_binary() -> str:
    import shutil

    binary = shutil.which(os.environ.get("COLMAP_BIN", "colmap"))
    if binary is None:
        raise RuntimeError("colmap binary not found (set COLMAP_BIN)")
    return binary


def show_in_colmap(sparse_path: str, image_path: str,
                   database_path: Optional[str] = None,
                   block: bool = False):
    """Open a sparse model in the COLMAP GUI (reference loader.py:216-229);
    raises ``RuntimeError`` if the colmap binary isn't installed.  The
    database defaults to ``tpu3drecon_colmap.db`` in the temp directory."""
    import subprocess
    import tempfile

    binary = _colmap_binary()
    if database_path is None:
        database_path = os.path.join(tempfile.gettempdir(), "tpu3drecon_colmap.db")
    cmd = [binary, "gui", "--import_path", sparse_path,
           "--database_path", database_path, "--image_path", image_path]
    if block:
        return subprocess.run(cmd, stdout=subprocess.PIPE)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE)


def open_dataset_in_colmap(dataset: Dataset, output_path: Optional[str] = None):
    """Export a Dataset and open it in the COLMAP GUI (reference
    loader.py:232-239); the export goes to ``tpu3drecon_export`` in the
    temp directory unless ``output_path`` says otherwise, and nothing is
    written without a colmap binary."""
    import tempfile

    _colmap_binary()
    if output_path is None:
        output_path = os.path.join(tempfile.gettempdir(), "tpu3drecon_export")
    os.makedirs(output_path, exist_ok=True)
    export_in_colmap_format(dataset, output_path, binary=True)
    return show_in_colmap(output_path, dataset.images_path, block=True)
