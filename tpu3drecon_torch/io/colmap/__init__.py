"""COLMAP sparse-model I/O: packed CSR records, binary and text codecs.

Counterpart of ``tpu3drecon/io/colmap/__init__.py`` (the same public
names); the object-level Dataset loader lives in
``tpu3drecon_torch.dataset``.
"""

from __future__ import annotations

import os

from tpu3drecon_torch.io.colmap.binary import (
    read_cameras_bin,
    read_images_bin,
    read_model_bin,
    read_points3d_bin,
    write_cameras_bin,
    write_images_bin,
    write_model_bin,
    write_points3d_bin,
)
from tpu3drecon_torch.io.colmap.records import (
    CAMERA_MODEL_NUM_PARAMS,
    INVALID_POINT3D_ID,
    CameraModelType,
    ColmapCamera,
    ColmapImages,
    ColmapModel,
    ColmapPoints,
    empty_images,
    empty_points,
)
from tpu3drecon_torch.io.colmap.text import (
    read_cameras_txt,
    read_images_txt,
    read_model_txt,
    read_points3d_txt,
    write_cameras_txt,
    write_images_txt,
    write_model_txt,
    write_points3d_txt,
)


def read_model(sparse_dir: str, binary: bool | None = None) -> ColmapModel:
    """Read a COLMAP sparse model, auto-detecting bin vs txt if unspecified."""
    if binary is None:
        binary = os.path.exists(os.path.join(sparse_dir, "cameras.bin"))
    return read_model_bin(sparse_dir) if binary else read_model_txt(sparse_dir)


def write_model(model: ColmapModel, sparse_dir: str, binary: bool = True) -> None:
    if binary:
        write_model_bin(model, sparse_dir)
    else:
        write_model_txt(model, sparse_dir)
