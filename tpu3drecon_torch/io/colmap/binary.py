"""COLMAP binary sparse-model reader/writer (cameras/images/points3D .bin).

Counterpart of ``tpu3drecon/io/colmap/binary.py``: the public COLMAP
binary wire format, decoded with structured-dtype ``np.frombuffer`` slices
into the packed CSR records of ``records.py``, and written byte for byte
as the JAX package writes it.  ``read_images_bin`` / ``read_points3d_bin``
take the C++ parser (``native.py``) when its library builds, the numpy
path otherwise or with ``use_native=False``; ``native.COUNTS`` records
which one parsed each file.
"""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

from tpu3drecon_torch.io.colmap import native
from tpu3drecon_torch.io.colmap.records import (
    CAMERA_MODEL_NUM_PARAMS,
    ColmapCamera,
    ColmapImages,
    ColmapModel,
    ColmapPoints,
    CameraModelType,
)

_INVALID_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# One 2D keypoint record inside images.bin: x, y (f64) + point3D id (i64).
_P2D_DTYPE = np.dtype([("x", "<f8"), ("y", "<f8"), ("p3d_id", "<i8")])
# One track element inside points3D.bin: image id + point2D index (i32).
_TRACK_DTYPE = np.dtype([("image_id", "<i4"), ("p2d_idx", "<i4")])
# Fixed-size head of one points3D.bin record.
_P3D_HEAD = struct.Struct("<Qddd3BdQ")


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras: Dict[int, ColmapCamera] = {}
    for _ in range(num):
        camera_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        model = CameraModelType(model_id)
        n_params = CAMERA_MODEL_NUM_PARAMS[model]
        params = np.frombuffer(buf, dtype="<f8", count=n_params, offset=off).copy()
        off += 8 * n_params
        cameras[camera_id] = ColmapCamera(
            camera_id=camera_id,
            model=model,
            width=int(width),
            height=int(height),
            params=params,
        )
    return cameras


def read_images_bin(path: str, use_native: bool = True) -> ColmapImages:
    if use_native and os.environ.get("TPU3DRECON_NO_NATIVE") != "1":
        out = native.read_images_bin_native(path)
        if out is not None:
            return out
    native.COUNTS.count("numpy", "images")
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8

    image_ids = np.empty(num, np.int32)
    qvecs = np.empty((num, 4), np.float64)
    tvecs = np.empty((num, 3), np.float64)
    camera_ids = np.empty(num, np.int32)
    names = []
    p2d_counts = np.empty(num, np.int64)
    p2d_chunks = []

    header = struct.Struct("<i4d3di")
    for i in range(num):
        vals = header.unpack_from(buf, off)
        off += header.size
        image_ids[i] = vals[0]
        qvecs[i] = vals[1:5]
        tvecs[i] = vals[5:8]
        camera_ids[i] = vals[8]
        end = buf.index(b"\x00", off)
        names.append(buf[off:end].decode("utf-8"))
        off = end + 1
        (n_p2d,) = struct.unpack_from("<Q", buf, off)
        off += 8
        chunk = np.frombuffer(buf, dtype=_P2D_DTYPE, count=n_p2d, offset=off)
        off += _P2D_DTYPE.itemsize * n_p2d
        p2d_counts[i] = n_p2d
        p2d_chunks.append(chunk)

    offsets = np.zeros(num + 1, np.int64)
    np.cumsum(p2d_counts, out=offsets[1:])
    if p2d_chunks:
        all_p2d = np.concatenate([np.asarray(c) for c in p2d_chunks])
    else:
        all_p2d = np.zeros(0, _P2D_DTYPE)
    xy = np.stack([all_p2d["x"], all_p2d["y"]], axis=1) if len(all_p2d) else np.zeros((0, 2))
    p3d_ids = all_p2d["p3d_id"].copy() if len(all_p2d) else np.zeros(0, np.int64)
    # Normalize COLMAP's uint64-max "no point" sentinel (reference
    # images.py:47-52 does the same check) to -1.  Reinterpreting the i64
    # view: the sentinel already reads as -1 in two's complement.
    return ColmapImages(
        image_ids=image_ids,
        qvecs=qvecs,
        tvecs=tvecs,
        camera_ids=camera_ids,
        names=names,
        p2d_offsets=offsets,
        p2d_xy=np.ascontiguousarray(xy),
        p2d_point3d_ids=p3d_ids,
    )


def read_points3d_bin(path: str, use_native: bool = True) -> ColmapPoints:
    if use_native and os.environ.get("TPU3DRECON_NO_NATIVE") != "1":
        out = native.read_points3d_bin_native(path)
        if out is not None:
            return out
    native.COUNTS.count("numpy", "points3d")
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8

    ids = np.empty(num, np.int64)
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    error = np.empty(num, np.float64)
    track_counts = np.empty(num, np.int64)
    track_chunks = []

    for i in range(num):
        vals = _P3D_HEAD.unpack_from(buf, off)
        off += _P3D_HEAD.size
        ids[i] = vals[0]
        xyz[i] = vals[1:4]
        rgb[i] = vals[4:7]
        error[i] = vals[7]
        n_track = vals[8]
        chunk = np.frombuffer(buf, dtype=_TRACK_DTYPE, count=n_track, offset=off)
        off += _TRACK_DTYPE.itemsize * n_track
        track_counts[i] = n_track
        track_chunks.append(chunk)

    offsets = np.zeros(num + 1, np.int64)
    np.cumsum(track_counts, out=offsets[1:])
    if track_chunks:
        all_track = np.concatenate([np.asarray(c) for c in track_chunks])
    else:
        all_track = np.zeros(0, _TRACK_DTYPE)
    return ColmapPoints(
        ids=ids,
        xyz=xyz,
        rgb=rgb,
        error=error,
        track_offsets=offsets,
        track_image_ids=all_track["image_id"].copy() if len(all_track) else np.zeros(0, np.int32),
        track_p2d_idxs=all_track["p2d_idx"].copy() if len(all_track) else np.zeros(0, np.int32),
    )


def write_cameras_bin(cameras: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(
                struct.pack(
                    "<iiQQ", cam.camera_id, int(cam.model), cam.width, cam.height
                )
            )
            f.write(np.asarray(cam.params, dtype="<f8").tobytes())


def write_images_bin(images: ColmapImages, path: str) -> None:
    header = struct.Struct("<i4d3di")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for i in range(len(images)):
            f.write(
                header.pack(
                    int(images.image_ids[i]),
                    *images.qvecs[i],
                    *images.tvecs[i],
                    int(images.camera_ids[i]),
                )
            )
            f.write(images.names[i].encode("utf-8") + b"\x00")
            xy, p3d_ids = images.points2d_of(i)
            f.write(struct.pack("<Q", len(xy)))
            rec = np.empty(len(xy), _P2D_DTYPE)
            rec["x"] = xy[:, 0]
            rec["y"] = xy[:, 1]
            rec["p3d_id"] = p3d_ids  # -1 round-trips as the u64 sentinel
            f.write(rec.tobytes())


def write_points3d_bin(points: ColmapPoints, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for i in range(len(points)):
            img_ids, p2d_idxs = points.track_of(i)
            f.write(
                _P3D_HEAD.pack(
                    int(points.ids[i]),
                    *points.xyz[i],
                    *points.rgb[i].astype(np.uint8),
                    float(points.error[i]),
                    len(img_ids),
                )
            )
            rec = np.empty(len(img_ids), _TRACK_DTYPE)
            rec["image_id"] = img_ids
            rec["p2d_idx"] = p2d_idxs
            f.write(rec.tobytes())


def read_model_bin(sparse_dir: str) -> ColmapModel:
    return ColmapModel(
        cameras=read_cameras_bin(os.path.join(sparse_dir, "cameras.bin")),
        images=read_images_bin(os.path.join(sparse_dir, "images.bin")),
        points=read_points3d_bin(os.path.join(sparse_dir, "points3D.bin")),
    )


def write_model_bin(model: ColmapModel, sparse_dir: str) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_bin(model.cameras, os.path.join(sparse_dir, "cameras.bin"))
    write_images_bin(model.images, os.path.join(sparse_dir, "images.bin"))
    write_points3d_bin(model.points, os.path.join(sparse_dir, "points3D.bin"))
