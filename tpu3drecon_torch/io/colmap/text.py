"""COLMAP text sparse-model reader/writer (cameras/images/points3D .txt).

Counterpart of ``tpu3drecon/io/colmap/text.py``: the public COLMAP text
layout read into and written from the packed CSR records, with the same
float formatting (``repr``), so both packages write the same bytes for the
same records.  Bin and txt paths of the same model parse to identical
records.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from tpu3drecon_torch.io.colmap.records import (
    CAMERA_MODEL_NUM_PARAMS,
    ColmapCamera,
    ColmapImages,
    ColmapModel,
    ColmapPoints,
    CameraModelType,
)


def _data_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cameras: Dict[int, ColmapCamera] = {}
    for ln in _data_lines(path):
        parts = ln.split()
        camera_id = int(parts[0])
        model = CameraModelType[parts[1]]
        width, height = int(parts[2]), int(parts[3])
        params = np.array([float(p) for p in parts[4:]], dtype=np.float64)
        if len(params) != CAMERA_MODEL_NUM_PARAMS[model]:
            raise ValueError(
                f"camera {camera_id}: {model.name} expects "
                f"{CAMERA_MODEL_NUM_PARAMS[model]} params, got {len(params)}"
            )
        cameras[camera_id] = ColmapCamera(camera_id, model, width, height, params)
    return cameras


def read_images_txt(path: str) -> ColmapImages:
    lines = _data_lines(path)
    # Two lines per image: header then keypoint triplets (possibly empty — but
    # COLMAP always writes the second line, even when blank, so pair by parity
    # of *raw* lines; blank keypoint lines were stripped, so re-read raw.
    with open(path) as f:
        raw = [ln.rstrip("\n") for ln in f if not ln.lstrip().startswith("#")]
    image_ids, qvecs, tvecs, camera_ids, names = [], [], [], [], []
    counts, xy_chunks, id_chunks = [], [], []
    i = 0
    while i < len(raw):
        if not raw[i].strip():
            i += 1
            continue
        head = raw[i].split()
        image_ids.append(int(head[0]))
        qvecs.append([float(x) for x in head[1:5]])
        tvecs.append([float(x) for x in head[5:8]])
        camera_ids.append(int(head[8]))
        names.append(" ".join(head[9:]))
        pts = raw[i + 1].split() if i + 1 < len(raw) else []
        i += 2
        n = len(pts) // 3
        counts.append(n)
        if n:
            arr = np.array(pts, dtype=np.float64).reshape(n, 3)
            xy_chunks.append(arr[:, :2])
            id_chunks.append(arr[:, 2].astype(np.int64))

    offsets = np.zeros(len(image_ids) + 1, np.int64)
    np.cumsum(np.array(counts, np.int64), out=offsets[1:])
    return ColmapImages(
        image_ids=np.array(image_ids, np.int32),
        qvecs=np.array(qvecs, np.float64).reshape(-1, 4),
        tvecs=np.array(tvecs, np.float64).reshape(-1, 3),
        camera_ids=np.array(camera_ids, np.int32),
        names=names,
        p2d_offsets=offsets,
        p2d_xy=np.concatenate(xy_chunks) if xy_chunks else np.zeros((0, 2)),
        p2d_point3d_ids=np.concatenate(id_chunks) if id_chunks else np.zeros(0, np.int64),
    )


def read_points3d_txt(path: str) -> ColmapPoints:
    lines = _data_lines(path)
    ids, xyz, rgb, error = [], [], [], []
    counts, img_chunks, idx_chunks = [], [], []
    for ln in lines:
        parts = ln.split()
        ids.append(int(parts[0]))
        xyz.append([float(x) for x in parts[1:4]])
        rgb.append([int(x) for x in parts[4:7]])
        error.append(float(parts[7]))
        track = np.array(parts[8:], dtype=np.int64).reshape(-1, 2)
        counts.append(len(track))
        if len(track):
            img_chunks.append(track[:, 0].astype(np.int32))
            idx_chunks.append(track[:, 1].astype(np.int32))
    offsets = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(np.array(counts, np.int64), out=offsets[1:])
    return ColmapPoints(
        ids=np.array(ids, np.int64),
        xyz=np.array(xyz, np.float64).reshape(-1, 3),
        rgb=np.array(rgb, np.uint8).reshape(-1, 3),
        error=np.array(error, np.float64),
        track_offsets=offsets,
        track_image_ids=np.concatenate(img_chunks) if img_chunks else np.zeros(0, np.int32),
        track_p2d_idxs=np.concatenate(idx_chunks) if idx_chunks else np.zeros(0, np.int32),
    )


def _fmt(x: float) -> str:
    return repr(float(x))


def write_cameras_txt(cameras: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(_fmt(p) for p in cam.params)
            f.write(f"{cam.camera_id} {cam.model.name} {cam.width} {cam.height} {params}\n")


def write_images_txt(images: ColmapImages, path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(len(images)):
            q = " ".join(_fmt(x) for x in images.qvecs[i])
            t = " ".join(_fmt(x) for x in images.tvecs[i])
            f.write(
                f"{int(images.image_ids[i])} {q} {t} "
                f"{int(images.camera_ids[i])} {images.names[i]}\n"
            )
            xy, p3d_ids = images.points2d_of(i)
            triplets = " ".join(
                f"{_fmt(xy[j, 0])} {_fmt(xy[j, 1])} {int(p3d_ids[j])}"
                for j in range(len(xy))
            )
            f.write(triplets + "\n")


def write_points3d_txt(points: ColmapPoints, path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for i in range(len(points)):
            xyz = " ".join(_fmt(x) for x in points.xyz[i])
            rgb = " ".join(str(int(x)) for x in points.rgb[i])
            img_ids, p2d_idxs = points.track_of(i)
            track = " ".join(
                f"{int(img_ids[j])} {int(p2d_idxs[j])}" for j in range(len(img_ids))
            )
            f.write(f"{int(points.ids[i])} {xyz} {rgb} {_fmt(points.error[i])} {track}\n")


def read_model_txt(sparse_dir: str) -> ColmapModel:
    return ColmapModel(
        cameras=read_cameras_txt(os.path.join(sparse_dir, "cameras.txt")),
        images=read_images_txt(os.path.join(sparse_dir, "images.txt")),
        points=read_points3d_txt(os.path.join(sparse_dir, "points3D.txt")),
    )


def write_model_txt(model: ColmapModel, sparse_dir: str) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_txt(model.cameras, os.path.join(sparse_dir, "cameras.txt"))
    write_images_txt(model.images, os.path.join(sparse_dir, "images.txt"))
    write_points3d_txt(model.points, os.path.join(sparse_dir, "points3D.txt"))
