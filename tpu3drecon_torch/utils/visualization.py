"""3D scene visualization exports: camera frusta and point clouds.

Counterpart of ``tpu3drecon/utils/visualization.py`` and of the
reference's Blender renderer (reference:
experiments/plot_reconstruction.py:70-161, which builds camera-frustum
meshes from K/R/t/width/height inside bpy).  The same geometry is written
as standard PLY and OBJ files that any viewer opens (MeshLab, Blender, the
COLMAP GUI), in host numpy, byte for byte as the JAX package writes them;
``plot_scene_matplotlib`` draws a 3D quick-look for reports and needs
matplotlib, which it imports when called.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def frustum_corners(
    rmat_w2c: np.ndarray,
    tvec_w2c: np.ndarray,
    k: np.ndarray,
    width: int,
    height: int,
    depth: float = 1.0,
) -> np.ndarray:
    """World-space corners of a camera frustum at given depth: returns
    (5, 3) = [center, tl, tr, br, bl] (same construction as the reference's
    plot_cameras, plot_reconstruction.py:70-118)."""
    kinv = np.linalg.inv(k)
    corners_px = np.array(
        [[0, 0, 1], [width, 0, 1], [width, height, 1], [0, height, 1]],
        dtype=np.float64,
    )
    rays = (kinv @ corners_px.T).T * depth  # camera-frame at depth
    r_c2w = rmat_w2c.T
    center = -r_c2w @ tvec_w2c
    world = rays @ r_c2w.T + center
    return np.vstack([center[None, :], world])


def write_ply_point_cloud(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    """ASCII PLY point cloud (colors uint8 optional)."""
    points = np.asarray(points).reshape(-1, 3)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            colors = np.asarray(colors).reshape(-1, 3).astype(np.uint8)
            for p, c in zip(points, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def write_obj_camera_frusta(
    path: str,
    rmats_w2c: np.ndarray,
    tvecs_w2c: np.ndarray,
    ks: np.ndarray,
    widths: Sequence[int],
    heights: Sequence[int],
    depth: float = 1.0,
) -> None:
    """OBJ wireframe of every camera frustum (lines center->corners + rim,
    the reference's make_line/plot_cameras geometry as line elements)."""
    with open(path, "w") as f:
        f.write("# tpu3drecon camera frusta\n")
        vert_base = 1
        for i in range(len(rmats_w2c)):
            corners = frustum_corners(
                rmats_w2c[i], tvecs_w2c[i], ks[i], widths[i], heights[i], depth
            )
            for v in corners:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            c, tl, tr, br, bl = range(vert_base, vert_base + 5)
            for a, b in [(c, tl), (c, tr), (c, br), (c, bl),
                         (tl, tr), (tr, br), (br, bl), (bl, tl)]:
                f.write(f"l {a} {b}\n")
            vert_base += 5


def export_scene(
    output_dir: str,
    points3d: np.ndarray,
    rmats_w2c: np.ndarray,
    tvecs_w2c: np.ndarray,
    ks: np.ndarray,
    widths: Sequence[int],
    heights: Sequence[int],
    colors: Optional[np.ndarray] = None,
    frustum_depth: float = 1.0,
) -> Tuple[str, str]:
    """Write <dir>/points.ply + <dir>/cameras.obj; returns both paths."""
    os.makedirs(output_dir, exist_ok=True)
    ply = os.path.join(output_dir, "points.ply")
    obj = os.path.join(output_dir, "cameras.obj")
    write_ply_point_cloud(ply, points3d, colors)
    write_obj_camera_frusta(
        obj, rmats_w2c, tvecs_w2c, ks, widths, heights, frustum_depth
    )
    return ply, obj


def export_dataset_scene(dataset, output_dir: str, frustum_depth: float = 1.0):
    """Export an object-level Dataset (``tpu3drecon_torch.dataset.Dataset``)."""
    from tpu3drecon_torch.dataset.camera_pose import TransformationDirection

    points = np.array([p.xyz for p in dataset.points3D]).reshape(-1, 3)
    colors = np.array(
        [
            p.metadata.get("rgb") if p.metadata.get("rgb") is not None else [200, 200, 200]
            for p in dataset.points3D
        ],
        dtype=np.uint8,
    ).reshape(-1, 3)
    rmats, tvecs, ks, ws, hs = [], [], [], [], []
    for e in dataset.datasetEntries:
        w2c = e.camera.camera_pose.in_direction(TransformationDirection.W2C)
        rmats.append(w2c.rotation)
        tvecs.append(w2c.translation)
        ks.append(e.camera.camera_intrinsics.camera_intrinsics_matrix)
        ws.append(e.camera.width)
        hs.append(e.camera.height)
    return export_scene(
        output_dir, points, np.stack(rmats), np.stack(tvecs), np.stack(ks),
        ws, hs, colors, frustum_depth,
    )


def plot_scene_matplotlib(
    points3d: np.ndarray,
    camera_centers: np.ndarray,
    path: str,
    title: str = "",
) -> str:
    """Static 3D quick-look (points + camera centers) for reports; raises
    ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    pts = np.asarray(points3d)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, alpha=0.4, label="points")
    cc = np.asarray(camera_centers)
    ax.scatter(cc[:, 0], cc[:, 1], cc[:, 2], s=40, marker="^", color="red", label="cameras")
    ax.set_title(title)
    ax.legend()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
