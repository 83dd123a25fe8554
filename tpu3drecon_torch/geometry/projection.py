"""Pinhole + polynomial-radial projection and residuals.

Counterpart of ``tpu3drecon/geometry/projection.py``.  Intrinsics are
K = [[fx, skew, cx], [0, fy, cy], [0, 0, 1]] with a per-camera radial
pair ``dist = (k1, k2)`` on normalized coordinates:

    m  = (x/z, y/z)
    m' = (1 + k1 |m|^2 + k2 |m|^4) * m
    (u, v) = K2 m' + (cx, cy)

The JAX functions act on one camera and one point and are vmapped; these
broadcast over leading axes: ``project_point`` takes any shapes that
broadcast (camera ``(..., 3, 3)``, point ``(..., 3)``), ``project_points``
one camera and ``(N, 3)`` points, ``project_points_batched`` ``B`` cameras
and their own ``(B, N, 3)`` point sets.
"""

from __future__ import annotations

import torch


def make_intrinsics_matrix(fx_fy: torch.Tensor, cx_cy_skew: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) K from optimizable (fx, fy) and frozen (cx, cy, skew)."""
    z = torch.zeros_like(fx_fy[..., 0])
    o = torch.ones_like(z)
    return torch.stack(
        [
            torch.stack([fx_fy[..., 0], cx_cy_skew[..., 2], cx_cy_skew[..., 0]], dim=-1),
            torch.stack([z, fx_fy[..., 1], cx_cy_skew[..., 1]], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def world_to_camera(rmat: torch.Tensor, tvec: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """World points -> camera-frame points for W2C extrinsics (R, t)."""
    return torch.matmul(rmat, xyz[..., None])[..., 0] + tvec


def radial_factor(m: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Polynomial radial scale s(m) = 1 + k1 r^2 + k2 r^4 on normalized m."""
    r2 = torch.sum(m * m, dim=-1)
    return 1.0 + dist[..., 0] * r2 + dist[..., 1] * r2 * r2


def perspective_project(
    xyz_cam: torch.Tensor, fx_fy: torch.Tensor, cx_cy_skew: torch.Tensor,
    dist: torch.Tensor,
) -> torch.Tensor:
    """Camera-frame points -> pixel coordinates (perspective divide + radial).

    The divide is guarded (the ``z_safe`` of ``ops/jacobians.py``): padded
    rows carry (0, 0, 0) points whose z would otherwise give inf, and
    inf * 0-mask = NaN would poison a batched loss.
    """
    z = xyz_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
    inv_z = 1.0 / z_safe
    m = xyz_cam[..., :2] * inv_z[..., None]
    md = radial_factor(m, dist)[..., None] * m
    u = fx_fy[..., 0] * md[..., 0] + cx_cy_skew[..., 2] * md[..., 1] + cx_cy_skew[..., 0]
    v = fx_fy[..., 1] * md[..., 1] + cx_cy_skew[..., 1]
    return torch.stack([u, v], dim=-1)


def project_point(
    rmat: torch.Tensor,
    tvec: torch.Tensor,
    fx_fy: torch.Tensor,
    cx_cy_skew: torch.Tensor,
    dist: torch.Tensor,
    xyz: torch.Tensor,
) -> torch.Tensor:
    """Full projection of world points through W2C cameras (broadcasting)."""
    return perspective_project(world_to_camera(rmat, tvec, xyz), fx_fy, cx_cy_skew, dist)


def project_points(rmat, tvec, fx_fy, cx_cy_skew, dist, points3d) -> torch.Tensor:
    """One camera, (N, 3) points -> (N, 2) pixels."""
    return project_point(rmat, tvec, fx_fy, cx_cy_skew, dist, points3d)


def project_points_batched(rmat, tvec, fx_fy, cx_cy_skew, dist, points3d) -> torch.Tensor:
    """B cameras, (B, N, 3) points (each camera its own set) -> (B, N, 2):
    (B,3,3),(B,3),(B,2),(B,3),(B,2),(B,N,3)."""
    return project_point(
        rmat[:, None], tvec[:, None], fx_fy[:, None], cx_cy_skew[:, None],
        dist[:, None], points3d,
    )


def reprojection_residuals(
    rmat: torch.Tensor,
    tvec: torch.Tensor,
    fx_fy: torch.Tensor,
    cx_cy_skew: torch.Tensor,
    dist: torch.Tensor,
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Masked per-axis reprojection residuals (N, 2) for one camera; padded
    entries (mask == 0) give exact zeros."""
    projected = project_points(rmat, tvec, fx_fy, cx_cy_skew, dist, points3d)
    return (projected - points2d) * mask[..., None]
