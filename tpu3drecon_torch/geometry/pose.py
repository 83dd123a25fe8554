"""Functional rigid-pose algebra with tagged coordinate-system semantics.

Counterpart of ``tpu3drecon/geometry/pose.py``: inverse, composition,
LH ("UNITY") <-> RH ("COLMAP") conversion by conjugation with
diag(1, -1, 1), and the camera-center and rotation-error metrics.  A pose
is the pair ``(rmat, tvec)``; the functions take any leading batch shape
(``(..., 3, 3)``, ``(..., 3)``), so each ``*_batch`` name is the same
function.  The object-level wrapper lives in
``tpu3drecon_torch.dataset.camera_pose``.
"""

from __future__ import annotations

import torch

# Conjugation matrix flipping the Y axis (LH Unity <-> RH COLMAP), a CPU
# float64 tensor (no device work at import).
CONVERSION_MATRIX = torch.tensor(
    [
        [1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
    ],
    dtype=torch.float64,
)


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix times vector over the leading batch shape."""
    return torch.matmul(m, v[..., None])[..., 0]


def pose_inverse(rmat: torch.Tensor, tvec: torch.Tensor):
    """(R, t) -> (R^T, -R^T t): flips C2W <-> W2C."""
    rinv = _t(rmat)
    return rinv, -_mv(rinv, tvec)


def pose_compose(rmat_a, tvec_a, rmat_b, tvec_b):
    """Compose transforms: (a . b)(x) = a(b(x))."""
    return torch.matmul(rmat_a, rmat_b), _mv(rmat_a, tvec_b) + tvec_a


def pose_convert_coordinate_system(rmat: torch.Tensor, tvec: torch.Tensor):
    """Conjugate a pose with diag(1, -1, 1) (LH <-> RH, involutive):
    R' = C R C, t' = C t."""
    conv = CONVERSION_MATRIX.to(dtype=rmat.dtype, device=rmat.device)
    return torch.matmul(torch.matmul(conv, rmat), conv), _mv(conv, tvec)


def pose_apply(rmat: torch.Tensor, tvec: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply a pose to 3D point(s): R x + t (xyz may have leading batch
    dims)."""
    return torch.matmul(xyz, _t(rmat)) + tvec


def pose_to_matrix_3x4(rmat: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """[R | t]."""
    return torch.cat([rmat, tvec[..., None]], dim=-1)


def pose_to_matrix_4x4(rmat: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """Homogeneous 4x4 transform."""
    top = pose_to_matrix_3x4(rmat, tvec)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rmat.dtype, device=rmat.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)


def camera_center(rmat_w2c: torch.Tensor, tvec_w2c: torch.Tensor) -> torch.Tensor:
    """World-frame camera center of a W2C pose: -R^T t."""
    return -_mv(_t(rmat_w2c), tvec_w2c)


def rotation_geodesic_angle(rmat_a: torch.Tensor, rmat_b: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between two rotations, safe at 0 and pi."""
    rel = torch.matmul(_t(rmat_a), rmat_b)
    cos = (torch.diagonal(rel, dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def rotation_identity_error(rmat_a: torch.Tensor, rmat_b: torch.Tensor) -> torch.Tensor:
    """Frobenius distance of the relative rotation from identity."""
    rel = torch.matmul(_t(rmat_a), rmat_b)
    eye = torch.eye(3, dtype=rmat_a.dtype, device=rmat_a.device)
    return torch.linalg.matrix_norm(rel - eye)


def position_error(center_a: torch.Tensor, center_b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between camera centers."""
    return torch.linalg.vector_norm(center_a - center_b, dim=-1)


# Batched forms over a leading camera axis: the functions above broadcast.
pose_inverse_batch = pose_inverse
pose_convert_coordinate_system_batch = pose_convert_coordinate_system
pose_to_matrix_3x4_batch = pose_to_matrix_3x4
camera_center_batch = camera_center
rotation_geodesic_angle_batch = rotation_geodesic_angle
