"""Rotation algebra: Rodrigues vectors, quaternions, rotation matrices.

Counterpart of ``tpu3drecon/geometry/rotations.py``.  The JAX functions
act on one element and are vmapped into their ``*_batch`` forms; these
take any leading batch shape (``(..., 3)`` vectors, ``(..., 4)`` wxyz
quaternions, ``(..., 3, 3)`` matrices), so each ``*_batch`` name is the
same function.  The double-``where`` guards are kept, so that
``torch.func.jacfwd`` gives finite tangents at theta = 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices: skew(v) @ w = v x w."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vectors -> (..., 3, 3) rotation matrices.

    R = I + A [r]_x + B [r]_x^2 with A = sin(t)/t, B = (1-cos(t))/t^2,
    Taylor-expanded where theta^2 < 1e-8 so the map is finite at zero.
    """
    dtype = rvec.dtype
    # (..., 1, 1), never a 0-dim tensor: forward-mode AD (torch 2.13)
    # promotes the tangent of a 0-dim float32 tensor times a Python float
    # to float64, which then breaks the float32 products downstream.
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe
    )
    k = skew(rvec)
    kk = torch.matmul(k, k)
    eye = torch.eye(3, dtype=dtype, device=rvec.device)
    return eye + a * k + b * kk


def matrix_to_quat(rmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) unit quaternions (wxyz),
    w >= 0.

    Branch-free Shepperd construction: all four candidate quaternions, the
    one seeded from the largest of (1+tr, 1+2R00-tr, ...) selected; ties
    go to the first index, as ``jnp.argmax`` breaks them.
    """
    m = rmat
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    # 4 * [w^2, x^2, y^2, z^2] (before clamping).
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    seeds = torch.stack([tw, tx, ty, tz], dim=-1)

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    sw, sx, sy, sz = safe_sqrt(tw), safe_sqrt(tx), safe_sqrt(ty), safe_sqrt(tz)
    cand = torch.stack(
        [
            torch.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], dim=-1)
            / (2.0 * sw)[..., None],
            torch.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], dim=-1)
            / (2.0 * sx)[..., None],
            torch.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], dim=-1)
            / (2.0 * sy)[..., None],
            torch.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], dim=-1)
            / (2.0 * sz)[..., None],
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    pick = torch.argmax(seeds, dim=-1)  # the first index of the largest
    q = torch.take_along_dim(cand, pick[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (wxyz) -> (..., 3, 3) rotation matrices."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def quat_to_rodrigues(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (wxyz) -> (..., 3) Rodrigues vectors, safe
    near identity."""
    q = torch.where(q[..., :1] < 0, -q, q)  # w >= 0 => angle in [0, pi]
    w = q[..., :1]  # (..., 1): no 0-dim tensors (see rodrigues_to_matrix)
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1e-12
    one = torch.ones_like(n2)
    n = torch.sqrt(torch.where(small, one, n2))
    w_safe = torch.where(small, w, one)  # w can be 0 at theta = pi
    angle = 2.0 * torch.atan2(n, w)
    # rvec = angle * v / n; near identity angle/n -> 2/w - 2 n^2/(3 w^3).
    scale = torch.where(
        small, 2.0 / w_safe - 2.0 * n2 / (3.0 * w_safe**3), angle / n
    )
    return scale * v


def rodrigues_to_quat(rvec: torch.Tensor) -> torch.Tensor:
    """(..., 3) Rodrigues vectors -> (..., 4) unit quaternions (wxyz), safe
    near zero."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)  # (..., 1)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    # sin(t/2)/t, Taylor: 1/2 - t^2/48.
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, s * rvec], dim=-1)


def matrix_to_rodrigues(rmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) Rodrigues vectors, through
    the quaternion for stability at theta ~ 0 and theta ~ pi."""
    return quat_to_rodrigues(matrix_to_quat(rmat))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) unit quaternions (wxyz) without
    forming the matrix."""
    u = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


# Batched (leading-axis) forms: the functions above broadcast already.
rodrigues_to_matrix_batch = rodrigues_to_matrix
matrix_to_rodrigues_batch = matrix_to_rodrigues
quat_to_matrix_batch = quat_to_matrix
matrix_to_quat_batch = matrix_to_quat
rodrigues_to_quat_batch = rodrigues_to_quat
quat_to_rodrigues_batch = quat_to_rodrigues
