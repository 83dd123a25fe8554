"""Rotation algebra: skew matrices and the Rodrigues map, batched.

Counterpart of ``tpu3drecon/geometry/rotations.py:25-60``.  The JAX
functions act on one element and are vmapped; these take any leading batch
shape (``(..., 3)`` vectors).
"""

from __future__ import annotations

import torch


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
    theta2 = torch.sum(rvec * rvec, dim=-1)
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
    return eye + a[..., None, None] * k + b[..., None, None] * kk
