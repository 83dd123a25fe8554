"""Analytic per-observation residual/Jacobian blocks for bundle adjustment.

Counterpart of ``tpu3drecon/ops/jacobians.py:36-175``.  Each observation
produces closed-form blocks

    r      (2,)    whitened reprojection residual
    J_cam  (2, 8)  d r / d [so3 delta(3) | dt(3) | dfx, dfy]
    J_pt   (2, 3)  d r / d point

under the left-multiplicative SE(3) local parameterization
X_c' = exp([delta]_x) (R X + t) + dt.  The JAX version vmaps a
single-observation function; here every function takes a batch axis.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu3drecon_torch.geometry.losses import RobustLoss, robust_weight
from tpu3drecon_torch.geometry.rotations import rodrigues_to_matrix


class ObsBlocks(NamedTuple):
    residual: torch.Tensor  # (N, 2) whitened residual
    j_cam: torch.Tensor  # (N, 2, 8) whitened camera block
    j_pt: torch.Tensor  # (N, 2, 3) whitened point block


def obs_blocks(
    rmat: torch.Tensor,  # (N, 3, 3) W2C of each obs's camera
    tvec: torch.Tensor,  # (N, 3)
    fx_fy: torch.Tensor,  # (N, 2)
    cx_cy_skew: torch.Tensor,  # (N, 3)
    dist: torch.Tensor,  # (N, 2) radial (k1, k2); (0, 0) = pinhole
    xyz: torch.Tensor,  # (N, 3) world points
    uv: torch.Tensor,  # (N, 2) observations
    mask: torch.Tensor,  # (N,) 1.0 real / 0.0 padding
    inv_width,  # () 1 / avg_cam_width residual scale
    loss: RobustLoss = RobustLoss.TRIVIAL,
) -> ObsBlocks:
    """Residual + analytic Jacobian blocks for a batch of observations.

    Whitening sqrt(w(s)) * mask * inv_width multiplies the residual and the
    J rows, so masked (padding) rows contribute exact zeros.  Radial
    distortion enters as A = s I + (2 k1 + 4 k2 r^2) m m^T between K2 and
    the perspective-divide Jacobian.
    """
    xc = torch.matmul(rmat, xyz[..., None])[..., 0] + tvec
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.ones_like(z), z)
    inv_z = 1.0 / z_safe
    fx, fy = fx_fy[:, 0], fx_fy[:, 1]
    sk = cx_cy_skew[:, 2]
    k1, k2 = dist[:, 0], dist[:, 1]

    mx, my = x * inv_z, y * inv_z
    r2 = mx * mx + my * my
    s_rad = 1.0 + k1 * r2 + k2 * r2 * r2
    g_rad = 2.0 * k1 + 4.0 * k2 * r2
    mdx, mdy = s_rad * mx, s_rad * my

    u = fx * mdx + sk * mdy + cx_cy_skew[:, 0]
    v = fy * mdy + cx_cy_skew[:, 1]
    r = torch.stack([u, v], dim=-1) - uv

    s = torch.sum(r * r, dim=-1)
    w = robust_weight(loss, s)
    scale = torch.sqrt(w) * mask * inv_width

    a00 = s_rad + g_rad * mx * mx
    a01 = g_rad * mx * my
    a11 = s_rad + g_rad * my * my
    b00 = a00 * inv_z
    b01 = a01 * inv_z
    b02 = -(a00 * mx + a01 * my) * inv_z
    b10 = a01 * inv_z
    b11 = a11 * inv_z
    b12 = -(a01 * mx + a11 * my) * inv_z
    dpi = torch.stack(
        [
            torch.stack(
                [fx * b00 + sk * b10, fx * b01 + sk * b11, fx * b02 + sk * b12],
                dim=-1,
            ),
            torch.stack([fy * b10, fy * b11, fy * b12], dim=-1),
        ],
        dim=-2,
    )  # (N, 2, 3)

    zero = torch.zeros_like(x)
    neg_skew_xc = torch.stack(
        [
            torch.stack([zero, z, -y], dim=-1),
            torch.stack([-z, zero, x], dim=-1),
            torch.stack([y, -x, zero], dim=-1),
        ],
        dim=-2,
    )  # == -[X_c]_x
    j_rot = torch.matmul(dpi, neg_skew_xc)
    j_f = torch.stack(
        [torch.stack([mdx, zero], dim=-1), torch.stack([zero, mdy], dim=-1)],
        dim=-2,
    )
    j_cam = torch.cat([j_rot, dpi, j_f], dim=-1)  # (N, 2, 8)
    j_pt = torch.matmul(dpi, rmat)  # (N, 2, 3)
    sc = scale[:, None]
    return ObsBlocks(
        residual=r * sc, j_cam=j_cam * sc[..., None], j_pt=j_pt * sc[..., None]
    )


def gather_obs_blocks(
    rmats: torch.Tensor,  # (C, 3, 3)
    tvecs: torch.Tensor,  # (C, 3)
    fx_fy: torch.Tensor,  # (C, 2)
    cx_cy_skew: torch.Tensor,  # (C, 3)
    dist: torch.Tensor,  # (C, 2)
    points3d: torch.Tensor,  # (P, 3)
    cam_idx: torch.Tensor,  # (N,)
    pt_idx: torch.Tensor,  # (N,)
    uv: torch.Tensor,  # (N, 2)
    mask: torch.Tensor,  # (N,)
    inv_width,  # ()
    loss: RobustLoss = RobustLoss.TRIVIAL,
) -> ObsBlocks:
    """Blocks for a flat observation list (gathers by index)."""
    ci = cam_idx.long()
    return obs_blocks(
        rmats[ci], tvecs[ci], fx_fy[ci], cx_cy_skew[ci], dist[ci],
        points3d[pt_idx.long()], uv, mask, inv_width, loss,
    )


def apply_se3_retraction(
    rmats: torch.Tensor,  # (C, 3, 3)
    tvecs: torch.Tensor,  # (C, 3)
    fx_fy: torch.Tensor,  # (C, 2)
    step_cam: torch.Tensor,  # (C, 8) [delta | dt | dfx, dfy]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left-multiplicative retraction matching the obs_blocks linearization:
    R <- exp([delta]_x) R,  t <- exp([delta]_x) t + dt,  f <- f + df."""
    dr = rodrigues_to_matrix(step_cam[:, :3])
    new_r = torch.matmul(dr, rmats)
    new_t = torch.matmul(dr, tvecs[..., None])[..., 0] + step_cam[:, 3:6]
    return new_r, new_t, fx_fy + step_cam[:, 6:8]
