"""Block operations for the camera/point Schur complement (matrix-free).

Counterpart of ``tpu3drecon/solvers/schur.py``.  The normal equations of
bundle adjustment have the arrow structure

    [ U   W ] [dc]   [ -g_c ]
    [ W^T V ] [dp] = [ -g_p ]

with U = blkdiag over cameras (8x8), V = blkdiag over points (3x3) and W
one 8x3 coupling block per observation.  On the flat-observation layout
U, V and the gradients are segment sums over ``cam_idx`` / ``pt_idx``
(``ops/flat_linearize.py``: CUDA kernels on the card, ``index_add_`` on
the CPU), and the reduced camera system

    S dc = b,   S = U - W V^{-1} W^T,   b = -g_c + W V^{-1} g_p

is solved by preconditioned CG whose matvec is two segment sums and two
gathers; J, JtJ and S are never formed.  ``comm`` (a ``parallel.mesh.Mesh``,
the JAX functions' ``axis_name``) sums the segment sums of an
observation-sharded problem over the ranks; None is one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drecon_torch.ops.flat_linearize import FlatSums, segment_sum, sums_of_blocks
from tpu3drecon_torch.ops.point_normal import inv3x3  # noqa: F401 (schur.inv3x3)
from tpu3drecon_torch.parallel.mesh import psum
from tpu3drecon_torch.solvers.pcg import (
    cho_block_precond,
    cholesky_or_nan,
    guarded_block_cholesky,
    pcg,
)


class NormalBlocks(NamedTuple):
    """Damped normal-equation blocks for one linearization."""

    u: torch.Tensor  # (C, 8, 8) damped camera blocks
    v: torch.Tensor  # (P, 3, 3) damped point blocks
    w: torch.Tensor  # (N, 8, 3) per-observation coupling blocks
    g_cam: torch.Tensor  # (C, 8) gradient J_c^T r
    g_pt: torch.Tensor  # (P, 3) gradient J_p^T r
    v_inv: torch.Tensor  # (P, 3, 3) inverse of damped V
    u_chol: torch.Tensor  # (C, 8, 8) cholesky of the preconditioner blocks
    damp_cam: torch.Tensor  # (C, 8) diagonal damping actually added to U
    damp_pt: torch.Tensor  # (P, 3) diagonal damping actually added to V


def build_normal_blocks(
    blocks_r: torch.Tensor,  # (N, 2)
    blocks_jc: torch.Tensor,  # (N, 2, 8)
    blocks_jp: torch.Tensor,  # (N, 2, 3)
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    n_cameras: int,
    n_points: int,
    lam: torch.Tensor,
    diag_floor: float = 1e-8,
    precond: str = "schur_jacobi",
    comm=None,
) -> NormalBlocks:
    """Accumulate damped U, V, W and the gradients from per-observation
    blocks, with Marquardt damping lam * clamp(diag) (``damp_normal_blocks``
    of the segment sums)."""
    sums = sums_of_blocks(blocks_r, blocks_jc, blocks_jp, cam_idx, pt_idx, n_cameras, n_points)
    return damp_normal_blocks(sums, lam, diag_floor, precond, comm)


def damp_normal_blocks(
    sums: FlatSums,
    lam: torch.Tensor,
    diag_floor: float = 1e-8,
    precond: str = "schur_jacobi",
    comm=None,
) -> NormalBlocks:
    """The damped blocks of one linearization's sums (``ops/flat_linearize``):
    U, V and the gradients summed over the ranks, Marquardt damping lam *
    clamp(diag), V^-1, and the preconditioner factor.

    ``precond="schur_jacobi"`` factors the exact diagonal blocks of
    S = U - W V^-1 W^T, ``sums.coupling(v_inv)`` giving this rank's (C, 8,
    8) sum W V^-1 W^T (a guarded Cholesky, falling back to damped U where a
    block is not SPD); ``"jacobi_u"`` factors damped U, and a block that
    fails gives a NaN factor (on and below the diagonal), as JAX's Cholesky
    does.
    """
    u = psum(sums.u, comm)
    v = psum(sums.v, comm)
    g_cam = psum(sums.g_cam, comm)
    g_pt = psum(sums.g_pt, comm)

    du = torch.clamp(torch.diagonal(u, dim1=-2, dim2=-1), min=diag_floor)
    dv = torch.clamp(torch.diagonal(v, dim1=-2, dim2=-1), min=diag_floor)
    damp_cam = lam * du
    damp_pt = lam * dv
    u_d = u + torch.diag_embed(damp_cam)
    v_d = v + torch.diag_embed(damp_pt)

    v_inv = inv3x3(v_d)
    if precond == "schur_jacobi":
        u_chol = guarded_block_cholesky(u_d - psum(sums.coupling(v_inv), comm), u_d)
    else:
        u_chol = cholesky_or_nan(u_d)
    return NormalBlocks(
        u=u_d, v=v_d, w=sums.w, g_cam=g_cam, g_pt=g_pt, v_inv=v_inv, u_chol=u_chol,
        damp_cam=damp_cam, damp_pt=damp_pt,
    )


def w_times(nb: NormalBlocks, y_pt: torch.Tensor, cam_idx: torch.Tensor,
            pt_idx: torch.Tensor, n_cameras: int, comm=None) -> torch.Tensor:
    """(W y)_c: gather y by pt_idx, per-obs 8x3 @ 3, segment-sum by camera."""
    per_obs = torch.sum(nb.w * y_pt[pt_idx.long()][:, None, :], dim=-1)
    return psum(segment_sum(per_obs, cam_idx, n_cameras), comm)


def wt_times(nb: NormalBlocks, x_cam: torch.Tensor, cam_idx: torch.Tensor,
             pt_idx: torch.Tensor, n_points: int, comm=None) -> torch.Tensor:
    """(W^T x)_p: gather x by cam_idx, per-obs 3x8 @ 8, segment-sum by point."""
    per_obs = torch.sum(nb.w * x_cam[cam_idx.long()][:, :, None], dim=1)
    return psum(segment_sum(per_obs, pt_idx, n_points), comm)


def schur_matvec(nb: NormalBlocks, x_cam: torch.Tensor, cam_idx: torch.Tensor,
                 pt_idx: torch.Tensor, comm=None) -> torch.Tensor:
    """S x = U x - W V^{-1} W^T x, matrix-free (one all-reduce per product
    when sharded)."""
    n_cameras = nb.u.shape[0]
    n_points = nb.v.shape[0]
    ux = torch.sum(nb.u * x_cam[:, None, :], dim=-1)
    wtx = wt_times(nb, x_cam, cam_idx, pt_idx, n_points, comm)
    vinv_wtx = torch.sum(nb.v_inv * wtx[:, None, :], dim=-1)
    return ux - w_times(nb, vinv_wtx, cam_idx, pt_idx, n_cameras, comm)


def precond_apply(nb: NormalBlocks, r_cam: torch.Tensor) -> torch.Tensor:
    """Block-Jacobi preconditioner: per-camera solve with ``u_chol``."""
    return cho_block_precond(nb.u_chol)(r_cam)


class PCGResult(NamedTuple):
    x: torch.Tensor  # (C, 8)
    iters: int
    rel_residual: torch.Tensor


def schur_pcg(
    nb: NormalBlocks,
    b_cam: torch.Tensor,  # (C, 8)
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    maxiter: int = 100,
    rtol: float = 1e-6,
    comm=None,
) -> PCGResult:
    """Preconditioned CG on the reduced camera system S x = b."""
    out = pcg(
        lambda p: schur_matvec(nb, p, cam_idx, pt_idx, comm),
        lambda r: precond_apply(nb, r),
        b_cam, maxiter, rtol,
    )
    rel = torch.sqrt(torch.sum(out.r * out.r) / out.b_norm2)
    return PCGResult(x=out.x, iters=out.iters, rel_residual=rel)


def back_substitute_points(
    nb: NormalBlocks,
    dc: torch.Tensor,  # (C, 8) camera step
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    comm=None,
) -> torch.Tensor:
    """dp = V^{-1} (-g_p - W^T dc)."""
    n_points = nb.v.shape[0]
    wt_dc = wt_times(nb, dc, cam_idx, pt_idx, n_points, comm)
    return torch.sum(nb.v_inv * (-nb.g_pt - wt_dc)[:, None, :], dim=-1)
