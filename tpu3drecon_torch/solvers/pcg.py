"""Shared preconditioned-CG core.

Counterpart of ``tpu3drecon/solvers/pcg.py``: the same stopping test
(||r||^2 <= rtol^2 ||b||^2), breakdown guards and last-finite-iterate rule.
The loop runs on the host and reads ``dot(r, r) > tol2`` back once per
iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGOut(NamedTuple):
    x: torch.Tensor
    iters: int
    r: torch.Tensor  # final residual
    b_norm2: torch.Tensor


def _guard(d: torch.Tensor) -> torch.Tensor:
    """Denominator with |d| < 1e-32 replaced by 1 (breakdown guard)."""
    return torch.where(torch.abs(d) < 1e-32, torch.ones_like(d), d)


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    maxiter: int,
    rtol: float,
) -> PCGOut:
    """PCG with absolute-breakdown guards; stops at ||r||^2 <= rtol^2 ||b||^2
    or after ``maxiter`` iterations.  Returns the last iterate whose x and r
    were finite (a NaN/inf iterate would poison the LM candidate)."""

    def dot(a, b_):
        return torch.sum(a * b_)

    z0 = precond(b)
    rz = dot(b, z0)
    b_norm2 = torch.clamp(dot(b, b), min=1e-32)
    tol2 = torch.full_like(b_norm2, rtol) ** 2 * b_norm2

    x = torch.zeros_like(b)
    x_good = x
    r, p = b, z0
    i = 0
    while i < maxiter and bool(dot(r, r) > tol2):
        sp = matvec(p)
        alpha = rz / _guard(dot(p, sp))
        x = x + alpha * p
        r = r - alpha * sp
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / _guard(rz)
        ok = torch.isfinite(dot(x, x) + dot(r, r))
        x_good = torch.where(ok, x, x_good)
        p = z + beta * p
        rz = rz_new
        i += 1
    return PCGOut(x=x_good, iters=i, r=r, b_norm2=b_norm2)


def guarded_block_cholesky(precond_mat: torch.Tensor, u_d: torch.Tensor) -> torch.Tensor:
    """Per-camera cholesky of the preconditioner blocks with an SPD fallback.

    The Schur-Jacobi blocks ``u_d - W V^-1 W^T`` can go indefinite at small
    damping.  jnp's cholesky returns NaN there; ``torch.linalg.cholesky``
    raises, so this uses ``cholesky_ex`` and treats ``info != 0`` or a NaN
    factor as a failed block.  Failed blocks fall back to the cholesky of
    the damped U block (SPD by construction).
    """
    chol, info = torch.linalg.cholesky_ex(precond_mat)
    bad = (info != 0) | torch.isnan(chol).any(dim=-1).any(dim=-1)
    fallback = torch.linalg.cholesky_ex(u_d).L
    return torch.where(bad[:, None, None], fallback, chol)


def cho_block_precond(u_chol: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Block preconditioner from per-camera cholesky factors (C, np, np)."""

    def apply(r: torch.Tensor) -> torch.Tensor:
        return torch.cholesky_solve(r[..., None], u_chol)[..., 0]

    return apply
