"""Shared preconditioned-CG core.

Counterpart of ``tpu3drecon/solvers/pcg.py``: the same stopping test
(||r||^2 <= rtol^2 ||b||^2), breakdown guards and last-finite-iterate rule.
The loop runs on the host and reads ``dot(r, r) > tol2`` back once per
iteration.  A solve is the span ``pcg`` with children ``pcg.matvec`` and
``pcg.precond``; the counter ``cg.iters`` adds its iterations
(``utils/timing.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpu3drecon_torch.utils.timing import count, host_wait, span


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

    with span("pcg"):
        with span("pcg.precond"):
            z0 = precond(b)
        rz = dot(b, z0)
        b_norm2 = torch.clamp(dot(b, b), min=1e-32)
        tol2 = torch.full_like(b_norm2, rtol) ** 2 * b_norm2

        x = torch.zeros_like(b)
        x_good = x
        r, p = b, z0
        i = 0
        while i < maxiter:
            not_done = dot(r, r) > tol2
            with host_wait("cg_converged"):
                go = bool(not_done)
            if not go:
                break
            with span("pcg.matvec"):
                sp = matvec(p)
            alpha = rz / _guard(dot(p, sp))
            x = x + alpha * p
            r = r - alpha * sp
            with span("pcg.precond"):
                z = precond(r)
            rz_new = dot(r, z)
            beta = rz_new / _guard(rz)
            ok = torch.isfinite(dot(x, x) + dot(r, r))
            x_good = torch.where(ok, x, x_good)
            p = z + beta * p
            rz = rz_new
            i += 1
        count("cg.iters", i)
    return PCGOut(x=x_good, iters=i, r=r, b_norm2=b_norm2)


def cholesky_or_nan(m: torch.Tensor) -> torch.Tensor:
    """Per-block Cholesky factors of (C, n, n) blocks, with JAX's failed
    factor (NaN on and below the diagonal) where ``cholesky_ex`` reports
    ``info != 0``; ``torch.linalg.cholesky`` would raise there."""
    chol, info = torch.linalg.cholesky_ex(m)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(chol, float("nan")).tril(), chol)


def guarded_block_cholesky(precond_mat: torch.Tensor, u_d: torch.Tensor) -> torch.Tensor:
    """Per-camera cholesky of the preconditioner blocks with an SPD fallback.

    The Schur-Jacobi blocks ``u_d - W V^-1 W^T`` can go indefinite at small
    damping.  jnp's cholesky returns NaN there; ``torch.linalg.cholesky``
    raises, so this uses ``cholesky_ex`` and treats ``info != 0`` or a NaN
    factor as a failed block.  Failed blocks fall back to the cholesky of
    the damped U block (SPD by construction for lam >= 0).
    """
    chol, info = torch.linalg.cholesky_ex(precond_mat)
    bad = (info != 0) | torch.isnan(chol).any(dim=-1).any(dim=-1)
    # A damped U that is not SPD either (lam < 0 only) gets JAX's failed
    # factor: NaN on and below the diagonal.
    return torch.where(bad[:, None, None], cholesky_or_nan(u_d), chol)


def cho_block_precond(u_chol: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Block preconditioner from per-camera cholesky factors (C, np, np)."""

    def apply(r: torch.Tensor) -> torch.Tensor:
        # The card's batched solve (MAGMA) synchronizes the stream before
        # it returns.
        with host_wait("cho_solve"):
            return torch.cholesky_solve(r[..., None], u_chol)[..., 0]

    return apply
