"""Block-tridiagonal and block-SSOR preconditioners: factorization and solve.

Counterpart of ``tpu3drecon/solvers/tridiag.py``.  Sequential captures give
the reduced camera system S a block band: S_{c,c+1} (cameras sharing
tracks) dominates the off-diagonal.  Both preconditioners take the damped
Schur-Jacobi diagonal blocks D and the band blocks E_c = S_{c,c+1} that
the wtt linearization emits with ``want_od``.

- ``tridiag``: M = tridiag(E^T, D, E), factored by a block-Cholesky Thomas
  sweep.  A per-step SPD guard drops an interface whose pivot
  D_c - W^T W loses positive definiteness (the tridiagonal part of an SPD
  matrix need not be SPD): the step falls back to chol(D_c), and the
  factor is then the exact factor of that modified, still SPD matrix.
  JAX detects the failure by the NaN that jnp's Cholesky returns; here
  ``torch.linalg.cholesky_ex`` reports it in ``info``.
- ``ssor``: M = (D + L) D^-1 (D + L)^T with L the lower band; SPD whenever
  D is, with no guard.

``segments`` splits the camera chain into independent sub-chains of equal
length (the boundary interfaces are dropped).  Each JAX ``lax.scan`` over
a sub-chain becomes a Python loop over its steps, batched over the
segments: at BAL scale (c_pad 1792, 14 segments of 128) a sweep is 128
steps of (14, n, n) block algebra, a few PyTorch calls each.  Where the
JAX factor returns NaN (an unguarded Cholesky of a non-SPD block) the
port does too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drecon_torch.utils.timing import span


class TridiagFactor(NamedTuple):
    l_blocks: torch.Tensor  # (C, n, n) lower-triangular diagonal factors
    w_blocks: torch.Tensor  # (C, n, n) W_c = L_c^{-1} E_c (segment ends zero)
    w_used: torch.Tensor  # (C, n, n) W_{c-1} actually used at step c (guarded)


class SSORFactor(NamedTuple):
    d_chol: torch.Tensor  # (C, n, n) cholesky of the D blocks
    e_blocks: torch.Tensor  # (C, n, n) e[c] = S[c, c+1] (segment ends zero)


def auto_segments(n_blocks: int, target_len: int = 128) -> int:
    """Segment count for a C-camera chain: ~``target_len`` cameras per
    sub-chain when C divides evenly (the wtt c_pad is always a multiple of
    128), else the whole chain."""
    if n_blocks >= 2 * target_len and n_blocks % target_len == 0:
        return n_blocks // target_len
    return 1


def _cholesky(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, failed): batched Cholesky factors of (a + a^T) / 2, as jnp's
    Cholesky symmetrizes its input, and a per-matrix flag for a matrix that
    is not SPD (``info`` != 0) or gave a NaN factor."""
    chol, info = torch.linalg.cholesky_ex((a + a.transpose(-1, -2)) / 2)
    return chol, (info != 0) | torch.isnan(chol).flatten(-2).any(-1)


def _nan_where(bad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with the factors flagged ``bad`` replaced by what jnp's Cholesky
    returns on failure: NaN on and below the diagonal, zeros above."""
    return torch.where(bad[..., None, None], torch.full_like(x, float("nan")).tril(), x)


def _segment_view(x: torch.Tensor, segments: int) -> torch.Tensor:
    c = x.shape[0]
    assert c % segments == 0, (c, segments)
    return x.reshape(segments, c // segments, *x.shape[1:])


def _drop_segment_ends(e_blocks: torch.Tensor, segments: int) -> torch.Tensor:
    """E with each segment's last block zeroed (the dropped interfaces)."""
    e_seg = _segment_view(e_blocks, segments).clone()
    e_seg[:, -1] = 0.0
    return e_seg


def _tsolve(l: torch.Tensor, v: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """Batched triangular solve of (S, n, n) against (S, n) vectors."""
    return torch.linalg.solve_triangular(l, v[..., None], upper=upper)[..., 0]


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, x[..., None])[..., 0]


def tridiag_factor(d_blocks: torch.Tensor, e_blocks: torch.Tensor,
                   segments: int = 1) -> TridiagFactor:
    """Factor M = tridiag(E^T, D, E) as block-bidiagonal L Lt.

    ``d_blocks`` (C, n, n) SPD diagonal blocks; ``e_blocks`` (C, n, n) with
    e[c] = M[c, c+1] (the last row of each segment is dropped).  Returns
    the factor with the per-step SPD guard applied."""
    c, n, _ = d_blocks.shape
    d_seg = _segment_view(d_blocks, segments)
    e_seg = _drop_segment_ends(e_blocks, segments)
    # The guard's fallback chol(D_c) of every step at once.
    fallback, fb_bad = _cholesky(d_blocks)
    fallback = _segment_view(_nan_where(fb_bad, fallback), segments)
    w_prev = d_blocks.new_zeros(segments, n, n)
    ls, ws, wus = [], [], []
    for step in range(d_seg.shape[1]):
        d_c, e_c = d_seg[:, step], e_seg[:, step]
        l_c, bad = _cholesky(d_c - torch.matmul(w_prev.transpose(-1, -2), w_prev))
        sel = bad[:, None, None]
        wus.append(torch.where(sel, torch.zeros_like(w_prev), w_prev))
        l_c = torch.where(sel, fallback[:, step], l_c)
        w_prev = torch.linalg.solve_triangular(l_c, e_c, upper=False)
        ls.append(l_c)
        ws.append(w_prev)
    return TridiagFactor(
        l_blocks=torch.stack(ls, dim=1).reshape(c, n, n),
        w_blocks=torch.stack(ws, dim=1).reshape(c, n, n),
        w_used=torch.stack(wus, dim=1).reshape(c, n, n),
    )


def tridiag_solve(factor: TridiagFactor, r: torch.Tensor, segments: int = 1) -> torch.Tensor:
    """Solve M z = r for the factored block tridiagonal; r is (C, n).

    ``segments`` must match the value given to ``tridiag_factor``."""
    c, n = r.shape
    l = _segment_view(factor.l_blocks, segments)
    w = _segment_view(factor.w_blocks, segments)
    wu = _segment_view(factor.w_used, segments)
    rs = _segment_view(r, segments)
    ln = rs.shape[1]
    # The interface (c, c+1) acts in the backward sweep only where step c+1
    # used it (``w_used`` nonzero): the JAX ``bwd`` rule, decided for every
    # step at once.
    used = torch.zeros(segments, ln, dtype=torch.bool, device=r.device)
    used[:, :-1] = (wu[:, 1:] != 0.0).flatten(-2).any(-1)
    w_eff = torch.where(used[..., None, None], w, torch.zeros_like(w))
    wu_t = wu.transpose(-1, -2)
    l_t = l.transpose(-1, -2)
    y_prev = r.new_zeros(segments, n)
    ys = []
    for step in range(ln):
        y_prev = _tsolve(l[:, step], rs[:, step] - _mv(wu_t[:, step], y_prev))
        ys.append(y_prev)
    z_next = r.new_zeros(segments, n)
    zs = [None] * ln
    for step in reversed(range(ln)):
        z_next = _tsolve(l_t[:, step], ys[step] - _mv(w_eff[:, step], z_next), upper=True)
        zs[step] = z_next
    return torch.stack(zs, dim=1).reshape(c, n)


def ssor_factor(d_blocks: torch.Tensor, e_blocks: torch.Tensor,
                segments: int = 1) -> SSORFactor:
    """Block-SSOR preconditioner M = (D+L) D^{-1} (D+L)^T, L = lower band.

    The same D and E as ``tridiag_factor``; SPD whenever D is, with no
    guard.  A D block that is not SPD gives a NaN factor, as jnp's
    Cholesky does."""
    c, n, _ = d_blocks.shape
    chol, bad = _cholesky(d_blocks)
    e_seg = _drop_segment_ends(e_blocks, segments)
    return SSORFactor(d_chol=_nan_where(bad, chol), e_blocks=e_seg.reshape(c, n, n))


def ssor_solve(factor: SSORFactor, r: torch.Tensor, segments: int = 1) -> torch.Tensor:
    """Solve M z = r for block-SSOR M = (D+L) D^{-1} (D+L)^T; r is (C, n).

    Forward sweep u = (D+L)^{-1} r, then z_c = u_c - D_c^{-1} E_c z_{c+1}.
    ``segments`` must match ``ssor_factor``."""
    c, n = r.shape
    dch = _segment_view(factor.d_chol, segments)
    dch_t = dch.transpose(-1, -2)
    e = _segment_view(factor.e_blocks, segments)
    e_t = e.transpose(-1, -2)
    rs = _segment_view(r, segments)
    ln = rs.shape[1]

    def dsolve(step, v):  # D_c^{-1} v by the two triangular solves of JAX
        return _tsolve(dch_t[:, step], _tsolve(dch[:, step], v), upper=True)

    u_prev = r.new_zeros(segments, n)
    us = []
    for step in range(ln):
        v = rs[:, step] if step == 0 else rs[:, step] - _mv(e_t[:, step - 1], u_prev)
        u_prev = dsolve(step, v)
        us.append(u_prev)
    z_next = r.new_zeros(segments, n)
    zs = [None] * ln
    for step in reversed(range(ln)):
        z_next = us[step] - dsolve(step, _mv(e[:, step], z_next))
        zs[step] = z_next
    return torch.stack(zs, dim=1).reshape(c, n)


def ssor_matvec(d_blocks, e_blocks, x, segments: int = 1):
    """M x for testing: applies (D+L) D^{-1} (D+L)^T blockwise."""
    c, n = x.shape
    e = _drop_segment_ends(e_blocks, segments).reshape(c, n, n)
    # t = (D+L)^T x  ->  t_c = D_c x_c + E_c x_{c+1}
    t = _mv(d_blocks, x)
    t[:-1] += _mv(e[:-1], x[1:])
    s = torch.linalg.solve(d_blocks, t)
    # out = (D+L) s  ->  out_c = D_c s_c + E_{c-1}^T s_{c-1}
    out = _mv(d_blocks, s)
    out[1:] += _mv(e[:-1].transpose(-1, -2), s[:-1])
    return out


def band_factor(precond: str, d_blocks: torch.Tensor, e_blocks: torch.Tensor):
    """The ``precond`` ("ssor" or "tridiag") factor of D and E over
    ``auto_segments`` segments, inside the span ``precond.band_factor``
    (the wtt and tt engines' band path)."""
    make = ssor_factor if precond == "ssor" else tridiag_factor
    with span("precond.band_factor"):
        return make(d_blocks, e_blocks, segments=auto_segments(d_blocks.shape[0]))


def band_preconditioner(factor):
    """r -> M^-1 r for a ``band_factor`` factor, each apply inside the
    span ``precond.band_apply``."""
    seg = auto_segments(factor[0].shape[0])
    solve = ssor_solve if isinstance(factor, SSORFactor) else tridiag_solve

    def apply(r):
        with span("precond.band_apply"):
            return solve(factor, r, segments=seg)

    return apply


def tridiag_matvec(d_blocks, e_blocks, x):
    """M x for testing: (C, n, n), (C, n, n), (C, n) -> (C, n)."""
    out = _mv(d_blocks, x)
    out[:-1] += _mv(e_blocks[:-1], x[1:])
    out[1:] += _mv(e_blocks[:-1].transpose(-1, -2), x[:-1])
    return out
