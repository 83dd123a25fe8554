"""Point-set and camera-set alignment (Umeyama, Horn, robust variants).

Counterpart of ``tpu3drecon/geometry/alignment.py``: Horn's quaternion
absolute orientation with scale, the Umeyama SVD solution and a
random-subset robust wrapper.  ``robust_alignment`` draws its subsets from
``np.random.default_rng(seed)`` on the host, as JAX does, so both packages
fit the same subsets; its median is the midpoint of the two middle values
of an even count, as ``jnp.median``'s (``torch.median`` returns the lower).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu3drecon_torch.geometry.rotations import quat_to_matrix


class Similarity(NamedTuple):
    """x_target ~= scale * R @ x_source + t."""

    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)

    def apply(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.scale * (xyz @ self.rotation.T) + self.translation


def umeyama_alignment(
    source: torch.Tensor, target: torch.Tensor, with_scale: bool = True
) -> Similarity:
    """Least-squares similarity aligning source -> target (Umeyama 1991),
    with the paper's SVD sign correction."""
    mu_s = torch.mean(source, dim=0)
    mu_t = torch.mean(target, dim=0)
    xs = source - mu_s
    xt = target - mu_t
    n = source.shape[0]
    cov = (xt.T @ xs) / n
    u, d, vt = torch.linalg.svd(cov)
    s = torch.eye(3, dtype=source.dtype, device=source.device)
    s[2, 2] = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    rotation = u @ s @ vt
    if with_scale:
        var_s = torch.mean(torch.sum(xs * xs, dim=1))
        scale = torch.sum(d * torch.diagonal(s)) / torch.clamp(var_s, min=1e-32)
    else:
        scale = torch.ones((), dtype=source.dtype, device=source.device)
    translation = mu_t - scale * (rotation @ mu_s)
    return Similarity(scale=scale, rotation=rotation, translation=translation)


def horn_quaternion_alignment(
    source: torch.Tensor, target: torch.Tensor, with_scale: bool = True
) -> Similarity:
    """Horn's closed-form absolute orientation via the 4x4 quaternion
    matrix."""
    mu_s = torch.mean(source, dim=0)
    mu_t = torch.mean(target, dim=0)
    xs = source - mu_s
    xt = target - mu_t
    m = xs.T @ xt  # 3x3 correlation
    sxx, sxy, sxz = m[0, 0], m[0, 1], m[0, 2]
    syx, syy, syz = m[1, 0], m[1, 1], m[1, 2]
    szx, szy, szz = m[2, 0], m[2, 1], m[2, 2]
    n4 = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx]),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz]),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy]),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]),
        ]
    )
    _, eigvecs = torch.linalg.eigh(n4)
    q = eigvecs[:, -1]  # max eigenvalue -> optimal quaternion (wxyz)
    rotation = quat_to_matrix(q)
    if with_scale:
        num = torch.sum(xt * (xs @ rotation.T))
        den = torch.clamp(torch.sum(xs * xs), min=1e-32)
        scale = num / den
    else:
        scale = torch.ones((), dtype=source.dtype, device=source.device)
    translation = mu_t - scale * (rotation @ mu_s)
    return Similarity(scale=scale, rotation=rotation, translation=translation)


def robust_alignment(
    source: np.ndarray,
    target: np.ndarray,
    n_trials: int = 300,
    subset: Optional[int] = None,
    seed: int = 0,
    with_scale: bool = True,
) -> Similarity:
    """Random-subset robust alignment (host loop): ``n_trials`` Umeyama fits
    on random subsets; keeps the transform with the lowest median error
    over all points."""
    rng = np.random.default_rng(seed)
    n = len(source)
    # RANSAC-style minimal samples.
    subset = subset or 4
    best: Optional[Similarity] = None
    best_err = np.inf
    src = torch.as_tensor(np.asarray(source))
    tgt = torch.as_tensor(np.asarray(target))
    for _ in range(n_trials):
        rows = torch.as_tensor(rng.choice(n, size=min(subset, n), replace=False))
        sim = umeyama_alignment(src[rows], tgt[rows], with_scale=with_scale)
        resid = torch.linalg.vector_norm(sim.apply(src) - tgt, dim=1)
        err = float(torch.quantile(resid, 0.5, interpolation="midpoint"))
        if err < best_err:
            best_err = err
            best = sim
    return best


def alignment_errors(sim: Similarity, source: torch.Tensor, target: torch.Tensor):
    """Per-point residual norms after alignment."""
    return torch.linalg.vector_norm(sim.apply(source) - target, dim=1)
