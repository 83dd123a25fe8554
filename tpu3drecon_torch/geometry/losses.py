"""Robust loss functions for reprojection residuals.

Counterpart of ``tpu3drecon/geometry/losses.py``: the LM engines apply a
robust kernel as IRLS whitening, scaling residuals and Jacobian rows by
sqrt(rho'(s)) with s = ||r||^2 (the scheme Ceres uses for its robust
kernels).  The CUDA kernels (``csrc/wtt_kernels.cu``) take the loss as the
integer ``LOSS_CODES[loss]``.
"""

from __future__ import annotations

import enum
from typing import Callable

import torch


def trivial_rho(s: torch.Tensor) -> torch.Tensor:
    """rho(s) = s (no robustification)."""
    return s


def cauchy_rho(s: torch.Tensor) -> torch.Tensor:
    """rho(s) = log(1 + s) — Cauchy robust kernel on squared error s."""
    return torch.log1p(s)


def huber_rho(s: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber kernel on squared error s (delta in residual units)."""
    d2 = delta * delta
    return torch.where(
        s <= d2, s, 2.0 * delta * torch.sqrt(torch.clamp(s, min=d2)) - d2
    )


def robust_weight(rho: "RobustLoss", s: torch.Tensor) -> torch.Tensor:
    """IRLS weight w = rho'(s) for squared-error input s (>= 0)."""
    if rho == RobustLoss.TRIVIAL:
        return torch.ones_like(s)
    if rho == RobustLoss.CAUCHY:
        return 1.0 / (1.0 + s)
    if rho == RobustLoss.HUBER:
        delta = 1.0
        return torch.where(
            s <= delta * delta,
            torch.ones_like(s),
            delta / torch.sqrt(torch.clamp(s, min=delta * delta)),
        )
    raise ValueError(f"unknown robust loss {rho}")


class RobustLoss(enum.Enum):
    """Robust kernels for the LM engine (same ``.value``s as the JAX enum)."""

    TRIVIAL = "trivial"
    CAUCHY = "cauchy"
    HUBER = "huber"

    @property
    def rho(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return {
            RobustLoss.TRIVIAL: trivial_rho,
            RobustLoss.CAUCHY: cauchy_rho,
            RobustLoss.HUBER: huber_rho,
        }[self]


# Integer codes of the ``loss`` argument of the CUDA kernels.
LOSS_CODES = {RobustLoss.TRIVIAL: 0, RobustLoss.CAUCHY: 1, RobustLoss.HUBER: 2}
