"""Shared trust-region (Levenberg-Marquardt) outer loop.

Counterpart of ``tpu3drecon/solvers/trust_region.py``: the same
accept/reject test and Nielsen damping control, as a Python loop instead
of ``lax.while_loop``.  Every decision is a device-side ``torch.where``;
the loop condition reads ``converged`` back once per iteration.  Engines
supply

  propose(params, lam)   -> (delta, grad_norm, pred_reduction, cg_iters)
  apply(params, delta)   -> candidate params (retraction)
  cost(params)           -> scalar 0.5*||r||^2

``params`` is a nested tuple of tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from tpu3drecon_torch.solvers.bundle_adjust import BAConfig


class TRState(NamedTuple):
    params: Any
    loss: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    iter_num: int
    accepted: torch.Tensor
    grad_norm: torch.Tensor
    converged: torch.Tensor
    cg_iters: int
    gain: torch.Tensor


def _select(accept: torch.Tensor, a, b):
    """torch.where over matching nested tuples of tensors."""
    if isinstance(a, tuple):
        return tuple(_select(accept, x, y) for x, y in zip(a, b))
    return torch.where(accept, a, b)


def trust_region_solve(
    propose: Callable,
    apply_step: Callable,
    cost: Callable,
    params0: Any,
    config: BAConfig,
    dtype: torch.dtype,
    device,
) -> TRState:
    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    state = TRState(
        params=params0,
        loss=cost(params0),
        lam=scalar(config.init_lambda),
        nu=scalar(2.0),
        iter_num=0,
        accepted=torch.zeros((), dtype=torch.int32, device=device),
        grad_norm=scalar(float("inf")),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        cg_iters=0,
        gain=scalar(0.0),
    )
    while state.iter_num < config.maxiter and not bool(state.converged):
        delta, grad_norm, pred, cg_iters = propose(state.params, state.lam)
        cand = apply_step(state.params, delta)
        loss_cand = cost(cand)

        pred = torch.clamp(pred, min=1e-32)
        gain = (state.loss - loss_cand) / pred
        accept = torch.isfinite(loss_cand) & (loss_cand < state.loss)

        lam_acc = state.lam * torch.clamp(
            1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0
        )
        lam_new = torch.clamp(
            torch.where(accept, lam_acc, state.lam * state.nu),
            config.min_lambda,
            config.max_lambda,
        )
        nu_new = torch.where(accept, torch.full_like(state.nu, 2.0), state.nu * 2.0)
        rel_decrease = (state.loss - loss_cand) <= config.ftol * torch.clamp(
            state.loss, min=1e-32
        )
        converged = (grad_norm < config.gtol) | (accept & rel_decrease)

        state = TRState(
            params=_select(accept, cand, state.params),
            loss=torch.where(accept, loss_cand, state.loss),
            lam=lam_new,
            nu=nu_new,
            iter_num=state.iter_num + 1,
            accepted=state.accepted + accept.to(torch.int32),
            grad_norm=grad_norm,
            converged=converged,
            cg_iters=cg_iters,
            gain=gain,
        )
    return state
