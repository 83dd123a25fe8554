"""Shared trust-region (Levenberg-Marquardt) outer loop.

Counterpart of ``tpu3drecon/solvers/trust_region.py``: the same
accept/reject test and Nielsen damping control, as a Python loop instead
of ``lax.while_loop``.  Every decision is a device-side ``torch.where``;
the loop condition reads ``converged`` back once per iteration.  Each
iteration is the span ``lm.iter`` with children ``lm.propose``,
``lm.apply``, ``lm.cost`` and ``lm.update`` (the accept/reject logic and
the loop condition) and adds one to the counter ``lm.iters``
(``utils/timing.py``).  Engines supply

  propose(params, lam)   -> (delta, grad_norm, pred_reduction, cg_iters)
  apply(params, delta)   -> candidate params (retraction)
  cost(params)           -> scalar 0.5*||r||^2

``params`` is a nested tuple of tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from tpu3drecon_torch.solvers.bundle_adjust import BAConfig
from tpu3drecon_torch.utils.timing import count, host_wait, span


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
        # A copy from pageable host memory: it waits for the card's stream.
        with host_wait("state_init"):
            return torch.tensor(v, dtype=dtype, device=device)

    def more(state) -> bool:
        if state.iter_num >= config.maxiter:
            return False
        with host_wait("lm_converged"):
            return not bool(state.converged)

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
    go = more(state)
    while go:
        with span("lm.iter"):
            with span("lm.propose"):
                delta, grad_norm, pred, cg_iters = propose(state.params, state.lam)
            with span("lm.apply"):
                cand = apply_step(state.params, delta)
            with span("lm.cost"):
                loss_cand = cost(cand)
            with span("lm.update"):
                state = _update(state, cand, loss_cand, grad_norm, pred, cg_iters, config)
                count("lm.iters")
                go = more(state)
    return state


def _update(state: TRState, cand, loss_cand, grad_norm, pred, cg_iters,
            config: BAConfig) -> TRState:
    """The accept/reject test and the damping update, on the device."""
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

    return TRState(
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
