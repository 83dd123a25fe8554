"""Levenberg-Marquardt on dense normal equations, batched over problems.

Counterpart of ``tpu3drecon/solvers/lm_core.py``: the same trust-region
LM (Jacobi-equilibrated Cholesky step, Nielsen damping, the linearization
recomputed only after accepted steps, a pluggable ``retract``), written
once for a batch of B independent problems.  ``lm_solve`` is the case
B = 1.

The JAX package runs ``jax.vmap`` over a ``lax.while_loop``; here every
lane runs the same loop body on batched tensors:

  - residuals and Jacobians come from ``torch.func.vmap`` over
    ``torch.func.jacfwd`` of the per-problem residual;
  - the damping, the equilibration and the Cholesky are batched
    ``(B, n, n)`` operations (``cholesky_ex``: a factor that fails,
    ``info != 0``, gives a NaN step, which is rejected, as JAX's NaN
    factor is);
  - a lane is active where ``iter_num < maxiter`` and it has not
    converged, and every field of ``LMState`` changes in active lanes
    only, as under ``vmap`` of ``lax.while_loop``;
  - the host loop ends when no lane is active, reading that back once per
    iteration.

The candidate's Jacobian is formed in every lane and kept where the step
is accepted (JAX's ``lax.cond``, a select under ``vmap``).  Only
materializes J: meant for small parameter blocks (8-dof poses, 4
intrinsics).  ``DynamicLMParams`` and the ``static_lm_config`` /
``dynamic_lm_operands`` / ``split_`` / ``merge_dynamic_lm_config`` helpers
only key XLA's compile cache and are not ported (ROADMAP A.8).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap


class LMConfig(NamedTuple):
    """LM stopping/damping configuration (fields as in the JAX package)."""

    maxiter: int = 100
    gtol: float = 1e-8  # inf-norm of gradient
    ftol: float = 1e-12  # relative cost decrease on accepted steps
    xtol: float = 0.0  # relative step norm (0 disables)
    init_lambda: float = 1e-3
    min_lambda: float = 1e-32
    max_lambda: float = 1e32
    diag_damping: bool = True  # lambda * diag(JtJ) (Marquardt) vs lambda * I


class LMState(NamedTuple):
    """Per-lane solver state: a leading batch axis on every field (none
    from ``lm_solve``)."""

    params: torch.Tensor
    residual: torch.Tensor  # cached residual at params
    jac: torch.Tensor  # cached Jacobian at params
    loss: torch.Tensor  # 0.5 * ||residual||^2
    lam: torch.Tensor
    nu: torch.Tensor
    iter_num: torch.Tensor  # int32 loop iterations (accepted + rejected)
    accepted: torch.Tensor  # int32 accepted step count
    grad_norm: torch.Tensor
    converged: torch.Tensor
    gain: torch.Tensor  # last gain ratio (diagnostics)


def _loss_of(residual: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(residual * residual, dim=-1)


def lm_solve_batched(
    residual_fn: Callable[..., torch.Tensor],
    params0: torch.Tensor,
    *args,
    config: LMConfig = LMConfig(),
    retract: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """Minimize 0.5*||residual_fn(params_b, *args_b)||^2 for every lane b.

    ``params0`` is (B, n); each tensor of ``args`` has the batch axis first
    (other arguments are shared by every lane).  ``residual_fn`` acts on
    one problem and returns a flat residual; ``retract(params, step)`` too
    (default: ``params + step``).  Returns ``(params, LMState)``.
    """
    torch.set_float32_matmul_precision("highest")
    in_dims = (0,) + tuple(0 if isinstance(a, torch.Tensor) else None for a in args)

    def with_aux(p, *a):
        r = residual_fn(p, *a)
        return r, r

    jac_and_res = vmap(jacfwd(with_aux, argnums=0, has_aux=True), in_dims=in_dims)
    step_fn = vmap(retract) if retract is not None else torch.add

    dtype, device = params0.dtype, params0.device
    n_lanes, n_params = params0.shape
    j0, r0 = jac_and_res(params0, *args)

    def full(v):
        return torch.full((n_lanes,), v, dtype=dtype, device=device)

    state = LMState(
        params=params0,
        residual=r0,
        jac=j0,
        loss=_loss_of(r0),
        lam=full(config.init_lambda),
        nu=full(2.0),
        iter_num=torch.zeros(n_lanes, dtype=torch.int32, device=device),
        accepted=torch.zeros(n_lanes, dtype=torch.int32, device=device),
        grad_norm=full(float("inf")),
        converged=torch.zeros(n_lanes, dtype=torch.bool, device=device),
        gain=full(0.0),
    )
    eye = torch.eye(n_params, dtype=dtype, device=device)
    while True:
        active = (state.iter_num < config.maxiter) & ~state.converged
        if not bool(active.any()):
            break
        jt = state.jac.mT
        jtj = jt @ state.jac
        grad = (jt @ state.residual[..., None])[..., 0]
        grad_norm = torch.amax(torch.abs(grad), dim=-1)

        if config.diag_damping:
            damp = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-10)
        else:
            damp = torch.ones_like(grad)
        lam = state.lam[:, None]
        a = jtj + lam[..., None] * (damp[..., None] * eye)

        # Jacobi equilibration before the factorization: solve
        # (D^-1/2 A D^-1/2) y = -D^-1/2 g, step = D^-1/2 y.
        d_inv_sqrt = 1.0 / torch.sqrt(
            torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1), min=1e-20)
        )
        a_eq = a * d_inv_sqrt[:, :, None] * d_inv_sqrt[:, None, :]
        chol, info = torch.linalg.cholesky_ex(a_eq)
        y = torch.cholesky_solve(-(d_inv_sqrt * grad)[..., None], chol)[..., 0]
        step = torch.where((info != 0)[:, None], torch.full_like(grad, float("nan")),
                           d_inv_sqrt * y)

        cand = step_fn(state.params, step)
        j_cand, r_cand = jac_and_res(cand, *args)
        loss_cand = _loss_of(r_cand)

        # Predicted reduction of the damped quadratic model:
        # 0.5 * step^T (lam * D * step - grad).
        pred = 0.5 * torch.sum(step * (lam * damp * step - grad), dim=-1)
        pred = torch.clamp(pred, min=1e-32)
        gain = (state.loss - loss_cand) / pred

        accept = torch.isfinite(loss_cand) & (loss_cand < state.loss)

        lam_acc = state.lam * torch.clamp(1.0 - (2.0 * gain - 1.0) ** 3, min=1.0 / 3.0)
        lam_new = torch.clamp(
            torch.where(accept, lam_acc, state.lam * state.nu),
            config.min_lambda, config.max_lambda,
        )
        nu_new = torch.where(accept, torch.full_like(state.nu, 2.0), state.nu * 2.0)

        step_small = torch.zeros_like(accept)
        if config.xtol > 0:
            step_small = torch.linalg.vector_norm(step, dim=-1) < config.xtol * (
                torch.linalg.vector_norm(state.params, dim=-1) + config.xtol
            )
        rel_decrease = (state.loss - loss_cand) <= config.ftol * torch.clamp(
            state.loss, min=1e-32
        )
        converged = (grad_norm < config.gtol) | (accept & rel_decrease) | step_small

        def keep(new, old, rows=active):
            return torch.where(rows.reshape(rows.shape + (1,) * (new.dim() - 1)), new, old)

        acc = active & accept
        state = LMState(
            params=keep(cand, state.params, acc),
            residual=keep(r_cand, state.residual, acc),
            jac=keep(j_cand, state.jac, acc),
            loss=keep(loss_cand, state.loss, acc),
            lam=keep(lam_new, state.lam),
            nu=keep(nu_new, state.nu),
            iter_num=state.iter_num + active.to(torch.int32),
            accepted=state.accepted + acc.to(torch.int32),
            grad_norm=keep(grad_norm, state.grad_norm),
            converged=keep(converged, state.converged),
            gain=keep(gain, state.gain),
        )
    return state.params, state


def lm_solve(
    residual_fn: Callable[..., torch.Tensor],
    params0: torch.Tensor,
    *args,
    config: LMConfig = LMConfig(),
    retract: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """Minimize 0.5*||residual_fn(params, *args)||^2 with dense-J LM: the
    batched solve with one lane.  Returns ``(params, LMState)``."""
    lanes = tuple(a[None] if isinstance(a, torch.Tensor) else a for a in args)
    params, state = lm_solve_batched(
        residual_fn, params0[None], *lanes, config=config, retract=retract
    )
    return params[0], LMState(*(f[0] for f in state))
