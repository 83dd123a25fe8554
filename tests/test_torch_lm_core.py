"""The port's dense LM (``solvers/lm_core.py``) against the JAX package's.

The problems of tests/test_lm_core.py, built once from a seed with numpy,
go through ``tpu3drecon.solvers.lm_core`` (CPU, x64) and the port (CPU,
float64).  Each must give the same ``iter_num`` and ``accepted`` per lane,
loss to rtol 1e-8 and params to rtol 1e-7.  The configurations stop where
every accept/reject test and stopping test has a margin far above float64
rounding (an ``ftol`` of 1e-9, a ``gtol`` of 1e-6, or a ``maxiter`` before
the loss reaches its floor): at the floor, "loss_cand < loss" is decided
by the last bit, differently by two correct implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import to_np

from tpu3drecon.solvers.lm_core import LMConfig as JConfig
from tpu3drecon.solvers.lm_core import lm_solve as j_solve
from tpu3drecon.solvers.lm_core import lm_solve_batched as j_solve_batched

from tpu3drecon_torch.solvers.lm_core import LMConfig as TConfig
from tpu3drecon_torch.solvers.lm_core import lm_solve as t_solve
from tpu3drecon_torch.solvers.lm_core import lm_solve_batched as t_solve_batched

RNG = np.random.default_rng(0)
T = np.linspace(0, 4, 60)
Y = 2.5 * np.exp(-1.3 * T) + 0.5 + RNG.normal(scale=0.01, size=60)
# Six exponential fits with their own data and starts: their lanes stop at
# 3 to 17 iterations.
X0_LANES = np.array([[1, 1, 0], [2, 1.2, 0.4], [0.5, 0.5, 1.0], [3, 2, 0], [1, 3, 0.2],
                     [2.4, 1.3, 0.5]], dtype=np.float64)
Y_LANES = np.stack([(1 + 0.3 * i) * np.exp(-(1 + 0.1 * i) * T) + 0.2 * i
                    + RNG.normal(scale=0.01, size=60) for i in range(6)])


def j_exp(p, t, y):
    return p[0] * jnp.exp(-p[1] * t) + p[2] - y


def t_exp(p, t, y):
    return p[0] * torch.exp(-p[1] * t) + p[2] - y


def j_powell(p):
    return jnp.array([1e4 * p[0] * p[1] - 1.0, jnp.exp(-p[0]) + jnp.exp(-p[1]) - 1.0001])


def t_powell(p):
    return torch.stack([1e4 * p[0] * p[1] - 1.0, torch.exp(-p[0]) + torch.exp(-p[1]) - 1.0001])


def j_ones(p):
    return p - 1.0


def t_ones(p):
    return p - 1.0


# A circle parameterized by its angle, fitted to a point off the circle (a
# nonzero optimum); the step is retracted into [0, 2 pi).
TARGET = np.array([0.3, 1.2])


def j_circle(th):
    return jnp.array([jnp.cos(th[0]), jnp.sin(th[0])]) - jnp.asarray(TARGET)


def t_circle(th):
    return torch.stack([torch.cos(th[0]), torch.sin(th[0])]) - torch.tensor(TARGET)


def j_wrap(th, step):
    return jnp.mod(th + step, 2 * jnp.pi)


def t_wrap(th, step):
    return torch.remainder(th + step, 2 * torch.pi)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def assert_same_lm(port, ref):
    """Equal iter_num, accepted, converged and nu in every lane, loss to
    rtol 1e-8, params to rtol 1e-7.  (The last lambda is not compared: it
    scales with the last gain ratio, a quotient of a loss difference near
    rounding once a lane has converged.)"""
    (x, state), (jx, jstate) = port, ref
    np.testing.assert_array_equal(to_np(state.iter_num), np.asarray(jstate.iter_num))
    np.testing.assert_array_equal(to_np(state.accepted), np.asarray(jstate.accepted))
    np.testing.assert_array_equal(to_np(state.converged), np.asarray(jstate.converged))
    np.testing.assert_allclose(to_np(state.loss), np.asarray(jstate.loss), rtol=1e-8)
    np.testing.assert_allclose(to_np(x), np.asarray(jx), rtol=1e-7)
    np.testing.assert_allclose(to_np(state.nu), np.asarray(jstate.nu), rtol=0)


CASES = {
    # name: (JAX residual, port residual, x0, args, config kwargs, retract pair)
    "exponential_fit": (j_exp, t_exp, [1.0, 1.0, 0.0], (T, Y),
                        dict(maxiter=100, gtol=1e-14, ftol=1e-9), None),
    "diag_damping_off": (j_exp, t_exp, [1.0, 1.0, 0.0], (T, Y),
                         dict(maxiter=100, gtol=1e-14, ftol=1e-9, diag_damping=False), None),
    "badly_scaled_powell": (j_powell, t_powell, [0.0, 1.0], (),
                            dict(maxiter=20, gtol=1e-14), None),
    "zero_residual_at_start": (j_ones, t_ones, [1.0, 1.0, 1.0], (), {}, None),
    "retract_hook": (j_circle, t_circle, [0.3], (), dict(gtol=1e-8, ftol=1e-9),
                     (j_wrap, t_wrap)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lm_solve_matches_jax(name):
    jf, tf, x0, args, kw, retract = CASES[name]
    jr, tr = retract or (None, None)
    ref = j_solve(jf, jnp.asarray(x0, jnp.float64), *(jnp.asarray(a) for a in args),
                  config=JConfig(**kw), retract=jr)
    port = t_solve(tf, _t(x0), *(_t(a) for a in args), config=TConfig(**kw), retract=tr)
    assert_same_lm(port, ref)
    assert port[1].params.shape == port[0].shape == (len(x0),)
    if name == "zero_residual_at_start":
        assert bool(port[1].converged) and int(port[1].iter_num) == 1
        assert float(port[1].loss) == 0.0


def test_batched_lanes_stop_at_their_own_iterations():
    """vmap of lax.while_loop lane by lane: each lane keeps its state from
    the iteration it converged at."""
    cfg = dict(maxiter=100, gtol=1e-6)
    tb = np.tile(T, (6, 1))
    ref = j_solve_batched(j_exp, jnp.asarray(X0_LANES), jnp.asarray(tb), jnp.asarray(Y_LANES),
                          config=JConfig(**cfg))
    port = t_solve_batched(t_exp, _t(X0_LANES), _t(tb), _t(Y_LANES), config=TConfig(**cfg))
    assert_same_lm(port, ref)
    iters = to_np(port[1].iter_num)
    assert len(set(iters.tolist())) >= 4, iters  # the lanes stop apart
    # The last gradient is a cancelling sum near the optimum: its rounding
    # is absolute, ~1e-15 of the residuals' scale (O(1)).
    np.testing.assert_allclose(to_np(port[1].grad_norm), np.asarray(ref[1].grad_norm),
                               rtol=1e-6, atol=1e-13)


def test_batched_maxiter_caps_every_lane():
    cfg = dict(maxiter=3, gtol=0.0, ftol=0.0)
    tb = np.tile(T, (6, 1))
    ref = j_solve_batched(j_exp, jnp.asarray(X0_LANES), jnp.asarray(tb), jnp.asarray(Y_LANES),
                          config=JConfig(**cfg))
    port = t_solve_batched(t_exp, _t(X0_LANES), _t(tb), _t(Y_LANES), config=TConfig(**cfg))
    assert_same_lm(port, ref)
    assert to_np(port[1].iter_num).tolist() == [3] * 6


@pytest.mark.parametrize("maxiter", [1, 30])
def test_non_pd_factor_is_rejected(maxiter):
    """A negative initial lambda makes the damped, equilibrated system
    indefinite: JAX's Cholesky gives NaN, so the step is NaN and rejected;
    the port's ``cholesky_ex`` reports ``info != 0`` and must reject the
    same step (gain NaN, lambda -0.9 * nu clipped to min_lambda)."""
    cfg = dict(maxiter=maxiter, gtol=1e-8, ftol=1e-9, init_lambda=-0.9)
    ref = j_solve(j_exp, jnp.asarray([1.0, 1.0, 0.0]), jnp.asarray(T), jnp.asarray(Y),
                  config=JConfig(**cfg))
    port = t_solve(t_exp, _t([1.0, 1.0, 0.0]), _t(T), _t(Y), config=TConfig(**cfg))
    assert_same_lm(port, ref)
    if maxiter == 1:
        assert int(port[1].accepted) == 0
        assert np.isnan(float(port[1].gain)) and np.isnan(float(ref[1].gain))
        assert float(port[1].lam) == 1e-32
        assert float(port[1].nu) == 4.0
