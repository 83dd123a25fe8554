"""Routes (b)-(d) of the port's ``ba_solve_wtt`` vs the JAX reference:

  (b) ``linearize_kernel="index"``, ``matvec_kernel="fused"``: B1, the CG
      coupling from the dense one-hot (B6), PyTorch back-substitution;
  (c) ``linearize_kernel=False``, ``matvec_kernel=True``: B7 and B8, B6,
      PyTorch rhs and back-substitution;
  (d) both False, the JAX package's default: B7 and B8, and every product
      in PyTorch (gathers and scatters through ``wcam``).

Set-up and tolerances as tests/test_torch_ba_wtt_routes.py (route (a));
also the engine's configuration errors and ``make_wtt_ba_solver``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import pytest
import torch

from _torch_ref import SEQ_DISTS, assert_same_solve, np_fields, seq_scene_kwargs

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.problems.convert import wtt_problem_from_numpy
from tpu3drecon_torch.problems.wtt import expand_onehots
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.ba_wtt import make_wtt_ba_solver
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

CASES = {  # id -> (route, loss, scene distortion, preconditioner)
    "b": ("b", "trivial", "radial", "schur_jacobi"),
    "c": ("c", "trivial", "pinhole", "schur_jacobi"),
    "d": ("d", "trivial", "radial", "schur_jacobi"),
    "d-jacobi_u": ("d", "trivial", "pinhole", "jacobi_u"),
}
SOLVE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
ROUTES = {  # (linearize_kernel, matvec_kernel)
    "a": dict(linearize_kernel=False, matvec_kernel="index"),
    "b": dict(linearize_kernel="index", matvec_kernel="fused"),
    "c": dict(linearize_kernel=False, matvec_kernel=True),
    "d": dict(linearize_kernel=False, matvec_kernel=False),
}


@functools.lru_cache(maxsize=None)
def _jax_packed(dist):
    """The JAX packing of the sequential scene with its dense int8 one-hot."""
    scene = j_syn.make_sequential_scene(**seq_scene_kwargs(SEQ_DISTS[dist]))
    noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return j_wtt(flat, point_chunk=64)


def _configs(route, loss, precond):
    kw = dict(SOLVE, **ROUTES[route], precond=precond)
    return JConfig(loss=JLoss(loss), **kw), TConfig(loss=TLoss(loss), **kw)


def _case(request):
    """(JAX packed problem, JAX solve, port config) of a CASES entry."""
    route, loss, dist, precond = CASES[request.param]
    jcfg, tcfg = _configs(route, loss, precond)
    packed = _jax_packed(dist)
    return packed, j_solve(packed, jcfg), tcfg


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    return _case(request)


def test_route_matches_jax(reference):
    packed, ref, tcfg = reference
    port = t_solve(wtt_problem_from_numpy(np_fields(packed), device="cpu"), tcfg)
    assert_same_solve(port, ref, SOLVE["maxiter"])


def _port_problem(defer=False):
    problem = wtt_problem_from_numpy(np_fields(_jax_packed("pinhole")), device="cpu")
    if defer:
        problem = dataclasses.replace(problem, buckets=tuple(
            dataclasses.replace(b, onehot=None) for b in problem.buckets))
    return problem


BAD_CONFIGS = [  # (config change, problem deferred, message)
    (ROUTES["d"], True, "deferred one-hots"),
    (ROUTES["c"], True, "deferred one-hots"),
    (dict(matvec_kernel="indx"), False, "matvec_kernel must be"),
    (dict(linearize_kernel="fused"), False, "linearize_kernel must be"),
    (dict(matvec_kernel="index", matvec_bf16=True), False, "matvec_bf16"),
]


@pytest.mark.parametrize("change,defer,match", BAD_CONFIGS)
def test_config_errors_match_jax(change, defer, match):
    """The JAX engine's ValueErrors: a one-hot route on a deferred problem,
    a typo in either kernel option, matvec_bf16 with a matvec kernel."""
    kw = dict(SOLVE, **change)
    jpacked = _jax_packed("pinhole")
    if defer:
        jpacked = dataclasses.replace(jpacked, buckets=tuple(
            dataclasses.replace(b, onehot=None) for b in jpacked.buckets))
    with pytest.raises(ValueError, match=match):
        j_solve(jpacked, JConfig(**kw))
    with pytest.raises(ValueError, match=match):
        t_solve(_port_problem(defer), TConfig(**kw))


def test_expand_onehots_lifts_the_deferred_error():
    cfg = TConfig(**dict(SOLVE, maxiter=1), **ROUTES["d"])
    problem = _port_problem(defer=True)
    with pytest.raises(ValueError, match="deferred"):
        t_solve(problem, cfg)
    _, _, state = t_solve(expand_onehots(problem), cfg)
    assert state.iter_num == 1


def test_make_wtt_ba_solver():
    cfg = TConfig(**dict(SOLVE, maxiter=2), **ROUTES["d"])
    solve = make_wtt_ba_solver(cfg)
    assert make_wtt_ba_solver(cfg) is solve
    problem = _port_problem()
    _, p1, s1 = solve(problem)
    _, p2, s2 = t_solve(problem, cfg)
    assert float(s1.loss) == float(s2.loss)
    assert torch.equal(p1, p2)
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        make_wtt_ba_solver(cfg, aot=True)
    with pytest.raises(ValueError, match="matvec_kernel must be"):
        make_wtt_ba_solver(cfg._replace(matvec_kernel="indx"))
