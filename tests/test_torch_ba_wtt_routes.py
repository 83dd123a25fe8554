"""Route (a) of the port's ``ba_solve_wtt`` vs the JAX reference: the
unfused linearization (kernels B7 and B8) with the index matvec (B2), its
rhs from B5 and back-substitution from B3 (``linearize_kernel=False``,
``matvec_kernel="index"``), under the three robust losses.

One module-scoped JAX solve per case (the sequential scene of
tests/test_ba_wtt.py, packed with its dense one-hot; Pallas in interpret
mode on the CPU), 5 LM iterations; the port solves the same packed
problem, carried across with ``problems.convert``, in f64 on the CPU
(plain kernel versions).  Tolerances: ``_torch_ref.assert_same_solve``.
Routes (b)-(d) are in tests/test_torch_ba_wtt_onehot_routes.py.
"""

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
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

CASES = {  # id -> (route, loss, scene distortion, preconditioner)
    "trivial": ("a", "trivial", "pinhole", "schur_jacobi"),
    "cauchy": ("a", "cauchy", "radial", "schur_jacobi"),
    "huber": ("a", "huber", "pinhole", "schur_jacobi"),
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
