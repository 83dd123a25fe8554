"""The slice: the port's fully indexed ``ba_solve_wtt`` vs the JAX reference.

One module-scoped JAX solve per fixture (the sequential scene of
tests/test_ba_wtt.py, pinhole and radial): ``ba_solve_wtt`` with
``matvec_kernel="index"``, ``linearize_kernel="index"`` (Pallas in interpret
mode on the CPU), 5 LM iterations.  The port solves the same packed
problem, carried across with ``problems.convert``, in f64 on the CPU
(plain kernel versions).  Trajectory: equal ``iter_num`` and ``accepted``,
loss to rtol 1e-8 (the rtol of tests/test_ba_wtt.py), cameras and points
to rtol 1e-7 / atol 1e-9 (CG reductions are summed in different orders).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import SEQ_DISTS, assert_close, np_fields, seq_scene_kwargs

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.bundle_adjust import reprojection_rmse as j_rmse

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.problems.convert import ba_problem_from_numpy, wtt_problem_from_numpy
from tpu3drecon_torch.problems.wtt import wtt_from_flat as t_wtt
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig
from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse as t_rmse

SOLVE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4,
             matvec_kernel="index", linearize_kernel="index")
CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


@pytest.fixture(scope="module", params=list(SEQ_DISTS))
def reference(request):
    """(JAX flat problem, JAX packed problem, JAX solve result)."""
    scene = j_syn.make_sequential_scene(**seq_scene_kwargs(SEQ_DISTS[request.param]))
    noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    packed = j_wtt(flat, point_chunk=64, defer_onehot=True)
    return flat, packed, j_solve(packed, JConfig(**SOLVE)), request.param


def _port_packed(dist):
    kw = seq_scene_kwargs(SEQ_DISTS[dist])
    scene = t_syn.make_sequential_scene(**kw)
    noisy = t_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = t_syn.scene_to_ba_problem(noisy, observed=scene, dtype=torch.float64,
                                        device="cpu")
    return flat, t_wtt(flat, point_chunk=64)


def test_slice_matches_jax(reference):
    flat, packed, (jcams, jpts, jstate), _ = reference
    cams, pts, state = t_solve(wtt_problem_from_numpy(np_fields(packed), device="cpu"),
                               TConfig(**SOLVE))
    assert state.iter_num == int(jstate.iter_num) == 5
    assert int(state.accepted) == int(jstate.accepted)
    assert state.cg_iters == int(jstate.cg_iters)
    np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-8)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(getattr(cams, name).numpy(),
                                   np.asarray(getattr(jcams, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-7, atol=1e-9)
    # The evaluation metric on the flat problem, same cameras and points.
    assert_close(t_rmse(ba_problem_from_numpy(np_fields(flat), device="cpu"), cams, pts),
                 j_rmse(flat, jcams, jpts), 1e-6)


def test_converted_and_port_packed_solve_identically(reference):
    """The JAX-packed problem carried across and the port's own packing of
    the same scene give bit-identical solves."""
    _, packed, _, dist = reference
    cfg = TConfig(**SOLVE)
    c1, p1, s1 = t_solve(wtt_problem_from_numpy(np_fields(packed), device="cpu"), cfg)
    _, own = _port_packed(dist)
    c2, p2, s2 = t_solve(own, cfg)
    assert float(s1.loss) == float(s2.loss)
    for name in CAM_FIELDS:
        np.testing.assert_array_equal(getattr(c1, name).numpy(), getattr(c2, name).numpy())
    np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def test_jacobi_u_preconditioner_descends():
    flat, packed = _port_packed("pinhole")
    init = t_rmse(flat, flat.cameras, flat.points3d)
    cams, pts, state = t_solve(packed, TConfig(**{**SOLVE, "precond": "jacobi_u"}))
    assert int(state.accepted) >= 3
    assert float(t_rmse(flat, cams, pts)) < 0.1 * float(init)


@pytest.mark.parametrize("change", [
    {"matvec_kernel": "index1"}, {"linearize_kernel": "index2"},
    {"matvec_kernel": False, "matvec_bf16": True},
    {"matvec_kernel": "index2"},
])
def test_unported_paths_raise(change, reference):
    """``matvec_bf16`` alone is not ported and raises; the reduced-fidelity
    modes solve, in f64 exactly as the reference (which never splits f64)
    and as the exact fully indexed route."""
    _, packed, (_, _, jstate), dist = reference
    _, own = _port_packed(dist)
    if change.get("matvec_bf16"):
        with pytest.raises(NotImplementedError):
            t_solve(own, TConfig(**{**SOLVE, **change}))
        return
    _, _, state = t_solve(own, TConfig(**{**SOLVE, **change}))
    assert state.iter_num == int(jstate.iter_num)
    assert int(state.accepted) == int(jstate.accepted)
    assert state.cg_iters == int(jstate.cg_iters)
    np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-8)


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["tpu3drecon"] = None   # and so does the JAX package
import torch
import tpu3drecon_torch
for m in pkgutil.walk_packages(tpu3drecon_torch.__path__, "tpu3drecon_torch."):
    importlib.import_module(m.name)
from tpu3drecon_torch.dataset.synthetic import make_sequential_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon_torch.problems.wtt import wtt_from_flat
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig
torch.set_num_threads(1)
scene = make_sequential_scene(n_cameras=12, points_per_camera=20, track_span=3, seed=1)
flat, _ = scene_to_ba_problem(perturb_scene(scene, seed=2, point2d_noise=0.0), observed=scene,
                              dtype=torch.float64, device="cpu")
cfg = BAConfig(maxiter=3, cg_maxiter=8, matvec_kernel="index", linearize_kernel="index")
packed = wtt_from_flat(flat, point_chunk=64)
_, _, st = ba_solve_wtt(packed, cfg)
assert int(st.accepted) >= 1, st
_, _, st_xla = ba_solve_wtt(packed, BAConfig(maxiter=3, cg_maxiter=8))  # route (d), the default
assert int(st_xla.accepted) >= 1, st_xla
from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat
from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas
_, _, st_grid = ba_solve_pallas(grid_bucketed_from_flat(flat, point_block=64), cfg)
assert int(st_grid.accepted) >= 1, st_grid
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("NO_JAX_OK", float(st.loss))
"""


def test_port_imports_and_solves_without_jax():
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout
