"""The slice: the port's fused-kernel grid engine ``ba_solve_pallas`` vs the
JAX reference.

One module-scoped scene (8 cameras, 300 points, 120 observations per
camera, 0.5 px observation noise so the loss stays above the noise floor),
packed by the JAX package in both grid layouts: ``grid_from_flat`` and
``grid_bucketed_from_flat`` (four track buckets).  The JAX
``ba_solve_pallas`` runs its kernels in interpret mode at f64; the port
solves the same packed problem, carried across with ``problems.convert``,
at f64 on the CPU (plain kernel versions).  Fixed work: 5 LM iterations,
``gtol=ftol=0``, 8 CG iterations.  Trajectory: equal ``iter_num``,
``accepted`` and ``cg_iters``, loss to rtol 1e-8, cameras and points to
rtol 1e-7 / atol 1e-9 (the plane contractions are summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, np_fields

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.problems.grid import grid_bucketed_from_flat as j_bucketed
from tpu3drecon.problems.grid import grid_from_flat as j_grid
from tpu3drecon.solvers.ba_pallas import ba_solve_pallas as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig
from tpu3drecon.solvers.bundle_adjust import reprojection_rmse as j_rmse

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.ops import cam_normal, coupling, point_normal
from tpu3drecon_torch.problems.convert import (
    ba_problem_from_numpy,
    grid_bucketed_problem_from_numpy,
    grid_problem_from_numpy,
)
from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat as t_bucketed
from tpu3drecon_torch.problems.grid import grid_from_flat as t_grid
from tpu3drecon_torch.solvers.ba_pallas import ba_solve_pallas as t_solve
from tpu3drecon_torch.solvers.ba_pallas import make_pallas_ba_solver
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig
from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse as t_rmse

SOLVE = dict(maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")
LAYOUTS = {
    "grid": (lambda flat: j_grid(flat), grid_problem_from_numpy),
    "bucketed": (lambda flat: j_bucketed(flat, point_block=64),
                 grid_bucketed_problem_from_numpy),
}


@pytest.fixture(scope="module")
def flat():
    scene = j_syn.make_scene(n_cameras=8, n_points=300, obs_per_camera=120, seed=71)
    noisy = j_syn.perturb_scene(scene, seed=72, point2d_noise=0.5)
    problem, _ = j_syn.scene_to_ba_problem(noisy, observed=noisy, dtype=jnp.float64)
    return problem


def _packed(flat, layout):
    """(JAX packed problem, the port's copy of it on the CPU)."""
    pack, convert = LAYOUTS[layout]
    packed = pack(flat)
    return packed, convert(np_fields(packed), device="cpu")


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slice_matches_jax(flat, layout, loss):
    packed, port = _packed(flat, layout)
    if layout == "bucketed":
        assert len(packed.buckets) == 4
    jcams, jpts, jstate = j_solve(packed, JConfig(**SOLVE, loss=JLoss(loss)), interpret=True)
    counts = (cam_normal.COUNTS, point_normal.COUNTS, coupling.COUNTS)
    before = [c.plain for c in counts]
    cams, pts, state = t_solve(port, TConfig(**SOLVE, loss=TLoss(loss)))
    # Each LM iteration linearizes once: B9 and B11 once, B10 per bucket.
    n_buckets = len(packed.buckets) if layout == "bucketed" else 1
    assert [c.plain - b for c, b in zip(counts, before)] == [5, 5 * n_buckets, 5]

    assert state.iter_num == int(jstate.iter_num) == 5
    assert int(state.accepted) == int(jstate.accepted)
    assert state.cg_iters == int(jstate.cg_iters)
    np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-8)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(getattr(cams, name).numpy(),
                                   np.asarray(getattr(jcams, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    assert pts.shape == (flat.n_points, 3)  # bucketed: un-permuted
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(state.points3d.numpy(), pts.numpy())
    assert_close(t_rmse(ba_problem_from_numpy(np_fields(flat), device="cpu"), cams, pts),
                 j_rmse(flat, jcams, jpts), 1e-6)


def test_port_packed_and_converted_solve_identically(flat):
    """The port's own packers on the same flat problem give the same solves
    as the JAX-packed problems carried across, bit for bit."""
    t_flat = ba_problem_from_numpy(np_fields(flat), device="cpu")
    solver = make_pallas_ba_solver(TConfig(**SOLVE))
    for layout, own in (("grid", t_grid(t_flat)),
                        ("bucketed", t_bucketed(t_flat, point_block=64))):
        _, port = _packed(flat, layout)
        c1, p1, s1 = solver(port)
        c2, p2, s2 = solver(own)
        assert float(s1.loss) == float(s2.loss)
        for name in CAM_FIELDS:
            np.testing.assert_array_equal(getattr(c1, name).numpy(),
                                          getattr(c2, name).numpy())
        np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def test_pose_only_and_fixed_focal_descend(flat):
    """optimize_points=False / optimize_focal=False zero the point Jacobian
    and the focal planes after B9: points and focal lengths stay put."""
    _, port = _packed(flat, "bucketed")
    cfg = TConfig(**SOLVE, optimize_points=False, optimize_focal=False,
                  precond="jacobi_u")
    _, _, init = t_solve(port, cfg._replace(maxiter=0))
    cams, pts, state = t_solve(port, cfg)
    t_flat = ba_problem_from_numpy(np_fields(flat), device="cpu")
    np.testing.assert_array_equal(pts.numpy(), t_flat.points3d.numpy())
    np.testing.assert_array_equal(cams.fx_fy.numpy(), t_flat.cameras.fx_fy.numpy())
    assert int(state.accepted) >= 1
    assert float(state.loss) < float(init.loss)


@pytest.mark.parametrize("change,error", [
    ({"optimize_pp": True}, ValueError),
    ({"optimize_dist": True}, ValueError),
    ({"precond": "ssor"}, ValueError),
    ({"precond": "tridiag"}, ValueError),
    ({"packed_gathers": True}, NotImplementedError),
])
def test_unsupported_options_raise(flat, change, error):
    _, port = _packed(flat, "grid")
    with pytest.raises(error):
        t_solve(port, TConfig(**{**SOLVE, **change}))
    with pytest.raises(error):
        make_pallas_ba_solver(TConfig(**{**SOLVE, **change}))
