"""The port's batched PnP refinement (``solvers/pose_refine.py``) against JAX.

Each problem is built once from a seed with numpy by the JAX package's
``make_scene`` / ``perturb_scene`` / ``scene_to_pose_problem`` (f64, 0.5 px
observation noise, so the optimum has a nonzero loss) and carried across
with ``problems.convert.pose_problem_from_numpy``.  Every solve must give
the same ``iter_num`` and ``accepted`` per camera, loss to rtol 1e-8 and
parameters to rtol 1e-7 (atol 1e-9 for the rotation's near-zero entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import CAM_FIELDS, assert_close, np_fields, to_np

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.solvers import pose_refine as j_pose
from tpu3drecon.solvers.lm_core import LMConfig as JConfig

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.problems.convert import pose_problem_from_numpy
from tpu3drecon_torch.solvers import pose_refine as t_pose
from tpu3drecon_torch.solvers.lm_core import LMConfig as TConfig

PNP = dict(n_cameras=6, n_points=300, seed=3)
NOISE = dict(point3d_noise=0.0, camera_rotation_noise=2e-2, camera_translation_noise=5e-2,
             camera_intrinsics_noise=10.0, point2d_noise=0.5, seed=4)
# (loss, residual form, gtol): the scalar form's gradient is over width^2,
# so it takes a finer gtol to run past its first step.
SOLVES = [("TRIVIAL", "per_axis", 1e-7), ("CAUCHY", "per_axis", 1e-7),
          ("HUBER", "per_axis", 1e-7), ("TRIVIAL", "scalar", 1e-10),
          ("CAUCHY", "scalar", 1e-10)]


def _problem(scene_kw, noise_kw):
    scene = j_syn.make_scene(**scene_kw)
    noisy = j_syn.perturb_scene(scene, **noise_kw)
    problem, _ = j_syn.scene_to_pose_problem(noisy, dtype=jnp.float64)
    return problem


@pytest.fixture(scope="module")
def pnp():
    problem = _problem(PNP, NOISE)
    return problem, pose_problem_from_numpy(np_fields(problem), device="cpu")


def assert_same_lanes(state, jstate):
    np.testing.assert_array_equal(to_np(state.iter_num), np.asarray(jstate.iter_num))
    np.testing.assert_array_equal(to_np(state.accepted), np.asarray(jstate.accepted))
    np.testing.assert_allclose(to_np(state.loss), np.asarray(jstate.loss), rtol=1e-8)


@pytest.mark.parametrize("loss,form,gtol", SOLVES)
def test_refine_poses_matches_jax(pnp, loss, form, gtol):
    jprob, tprob = pnp
    cfg = dict(maxiter=100, gtol=gtol)
    jcams, jstate = j_pose.refine_poses(jprob, loss=JLoss[loss], config=JConfig(**cfg),
                                        residual_form=form)
    cams, state = t_pose.refine_poses(tprob, loss=TLoss[loss], config=TConfig(**cfg),
                                      residual_form=form, device="cpu")
    assert_same_lanes(state, jstate)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(to_np(getattr(cams, name)), np.asarray(getattr(jcams, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    assert int(to_np(state.accepted).sum()) > 0


def test_pose_refiner_tracking_shape():
    """``PoseRefiner.optimize`` on 32 frames of 200 observations each (the
    shape of tests/test_tracking.py), twice: the same result both times.
    TRIVIAL loss: under CAUCHY a few of these frames stall (the frozen-weight
    gradient is not the robust loss's), and a stalled lane's accept test
    compares losses equal to the last bit."""
    scene_kw = dict(n_cameras=32, n_points=400, obs_per_camera=200, seed=81)
    noise_kw = dict(point3d_noise=0.0, camera_rotation_noise=1e-2,
                    camera_translation_noise=3e-2, camera_intrinsics_noise=0.0,
                    point2d_noise=0.5, seed=82)
    jprob = _problem(scene_kw, noise_kw)
    tprob = pose_problem_from_numpy(np_fields(jprob), device="cpu")
    cfg = dict(maxiter=60, gtol=1e-7)
    jref = j_pose.PoseRefiner(float(jprob.avg_cam_width), JLoss.TRIVIAL, config=JConfig(**cfg))
    jparams, jstate = jref.optimize(j_pose.pose_params_pack(jprob.cameras), jprob.points3d,
                                    jprob.points2d, jprob.cameras.cx_cy_skew, jprob.mask)
    ref = t_pose.PoseRefiner(float(tprob.avg_cam_width), TLoss.TRIVIAL, config=TConfig(**cfg),
                             device="cpu")
    args = (t_pose.pose_params_pack(tprob.cameras), tprob.points3d, tprob.points2d,
            tprob.cameras.cx_cy_skew, tprob.mask)
    params, state = ref.optimize(*args)
    assert params.shape == (32, 8)
    assert_same_lanes(state, jstate)
    np.testing.assert_allclose(to_np(params), np.asarray(jparams), rtol=1e-7, atol=1e-9)
    again, _ = ref.optimize(*args)
    assert torch.equal(again, params)
    ref.compile(64, batch_size=4, dtype=torch.float64)  # the zeros warm-up runs


@pytest.mark.parametrize("loss,form", [(loss, form) for loss, form, _ in SOLVES])
def test_residual_jacobian_matches_jax(pnp, loss, form):
    """jacrev of the port's residual (the IRLS weights ``.detach()``-ed)
    equals jax.jacfwd of JAX's (``stop_gradient``): the frozen weights add
    no column terms."""
    jprob, tprob = pnp
    width = float(tprob.avg_cam_width) ** (1 if form == "per_axis" else 2)
    jfn = getattr(j_pose, f"pose_residuals_{form}")
    tfn = getattr(t_pose, f"pose_residuals_{form}")
    jp0 = j_pose.pose_params_pack(jprob.cameras)
    tp0 = t_pose.pose_params_pack(tprob.cameras)
    for c in (0, 3):
        jargs = (jprob.points3d[c], jprob.points2d[c], jprob.cameras.cx_cy_skew[c],
                 jprob.cameras.dist[c], jprob.mask[c], jnp.asarray(width))
        targs = (tprob.points3d[c], tprob.points2d[c], tprob.cameras.cx_cy_skew[c],
                 tprob.cameras.dist[c], tprob.mask[c], torch.tensor(width, dtype=torch.float64))
        want = jax.jacfwd(lambda p: jfn(p, *jargs, loss=JLoss[loss]))(jp0[c])
        got = torch.func.jacrev(lambda p: tfn(p, *targs, loss=TLoss[loss]))(tp0[c])
        assert_close(got, want, 1e-10, atol_rel=1e-12)
        assert_close(tfn(tp0[c], *targs, loss=TLoss[loss]),
                     jfn(jp0[c], *jargs, loss=JLoss[loss]), 1e-12, atol_rel=1e-14)


def test_float32_solve(pnp):
    """At float32 the batched jacfwd keeps every tangent float32 (forward
    mode promotes a 0-dim float32 tensor times a Python float to float64,
    which the rotation maps avoid) and lands near the float64 solution."""
    _, tprob = pnp
    p32 = tprob.to("cpu")
    p32 = type(p32)(
        cameras=type(p32.cameras)(**{n: getattr(p32.cameras, n).float() for n in CAM_FIELDS}),
        points3d=p32.points3d.float(), points2d=p32.points2d.float(), mask=p32.mask.float(),
        avg_cam_width=p32.avg_cam_width.float())
    cfg = TConfig(maxiter=100, gtol=1e-7)
    cams32, state = t_pose.refine_poses(p32, loss=TLoss.TRIVIAL, config=cfg, device="cpu")
    cams64, _ = t_pose.refine_poses(tprob, loss=TLoss.TRIVIAL, config=cfg, device="cpu")
    assert state.jac.dtype == cams32.tvecs.dtype == torch.float32
    assert torch.isfinite(state.loss).all() and int(state.accepted.min()) > 0
    np.testing.assert_allclose(to_np(cams32.tvecs), to_np(cams64.tvecs), atol=1e-3)
    np.testing.assert_allclose(to_np(cams32.fx_fy), to_np(cams64.fx_fy), rtol=1e-4)


def test_pack_unpack_round_trip(pnp):
    jprob, tprob = pnp
    params = t_pose.pose_params_pack(tprob.cameras)
    assert_close(params, j_pose.pose_params_pack(jprob.cameras), 1e-12, atol_rel=1e-15)
    cams = t_pose.pose_params_unpack(params, tprob.cameras.cx_cy_skew, tprob.cameras.dist)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(to_np(getattr(cams, name)),
                                   to_np(getattr(tprob.cameras, name)), rtol=1e-12, atol=1e-14)


def test_aot_and_residual_form_refused(pnp):
    _, tprob = pnp
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        t_pose.refine_poses(tprob, aot=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        t_pose.PoseRefiner(1000.0, aot=True, device="cpu")
    with pytest.raises(ValueError, match="residual_form"):
        t_pose.PoseRefiner(1000.0, residual_form="dense", device="cpu")


def test_scene_to_pose_problem_matches_jax():
    """The port's packing of a scene equals the JAX package's array for
    array (f64 and f32)."""
    for dtype, jdtype in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        scene_kw = dict(n_cameras=5, n_points=300, obs_per_camera=120, seed=9)
        jscene = j_syn.make_scene(**scene_kw)
        jprob, jmeta = j_syn.scene_to_pose_problem(
            j_syn.perturb_scene(jscene, seed=10), observed=jscene, dtype=jdtype)
        tscene = t_syn.make_scene(**scene_kw)
        tprob, tmeta = t_syn.scene_to_pose_problem(
            t_syn.perturb_scene(tscene, seed=10), observed=tscene, dtype=dtype, device="cpu")
        want = np_fields(jprob)
        for name in ("points3d", "points2d", "mask", "avg_cam_width"):
            np.testing.assert_array_equal(to_np(getattr(tprob, name)), want[name], err_msg=name)
        for name in CAM_FIELDS:
            np.testing.assert_array_equal(to_np(getattr(tprob.cameras, name)),
                                          want["cameras"][name], err_msg=name)
        assert (tprob.batch, tprob.max_points) == (jprob.batch, jprob.max_points)
        assert tmeta.n_real_obs == jmeta.n_real_obs


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA default")
def test_entry_points_default_to_the_card(pnp):
    """Without ``device`` the entry points target CUDA and raise here."""
    jprob, tprob = pnp
    scene = t_syn.make_scene(n_cameras=2, n_points=50, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_syn.scene_to_pose_problem(scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pose_problem_from_numpy(np_fields(jprob))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pose.refine_poses(tprob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pose.PoseRefiner(1000.0)
