"""PyTorch port vs JAX reference: rotations, robust losses, Jacobian blocks,
the SE(3) retraction and the track-table plane helpers (f64, CPU).

Tolerance: rtol 1e-12 — both sides evaluate the same formulas in f64; the
absolute floor of 1e-12 * max|ref| covers entries that are differences of
nearly equal terms (residuals of exact projections, rotation entries near 0)
where the two libraries' last-bit rounding differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.geometry.losses import robust_weight as j_robust_weight
from tpu3drecon.geometry.rotations import rodrigues_to_matrix as j_rodrigues
from tpu3drecon.geometry.rotations import skew as j_skew
from tpu3drecon.ops.jacobians import apply_se3_retraction as j_retract
from tpu3drecon.ops.jacobians import gather_obs_blocks as j_gather
from tpu3drecon.solvers import ba_tt as j_ba_tt
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.geometry.losses import robust_weight as t_robust_weight
from tpu3drecon_torch.geometry.rotations import rodrigues_to_matrix as t_rodrigues
from tpu3drecon_torch.geometry.rotations import skew as t_skew
from tpu3drecon_torch.ops.jacobians import apply_se3_retraction as t_retract
from tpu3drecon_torch.ops.jacobians import gather_obs_blocks as t_gather
from tpu3drecon_torch.solvers import ba_tt as t_ba_tt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

RTOL = 1e-12
LOSSES = ["trivial", "cauchy", "huber"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _rvecs():
    rng = np.random.default_rng(11)
    big = rng.normal(scale=0.8, size=(40, 3))
    small = rng.normal(scale=1e-5, size=(8, 3))  # theta^2 < 1e-8: Taylor branch
    return np.concatenate([big, small, np.zeros((1, 3))])


def test_loss_values_match():
    assert [l.value for l in TLoss] == [l.value for l in JLoss]


def test_skew_and_rodrigues():
    rv = _rvecs()
    assert ((rv * rv).sum(axis=1) < 1e-8).sum() == 9
    assert_close(t_skew(_t(rv)), jax.vmap(j_skew)(jnp.asarray(rv)), RTOL)
    assert_close(
        t_rodrigues(_t(rv)), jax.vmap(j_rodrigues)(jnp.asarray(rv)), RTOL, 1e-12
    )


@pytest.mark.parametrize("loss", LOSSES)
def test_robust_weight(loss):
    s = np.concatenate([np.random.default_rng(2).uniform(0, 5, 64), [0.0, 1.0]])
    assert_close(
        t_robust_weight(TLoss(loss), _t(s)),
        j_robust_weight(JLoss(loss), jnp.asarray(s)),
        RTOL,
    )


@pytest.fixture(scope="module")
def flat_scene():
    scene = make_scene(n_cameras=6, n_points=80, seed=3, dist=(-0.04, 0.01))
    return perturb_scene(scene, seed=4), scene


@pytest.mark.parametrize("loss", LOSSES)
def test_gather_obs_blocks(flat_scene, loss):
    noisy, obs = flat_scene
    rng = np.random.default_rng(5)
    mask = (rng.random(len(obs.uv)) < 0.9).astype(np.float64)
    args = (noisy.rmats, noisy.tvecs, noisy.fx_fy, noisy.cx_cy_skew,
            noisy.dist, noisy.points3d, obs.cam_idx, obs.pt_idx, obs.uv, mask)
    want = j_gather(*(jnp.asarray(a) for a in args), jnp.asarray(1.0 / 1280.0),
                    JLoss(loss))
    got = t_gather(*(_t(a) for a in args), 1.0 / 1280.0, TLoss(loss))
    for name, g, w in zip(("residual", "j_cam", "j_pt"), got, want):
        assert_close(g, w, RTOL, 1e-12, err_msg=name)


def test_apply_se3_retraction(flat_scene):
    noisy, _ = flat_scene
    rng = np.random.default_rng(6)
    step = rng.normal(scale=0.05, size=(noisy.n_cameras, 8))
    step[0, :3] = 0.0  # zero rotation step
    step[1, :3] = 1e-6  # Taylor branch
    args = (noisy.rmats, noisy.tvecs, noisy.fx_fy, step)
    want = j_retract(*(jnp.asarray(a) for a in args))
    got = t_retract(*(_t(a) for a in args))
    for g, w in zip(got, want):
        assert_close(g, w, RTOL, 1e-12)


def test_sym3_inverse_and_unpack():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(50, 3, 3))
    spd = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)
    v6 = np.stack([spd[:, 0, 0], spd[:, 0, 1], spd[:, 0, 2],
                   spd[:, 1, 1], spd[:, 1, 2], spd[:, 2, 2]])
    assert_close(t_ba_tt._sym3_inv_planes(_t(v6)),
                 j_ba_tt._sym3_inv_planes(jnp.asarray(v6)), 1e-10, 1e-12)
    assert t_ba_tt._triu_pairs(10) == j_ba_tt._triu_pairs(10)
    cols = rng.normal(size=(7, 36))
    assert_close(t_ba_tt._unpack_sym(_t(cols), 8),
                 j_ba_tt._unpack_sym(jnp.asarray(cols), 8), 0.0)


@pytest.mark.parametrize(
    "loss,flags",
    [
        ("trivial", {}),
        ("cauchy", {"optimize_dist": True}),
        ("huber", {"optimize_pp": True, "optimize_focal": False}),
        ("trivial", {"optimize_dist": True, "optimize_pp": True,
                     "optimize_points": False}),
    ],
)
def test_tt_blocks(flat_scene, loss, flags):
    noisy, obs = flat_scene
    rng = np.random.default_rng(9)
    cams = np.concatenate(
        [noisy.rmats.reshape(-1, 9), noisy.tvecs, noisy.fx_fy,
         noisy.cx_cy_skew, noisy.dist], axis=1
    )  # the _cam_table layout
    n = len(obs.uv)
    cp = cams[obs.cam_idx].T.reshape(19, 1, n)
    pts = noisy.points3d[obs.pt_idx].T.reshape(3, 1, n)
    uv = obs.uv.T.reshape(2, 1, n)
    mask = (rng.random((1, n)) < 0.9).astype(np.float64)
    jcfg = JConfig(loss=JLoss(loss), **flags)
    tcfg = TConfig(loss=TLoss(loss), **flags)
    # JAX's planes take the point axis alone and broadcast it over Tb.
    want = j_ba_tt._tt_blocks(*(jnp.asarray(a) for a in (cp, pts[:, 0], uv, mask)),
                              jnp.asarray(1.0 / 1280.0), jcfg)
    got = t_ba_tt._tt_blocks(*(_t(a) for a in (cp, pts, uv, mask)),
                             1.0 / 1280.0, tcfg)
    for name, g, w in zip(("r", "jc", "jp"), got, want):
        assert_close(g, w, RTOL, 1e-12, err_msg=name)
