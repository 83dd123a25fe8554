"""The port's projection, losses and rotation algebra against the JAX package.

Inputs are built once from a seed with numpy and go through
``tpu3drecon.geometry`` (CPU, x64, the ``*_batch`` / vmapped forms) and
``tpu3drecon_torch.geometry`` (CPU, float64, broadcasting forms); outputs
agree to rtol 1e-12 (the same float64 operations, summed in another
order at most).  The rotation maps are checked at theta = 0, theta ~ 0
and theta ~ pi, and their Jacobians at theta = 0 (finite, through the
double-``where`` guards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_ref import assert_close, to_np

from tpu3drecon.geometry import losses as j_losses
from tpu3drecon.geometry import projection as j_proj
from tpu3drecon.geometry import rotations as j_rot

from tpu3drecon_torch.geometry import losses as t_losses
from tpu3drecon_torch.geometry import projection as t_proj
from tpu3drecon_torch.geometry import rotations as t_rot

RTOL = 1e-12
DISTS = {"pinhole": (0.0, 0.0), "radial": (-0.12, 0.02)}


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def cameras(rng, b):
    """b W2C cameras looking down +z at points ~5 units away."""
    rmats = Rotation.from_rotvec(rng.normal(scale=0.2, size=(b, 3))).as_matrix()
    tvecs = np.concatenate([rng.normal(scale=0.3, size=(b, 2)),
                            rng.uniform(4.0, 6.0, size=(b, 1))], axis=1)
    fx_fy = rng.uniform(900, 1100, size=(b, 2))
    ccs = np.concatenate([rng.uniform(600, 680, size=(b, 2)),
                          rng.normal(scale=0.5, size=(b, 1))], axis=1)
    return rmats, tvecs, fx_fy, ccs


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    b, n = 4, 37
    rmats, tvecs, fx_fy, ccs = cameras(rng, b)
    pts = rng.normal(size=(b, n, 3))
    uv = rng.uniform(300, 1000, size=(b, n, 2))
    mask = (rng.random((b, n)) > 0.2).astype(np.float64)
    pts[mask == 0] = 0.0  # padded rows carry (0, 0, 0) points
    return rmats, tvecs, fx_fy, ccs, pts, uv, mask


@pytest.mark.parametrize("dist", list(DISTS))
def test_projection_matches_jax(scene, dist):
    rmats, tvecs, fx_fy, ccs, pts, uv, mask = scene
    d = np.tile(np.asarray(DISTS[dist]), (len(rmats), 1))
    jargs = [jnp.asarray(a) for a in (rmats, tvecs, fx_fy, ccs, d, pts)]
    targs = [_t(a) for a in (rmats, tvecs, fx_fy, ccs, d, pts)]
    assert_close(t_proj.project_points_batched(*targs),
                 j_proj.project_points_batched(*jargs), RTOL)
    # One camera: project_points, the masked residuals, K, and the pieces.
    for c in range(len(rmats)):
        one_j = [a[c] for a in jargs]
        one_t = [a[c] for a in targs]
        assert_close(t_proj.project_points(*one_t), j_proj.project_points(*one_j), RTOL)
        res_t = t_proj.reprojection_residuals(*one_t, _t(uv[c]), _t(mask[c]))
        res_j = j_proj.reprojection_residuals(*one_j, jnp.asarray(uv[c]),
                                              jnp.asarray(mask[c]))
        assert_close(res_t, res_j, RTOL)
        assert np.all(to_np(res_t)[mask[c] == 0] == 0.0)  # padding gives exact zeros
        assert_close(t_proj.make_intrinsics_matrix(one_t[2], one_t[3]),
                     j_proj.make_intrinsics_matrix(one_j[2], one_j[3]), 0.0)
    xc_j = jax.vmap(j_proj.world_to_camera, in_axes=(None, None, 0))(
        jargs[0][0], jargs[1][0], jargs[5][0])
    xc_t = t_proj.world_to_camera(targs[0][0], targs[1][0], targs[5][0])
    assert_close(xc_t, xc_j, RTOL)
    m = xc_t[:, :2] / xc_t[:, 2:3]
    assert_close(t_proj.radial_factor(m, targs[4][0]),
                 jax.vmap(j_proj.radial_factor, in_axes=(0, None))(jnp.asarray(to_np(m)),
                                                                   jargs[4][0]), RTOL)
    assert_close(t_proj.perspective_project(xc_t, *(a[0] for a in targs[2:5])),
                 jax.vmap(j_proj.perspective_project, in_axes=(0, None, None, None))(
                     xc_j, *(a[0] for a in jargs[2:5])), RTOL)


def test_batched_intrinsics_matrix():
    rng = np.random.default_rng(2)
    _, _, fx_fy, ccs = cameras(rng, 5)
    assert_close(t_proj.make_intrinsics_matrix(_t(fx_fy), _t(ccs)),
                 jax.vmap(j_proj.make_intrinsics_matrix)(jnp.asarray(fx_fy), jnp.asarray(ccs)),
                 0.0)


def test_scalar_losses_match_jax():
    rng = np.random.default_rng(3)
    y, x = rng.normal(size=(2, 50, 2)) * 3.0
    assert_close(t_losses.l2_loss(_t(y), _t(x)), j_losses.l2_loss(jnp.asarray(y), jnp.asarray(x)),
                 RTOL)
    for scale in (1.0, 0.5):
        assert_close(t_losses.cauchy_loss(_t(y), _t(x), scale),
                     j_losses.cauchy_loss(jnp.asarray(y), jnp.asarray(x), scale), RTOL)


def rotation_cases():
    """Rotation vectors: random, theta = 0, theta ~ 1e-5 (below the Taylor
    switch), theta just under pi and exactly pi about a few axes."""
    rng = np.random.default_rng(5)
    axes = rng.normal(size=(4, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.concatenate([
        rng.normal(scale=1.0, size=(16, 3)),
        np.zeros((1, 3)),
        axes * 1e-5,
        axes * (np.pi - 1e-7),
        axes * np.pi,
        np.eye(3) * np.pi,
    ])


@pytest.mark.parametrize("name", ["rodrigues_to_matrix", "rodrigues_to_quat"])
def test_from_rodrigues_matches_jax(name):
    rv = rotation_cases()
    got = getattr(t_rot, f"{name}_batch")(_t(rv))
    want = getattr(j_rot, f"{name}_batch")(jnp.asarray(rv))
    assert_close(got, want, RTOL, atol_rel=1e-15)
    assert_close(getattr(t_rot, name)(_t(rv[0])), getattr(j_rot, name)(jnp.asarray(rv[0])),
                 RTOL, atol_rel=1e-15)


def test_from_matrix_matches_jax():
    """matrix -> quaternion (Shepperd, w >= 0) -> Rodrigues, and back."""
    rmats = Rotation.from_rotvec(rotation_cases()).as_matrix()
    q_t = t_rot.matrix_to_quat_batch(_t(rmats))
    q_j = j_rot.matrix_to_quat_batch(jnp.asarray(rmats))
    assert_close(q_t, q_j, RTOL, atol_rel=1e-15)
    assert_close(t_rot.matrix_to_rodrigues_batch(_t(rmats)),
                 j_rot.matrix_to_rodrigues_batch(jnp.asarray(rmats)), 1e-9, atol_rel=1e-12)
    assert_close(t_rot.quat_to_rodrigues_batch(q_t), j_rot.quat_to_rodrigues_batch(q_j),
                 1e-9, atol_rel=1e-12)
    assert_close(t_rot.quat_to_matrix_batch(q_t), j_rot.quat_to_matrix_batch(q_j), RTOL,
                 atol_rel=1e-15)
    assert_close(t_rot.matrix_to_rodrigues(_t(rmats[3])),
                 j_rot.matrix_to_rodrigues(jnp.asarray(rmats[3])), RTOL)
    # A negative-w quaternion maps to the same Rodrigues vector as -q.
    q = np.array([-0.6, 0.48, 0.0, 0.64])
    assert_close(t_rot.quat_to_rodrigues(_t(q)), j_rot.quat_to_rodrigues(jnp.asarray(q)), RTOL)


def test_matrix_to_quat_ties_pick_the_first_seed():
    """A rotation by 2 pi / 3 about (1, 1, 1) permutes the axes: its four
    Shepperd seeds tie at 1, and jnp.argmax takes the first (w)."""
    perm = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    got = t_rot.matrix_to_quat(_t(perm))
    want = j_rot.matrix_to_quat(jnp.asarray(perm))
    assert_close(got, want, 0.0)
    np.testing.assert_allclose(to_np(got), [0.5, 0.5, 0.5, 0.5], rtol=1e-15)


def test_quaternion_algebra_matches_jax():
    rng = np.random.default_rng(7)
    qa, qb = rng.normal(size=(2, 9, 4))
    qa /= np.linalg.norm(qa, axis=1, keepdims=True)
    v = rng.normal(size=(9, 3))
    assert_close(t_rot.quat_mul(_t(qa), _t(qb)),
                 jax.vmap(j_rot.quat_mul)(jnp.asarray(qa), jnp.asarray(qb)), RTOL)
    assert_close(t_rot.quat_rotate(_t(qa), _t(v)),
                 jax.vmap(j_rot.quat_rotate)(jnp.asarray(qa), jnp.asarray(v)), RTOL)
    assert_close(t_rot.xyzw_to_wxyz(_t(qa)), j_rot.xyzw_to_wxyz(jnp.asarray(qa)), 0.0)
    assert_close(t_rot.wxyz_to_xyzw(_t(qa)), j_rot.wxyz_to_xyzw(jnp.asarray(qa)), 0.0)
    assert_close(t_rot.skew(_t(v)), jax.vmap(j_rot.skew)(jnp.asarray(v)), 0.0)


@pytest.mark.parametrize("name", ["rodrigues_to_matrix", "rodrigues_to_quat"])
def test_jacobian_finite_at_zero(name):
    """torch.func.jacfwd through the guarded maps at theta = 0 equals
    jax.jacfwd and is finite."""
    zero = np.zeros(3)
    got = torch.func.jacfwd(getattr(t_rot, name))(_t(zero))
    want = jax.jacfwd(getattr(j_rot, name))(jnp.asarray(zero))
    assert np.all(np.isfinite(to_np(got)))
    assert_close(got, want, RTOL, atol_rel=1e-15)
