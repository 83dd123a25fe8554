"""The port's block-tridiagonal and block-SSOR preconditioners
(``tpu3drecon_torch/solvers/tridiag.py``) vs the JAX functions.

The same numpy-built blocks (the random block-tridiagonal matrices of
tests/test_tridiag.py) go through both packages in f64.  The factors, the
solves and the matvecs must agree to rtol 1e-12 (atol 1e-12 * max|ref|):
both sides run the same block algebra step for step, LAPACK underneath.
The guard case (off-diagonal scale 80) must take the same fallback steps:
``w_used`` is zero at exactly the same steps on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close

from tpu3drecon.solvers import tridiag as jt

from tpu3drecon_torch.solvers import tridiag as tt

RTOL, ATOL_REL = 1e-12, 1e-12


def _blocks(c, n, scale, seed):
    """(d, e): the diagonal and upper band blocks of a random SPD matrix,
    the band scaled by ``scale`` (tests/test_tridiag.py)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c * n, c * n))
    a = a @ a.T + c * n * np.eye(c * n)
    d = np.stack([a[i * n:(i + 1) * n, i * n:(i + 1) * n] for i in range(c)])
    e = np.stack([a[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] * scale if i + 1 < c
                  else np.zeros((n, n)) for i in range(c)])
    return d, e, rng.normal(size=(c, n))


def _t(x):
    return torch.as_tensor(np.asarray(x))


CASES = {  # id -> (C, n, off-diagonal scale, segments)
    "chain": (10, 5, 1.0, 1),
    "segmented": (12, 4, 1.0, 4),
    "c256": (256, 8, 1.0, 2),
    "guard": (8, 4, 80.0, 1),
    "guard_segmented": (16, 4, 80.0, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tridiag_matches_jax(case):
    c, n, scale, seg = CASES[case]
    d, e, r = _blocks(c, n, scale, seed=c + n)
    jf = jt.tridiag_factor(jnp.asarray(d), jnp.asarray(e), segments=seg)
    tf = tt.tridiag_factor(_t(d), _t(e), segments=seg)
    for name in ("l_blocks", "w_blocks", "w_used"):
        assert_close(getattr(tf, name), getattr(jf, name), RTOL, ATOL_REL, err_msg=name)
    dropped = ~np.asarray(jf.w_used).any(axis=(1, 2))
    assert np.array_equal(~tf.w_used.numpy().any(axis=(1, 2)), dropped)
    if scale > 1:  # the guard dropped interfaces beyond the segment starts
        assert dropped.sum() > seg
    assert_close(tt.tridiag_solve(tf, _t(r), segments=seg),
                 jt.tridiag_solve(jf, jnp.asarray(r), segments=seg), RTOL, ATOL_REL)


@pytest.mark.parametrize("case", list(CASES))
def test_ssor_matches_jax(case):
    c, n, scale, seg = CASES[case]
    scale = min(scale, 6.0)  # scale 80 makes M numerically singular (test_tridiag.py)
    d, e, r = _blocks(c, n, scale, seed=2 * c + n)
    jf = jt.ssor_factor(jnp.asarray(d), jnp.asarray(e), segments=seg)
    tf = tt.ssor_factor(_t(d), _t(e), segments=seg)
    assert_close(tf.d_chol, jf.d_chol, RTOL, ATOL_REL, err_msg="d_chol")
    np.testing.assert_array_equal(tf.e_blocks.numpy(), np.asarray(jf.e_blocks))
    assert_close(tt.ssor_solve(tf, _t(r), segments=seg),
                 jt.ssor_solve(jf, jnp.asarray(r), segments=seg), RTOL, ATOL_REL)
    assert_close(tt.ssor_matvec(_t(d), _t(e), _t(r), segments=seg),
                 jt.ssor_matvec(jnp.asarray(d), jnp.asarray(e), jnp.asarray(r),
                                segments=seg), RTOL, ATOL_REL)


@pytest.mark.parametrize("case", ["chain", "c256"])
def test_tridiag_matvec_matches_jax(case):
    c, n, scale, _ = CASES[case]
    d, e, r = _blocks(c, n, scale, seed=3 * c)
    assert_close(tt.tridiag_matvec(_t(d), _t(e), _t(r)),
                 jt.tridiag_matvec(jnp.asarray(d), jnp.asarray(e), jnp.asarray(r)),
                 RTOL, ATOL_REL)


def test_auto_segments_matches_jax():
    for c in (100, 128, 130, 256, 384, 1792):
        assert tt.auto_segments(c) == jt.auto_segments(c)


def test_non_spd_diagonal_gives_nan_as_jax():
    """An unguarded Cholesky of a block that is not SPD: NaN on both sides
    (jnp returns NaN, the port maps cholesky_ex's info to NaN)."""
    d, e, _ = _blocks(4, 3, 1.0, seed=9)
    d[2] = -d[2]
    jf = jt.ssor_factor(jnp.asarray(d), jnp.asarray(e))
    tf = tt.ssor_factor(_t(d), _t(e))
    assert np.isnan(np.asarray(jf.d_chol)[2]).any()
    np.testing.assert_array_equal(tf.d_chol[2].numpy(), np.asarray(jf.d_chol)[2])
    assert_close(tf.d_chol[[0, 1, 3]], np.asarray(jf.d_chol)[[0, 1, 3]], RTOL, ATOL_REL)
