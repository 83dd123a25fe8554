"""The ``jacobi_u`` factor of the fused grid, wtt and tt engines against
JAX's where a damped U block cannot be factored.

JAX factors the damped U blocks with ``vmap(jnp.linalg.cholesky)``, which
gives NaN on and below the diagonal of a block it cannot factor; the port
uses ``solvers/pcg.cholesky_or_nan`` for the same result
(``torch.linalg.cholesky_ex`` alone returns a finite, wrong factor there).
One linearization of the sequential scene of tests/test_torch_ba_wtt.py
(24 cameras, radial, 0.5 px noise), f64, in both packages:

- a NaN-poisoned camera (rotation 3 all NaN): its factor is JAX's NaN
  block.  The other cameras' factors are finite in the port; JAX's are too
  on the grid engine, and there the port equals JAX to rtol 1e-10.  On
  the tt and wtt XLA routes JAX reduces through one-hot products, where
  NaN * 0 spreads the NaN to every camera; the port gathers and
  scatter-adds through ``cam_ids`` / ``wcam`` (ROADMAP A.8) and keeps it
  to the poisoned camera;
- a negative damping (lam = -2 makes every damped block indefinite but
  finite): every factor is JAX's NaN block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields, seq_scene_kwargs

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems.grid import grid_bucketed_from_flat as j_grid
from tpu3drecon.problems.tt import tt_from_flat as j_tt
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers import ba_pallas as j_pallas
from tpu3drecon.solvers import ba_tt as j_ba_tt
from tpu3drecon.solvers import ba_wtt as j_ba_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.problems.convert import (
    grid_bucketed_problem_from_numpy,
    tt_problem_from_numpy,
    wtt_problem_from_numpy,
)
from tpu3drecon_torch.solvers import ba_pallas as t_pallas
from tpu3drecon_torch.solvers import ba_tt as t_ba_tt
from tpu3drecon_torch.solvers import ba_wtt as t_ba_wtt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

POISONED = 3
CONFIG = dict(precond="jacobi_u")


def _flat(poison: bool):
    scene = j_syn.make_sequential_scene(**seq_scene_kwargs((-0.05, 0.008)))
    noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.5)
    flat, _ = j_syn.scene_to_ba_problem(noisy, dtype=jnp.float64)
    if poison:
        rm = np.array(flat.cameras.rmats)
        rm[POISONED] = np.nan
        flat = dataclasses.replace(
            flat, cameras=dataclasses.replace(flat.cameras, rmats=jnp.asarray(rm)))
    return flat


def _cams(c):
    return c.rmats, c.tvecs, c.fx_fy, c.dist, c.cx_cy_skew


def _grid(flat, lam):
    jp = j_grid(flat, point_block=64)
    tp = grid_bucketed_problem_from_numpy(np_fields(jp), device="cpu")
    with jax.default_matmul_precision("highest"):
        jn = j_pallas._linearize(
            (jp.cameras.rmats, jp.cameras.tvecs, jp.cameras.fx_fy, jp.points3d),
            jnp.asarray(lam), jp, JConfig(**CONFIG), True)
    tn = t_pallas._linearize(
        (tp.cameras.rmats, tp.cameras.tvecs, tp.cameras.fx_fy, tp.points3d),
        torch.tensor(lam, dtype=torch.float64), tp, TConfig(**CONFIG))
    return jn.u_chol, tn.u_chol


def _tt(flat, lam):
    jp = j_tt(flat, point_block=64)
    tp = tt_problem_from_numpy(np_fields(jp), device="cpu")

    def pts(p, planes):
        return [planes(p.points3d[o : o + b.mask.shape[1]])
                for b, o in zip(p.buckets, p.bucket_offsets)]

    with jax.default_matmul_precision("highest"):
        jn = j_ba_tt._linearize(_cams(jp.cameras) + (pts(jp, lambda x: x.T),),
                                jnp.asarray(lam), jp, JConfig(**CONFIG))
    slots = [t_ba_tt._slot_cams(b.cam_ids, b.mask, tp.n_cameras) for b in tp.buckets]
    tn = t_ba_tt._linearize(_cams(tp.cameras) + (pts(tp, lambda x: x.T.contiguous()),),
                            torch.tensor(lam, dtype=torch.float64), tp, TConfig(**CONFIG),
                            False, slots)
    return jn.u_chol, tn.u_chol


def _wtt(flat, lam):
    jp = j_wtt(flat, point_chunk=32)
    tp = wtt_problem_from_numpy(np_fields(jp), device="cpu")

    def pts(p, planes):
        out = []
        for b, o in zip(p.buckets, p.bucket_offsets):
            g, _, _, pc = b.uv.shape
            out.append(planes(p.points3d[o : o + g * pc].reshape(g, pc, 3)))
        return out

    with jax.default_matmul_precision("highest"):
        jn = j_ba_wtt._linearize(_cams(jp.cameras) + (pts(jp, lambda x: jnp.moveaxis(x, 2, 0)),),
                                 jnp.asarray(lam), jp, JConfig(**CONFIG))
    tn = t_ba_wtt._linearize(
        _cams(tp.cameras) + (pts(tp, lambda x: x.permute(2, 0, 1).contiguous()),),
        torch.tensor(lam, dtype=torch.float64), tp, TConfig(**CONFIG))
    return jn.u_chol, tn.u_chol


ENGINES = {"grid": _grid, "tt": _tt, "wtt": _wtt}
NAN_BLOCK = np.tril(np.full((8, 8), np.nan)) + np.triu(np.zeros((8, 8)), 1)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_poisoned_camera_factor_is_jax_nan(engine):
    want, got = ENGINES[engine](_flat(poison=True), 1e-3)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(want[POISONED], NAN_BLOCK)
    np.testing.assert_array_equal(got[POISONED], want[POISONED])
    others = np.delete(got, POISONED, axis=0)
    assert np.isfinite(others).all()
    jax_others = np.delete(want, POISONED, axis=0)
    if engine == "grid":
        np.testing.assert_allclose(others, jax_others, rtol=1e-10, atol=1e-13)
    else:  # JAX's one-hot products carry NaN * 0 into every camera row
        assert np.isnan(jax_others).any()


@pytest.mark.parametrize("engine", list(ENGINES))
def test_indefinite_blocks_factor_to_jax_nan(engine):
    want, got = ENGINES[engine](_flat(poison=False), -2.0)
    want, got = np.asarray(want), got.numpy()
    every = np.broadcast_to(NAN_BLOCK, want.shape)
    np.testing.assert_array_equal(want, every)
    np.testing.assert_array_equal(got, every)
