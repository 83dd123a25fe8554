"""The hub-structured (photo-tourism) scene and its wtt packing with global
camera tiles, port vs JAX reference.

- ``make_hub_scene`` gives JAX's arrays bit for bit.
- A 700-camera hub scene with a tenth of its cameras hubs, packed by
  ``wtt_from_flat(reorder_cameras="hub")``: the planner moves the 88
  highest-degree cameras (an eighth) to the top of the camera axis, which
  takes two global camera tiles of 128.  Bit-equal packings, and the fully
  indexed
  Schur-Jacobi trajectory of the port (kernels B1-B4 as plain versions)
  equals JAX's (Pallas kernels in interpret mode), 4 LM iterations at f64
  on the CPU: ``_torch_ref.assert_same_solve``.  The band preconditioners
  refuse the global tiles with JAX's ``ValueError``.
- ``benchmark.balscale.bal_hub_wtt`` at 1712 cameras with a thin point set
  equals the body of JAX's function, bit for bit.  At this thinness the auto
  mode keeps the plain camera order (its one-hot estimate is far below the
  bound that calls the hub planner); at full size it takes the hub split,
  which ``chip_smoke.py`` logs.  ``split_windows=True`` reaches the
  packer there too (bit-equal to JAX's split packing).
"""

import functools

import jax.numpy as jnp
import pytest
import torch

from _torch_ref import assert_same_solve, np_fields
from test_torch_balscale import _assert_bit_equal, _fields
from test_torch_packing import _scenes_equal, _wtt_equal

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.benchmark import balscale
from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.problems.convert import wtt_problem_from_numpy
from tpu3drecon_torch.problems.wtt import wtt_from_flat as t_wtt
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

HUB = dict(n_cameras=700, points_per_camera=3, track_span=3, hub_fraction=0.1,
           hub_obs=60, seed=23)
SOLVE = dict(maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4,
             matvec_kernel="index", linearize_kernel="index")


def test_hub_scene_bit_equal():
    kw = dict(n_cameras=60, points_per_camera=5, track_span=3, hub_fraction=0.1,
              hub_obs=80, seed=4)
    _scenes_equal(t_syn.make_hub_scene(**kw), j_syn.make_hub_scene(**kw))


@functools.lru_cache(maxsize=None)
def _flats():
    js = j_syn.make_hub_scene(**HUB)
    ts = t_syn.make_hub_scene(**HUB)
    jn = j_syn.perturb_scene(js, seed=8, point2d_noise=0.0)
    tn = t_syn.perturb_scene(ts, seed=8, point2d_noise=0.0)
    return (t_syn.scene_to_ba_problem(tn, observed=ts, dtype=torch.float64, device="cpu")[0],
            j_syn.scene_to_ba_problem(jn, observed=js, dtype=jnp.float64)[0])


@functools.lru_cache(maxsize=None)
def _jax_packed():
    return j_wtt(_flats()[1], point_chunk=64, defer_onehot=True, reorder_cameras="hub")


def test_hub_packing_with_two_global_tiles_bit_equal():
    jw = _jax_packed()
    assert max(b.global_tiles for b in jw.buckets) >= 2
    _wtt_equal(t_wtt(_flats()[0], point_chunk=64, defer_onehot=True,
                     reorder_cameras="hub"), jw)


def test_hub_solve_matches_jax():
    jw = _jax_packed()
    ref = j_solve(jw, JConfig(**SOLVE))
    port = t_solve(wtt_problem_from_numpy(np_fields(jw), device="cpu"), TConfig(**SOLVE))
    assert_same_solve(port, ref, SOLVE["maxiter"])
    assert int(ref[2].accepted) >= 1


@pytest.mark.parametrize("precond", ["ssor", "tridiag"])
def test_band_preconditioners_refuse_the_hub(precond):
    cfg = dict(SOLVE, precond=precond)
    port = wtt_problem_from_numpy(np_fields(_jax_packed()), device="cpu")
    with pytest.raises(ValueError, match="hub/global camera tiles"):
        t_solve(port, TConfig(**cfg))
    with pytest.raises(ValueError, match="hub/global camera tiles"):
        j_solve(_jax_packed(), JConfig(**cfg))


_BAL_HUB_THIN = dict(points_per_camera=4, track_span=4, hub_fraction=0.05, hub_obs=300)


def _jax_bal_hub(split_windows):
    """The body of JAX's ``bal_hub_wtt`` at the thin point set."""
    scene = j_syn.make_hub_scene(n_cameras=1712, seed=7, **_BAL_HUB_THIN)
    noisy = j_syn.perturb_scene(scene, seed=8, point2d_noise=0.5)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
    return j_wtt(flat, point_chunk=512, defer_onehot=True, split_windows=split_windows)


def test_bal_hub_wtt_bit_equal():
    got = balscale.bal_hub_wtt(verbose=False, device="cpu", **_BAL_HUB_THIN)
    _assert_bit_equal(_fields(got), np_fields(_jax_bal_hub(False)))


def test_bal_hub_wtt_needs_a_card_and_refuses_split_windows(monkeypatch):
    """Without a card the builder raises; ``split_windows`` reaches the
    packer, as in JAX's ``bal_hub_wtt``: bit-equal split packings."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        balscale.bal_hub_wtt(points_per_camera=4, hub_obs=300, verbose=False)
    got = balscale.bal_hub_wtt(verbose=False, device="cpu", split_windows=True,
                               **_BAL_HUB_THIN)
    _assert_bit_equal(_fields(got), np_fields(_jax_bal_hub(True)))
