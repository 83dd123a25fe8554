"""The split-window wtt packing (``wtt_from_flat(split_windows=...)``), port
vs JAX reference.

- Packings bit-equal to JAX's in every bucket field (``uv``, ``mask``,
  ``wcam``, ``cam_base``, ``window``, ``global_tiles``, ``global_tile0``),
  in ``points3d``, ``point_rows`` and ``bucket_offsets``: the sequential
  scene of ``tests/test_ba_wtt.py``'s ``TestSplitWindows`` (160 cameras)
  split with the default cap, with cap 1 and with ``chunk_multiple=4``;
  the 700-camera hub scene of ``tests/test_torch_hub.py`` (two global
  tiles; its points re-sorted by global-tile hull, classes of hub-only
  chunks with no local window rows) at caps 4, 2 and 50.
- ``_coalesce_window_classes`` on hand-made classes (a heavy wide local
  class with a light global one; 40 widths above the enumeration budget)
  gives JAX's bins and runs; ``split_windows=-2`` raises JAX's
  ``ValueError``.
- On the split packings the f64 trajectories (3 LM iterations, CPU, plain
  kernel versions against Pallas in interpret mode) equal JAX's on the
  fully indexed and the unfused (``linearize_kernel=False``,
  ``matvec_kernel="index"``) routes under Schur-Jacobi:
  ``_torch_ref.assert_same_solve``.  The band preconditioners refuse the
  split hub packing with JAX's ``ValueError``.
"""

import functools

import jax.numpy as jnp
import pytest
import torch

from _torch_ref import assert_same_solve, np_fields
from test_torch_hub import HUB
from test_torch_packing import _wtt_equal

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems import wtt as j_wtt_mod
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.problems import wtt as t_wtt_mod
from tpu3drecon_torch.problems.convert import wtt_problem_from_numpy
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

SEQ = dict(n_cameras=160, points_per_camera=12, track_span=5, seed=5)
SOLVE = dict(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
ROUTES = {
    "index": dict(matvec_kernel="index", linearize_kernel="index"),
    "unfused": dict(matvec_kernel="index", linearize_kernel=False),
}


@functools.lru_cache(maxsize=None)
def _flats(scene: str):
    """(port flat, JAX flat) of the sequential or the hub scene, f64."""
    if scene == "seq":
        js, ts = j_syn.make_sequential_scene(**SEQ), t_syn.make_sequential_scene(**SEQ)
        seed = 6
    else:
        js, ts = j_syn.make_hub_scene(**HUB), t_syn.make_hub_scene(**HUB)
        seed = 8
    jn = j_syn.perturb_scene(js, seed=seed, point2d_noise=0.0)
    tn = t_syn.perturb_scene(ts, seed=seed, point2d_noise=0.0)
    return (t_syn.scene_to_ba_problem(tn, observed=ts, dtype=torch.float64, device="cpu")[0],
            j_syn.scene_to_ba_problem(jn, observed=js, dtype=jnp.float64)[0])


_OPTS = {  # (scene, wtt_from_flat options)
    "seq_default": ("seq", dict(split_windows=True)),
    "seq_cap1": ("seq", dict(split_windows=1)),
    "seq_multiple4": ("seq", dict(split_windows=True, chunk_multiple=4)),
    "hub_default": ("hub", dict(split_windows=True, reorder_cameras="hub")),
    "hub_cap2": ("hub", dict(split_windows=2, reorder_cameras="hub")),
    "hub_cap50": ("hub", dict(split_windows=50, reorder_cameras="hub")),
}


@functools.lru_cache(maxsize=None)
def _jax_packed(case: str, defer: bool = True):
    scene, opts = _OPTS[case]
    return j_wtt_mod.wtt_from_flat(_flats(scene)[1], point_chunk=64, defer_onehot=defer,
                                   **opts)


@pytest.mark.parametrize("case", list(_OPTS))
def test_split_packing_bit_equal(case):
    scene, opts = _OPTS[case]
    jw = _jax_packed(case)
    tw = t_wtt_mod.wtt_from_flat(_flats(scene)[0], point_chunk=64, defer_onehot=True, **opts)
    _wtt_equal(tw, jw)
    if "multiple4" in case:
        assert all(b.uv.shape[0] % 4 == 0 for b in tw.buckets)
    if scene == "hub":
        assert max(b.global_tiles for b in jw.buckets) >= 2
    if case in ("hub_default", "hub_cap50"):
        # A class of hub-only chunks: no local window rows, global ones only.
        assert any(b.window == 128 * b.global_tiles for b in jw.buckets)
    # Split classes narrow the windows below the unsplit packing's.
    base = t_wtt_mod.wtt_from_flat(_flats(scene)[0], point_chunk=64, defer_onehot=True,
                                   **{k: v for k, v in opts.items() if k != "split_windows"})
    assert len(tw.buckets) >= len(base.buckets)
    if case != "seq_cap1":
        assert min(b.window for b in tw.buckets) < max(b.window for b in base.buckets)


COALESCE = {
    "wide_local_light_global": (
        {(1792, None): [(0, list(range(100)))], (128, (0, 0)): [(0, [100])],
         (256, None): [(0, [101, 102])]},
        2, 1, 1792),
    "mixed_hulls": (
        {(128, None): [(0, [0, 1]), (256, [5])], (256, (0, 0)): [(128, [2])],
         (128, (1, 1)): [(384, [3, 4])], (384, (0, 1)): [(0, [6])],
         (0, (1, 1)): [(0, [7, 8])]},
        3, 2, 1024),
    "greedy_fallback": ({(128 * (i + 1), None): [(0, [i])] for i in range(40)}, 10, 0,
                        128 * 45),
}


@pytest.mark.parametrize("case", list(COALESCE))
def test_coalesce_window_classes_matches_jax(case):
    runs, cap, n_gt, c_pad = COALESCE[case]
    want = j_wtt_mod._coalesce_window_classes(runs, cap, n_gt=n_gt, c_pad=c_pad)
    got = t_wtt_mod._coalesce_window_classes(runs, cap, n_gt=n_gt, c_pad=c_pad)
    assert list(got.items()) == list(want.items())
    assert len(got) <= cap
    ids = sorted(i for rs in got.values() for _, g in rs for i in g)
    assert ids == sorted(i for rs in runs.values() for _, g in rs for i in g)


def test_negative_cap_raises():
    tf, jf = _flats("seq")
    assert t_wtt_mod._split_class_cap(True) == j_wtt_mod._split_class_cap(True)
    with pytest.raises(ValueError, match="must be > 0"):
        t_wtt_mod.wtt_from_flat(tf, point_chunk=32, split_windows=-2)
    with pytest.raises(ValueError, match="must be > 0"):
        j_wtt_mod.wtt_from_flat(jf, point_chunk=32, split_windows=-2)


# (packing case, route): the sequential split on both routes, the hub split
# fully indexed.
SOLVES = [("seq_default", "index"), ("seq_default", "unfused"), ("hub_default", "index")]


@pytest.mark.parametrize("case,route", SOLVES)
def test_split_trajectory_matches_jax(case, route):
    # The unfused route reads the dense one-hot (B7 and B8 take wcam, the
    # JAX route the one-hot): pack it there.
    jw = _jax_packed(case, defer=route == "index")
    cfg = dict(SOLVE, **ROUTES[route])
    ref = j_solve(jw, JConfig(**cfg))
    port = t_solve(wtt_problem_from_numpy(np_fields(jw), device="cpu"), TConfig(**cfg))
    assert_same_solve(port, ref, SOLVE["maxiter"])
    assert int(ref[2].accepted) >= 1


@pytest.mark.parametrize("precond", ["ssor", "tridiag"])
def test_band_preconditioners_refuse_the_split_hub(precond):
    cfg = dict(SOLVE, precond=precond, **ROUTES["index"])
    jw = _jax_packed("hub_default")
    with pytest.raises(ValueError, match="hub/global camera tiles"):
        t_solve(wtt_problem_from_numpy(np_fields(jw), device="cpu"), TConfig(**cfg))
    with pytest.raises(ValueError, match="hub/global camera tiles"):
        j_solve(jw, JConfig(**cfg))
