"""PyTorch port vs JAX reference: synthetic scenes, flat problems, camera
reordering and the windowed track-table packer must give bit-equal arrays
(both packers are host-side numpy from the same seeded inputs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import SEQ_DISTS, np_fields, seq_scene_kwargs, to_np

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems import reorder as j_reorder
from tpu3drecon.problems.grid import grid_bucketed_from_flat as j_grid
from tpu3drecon.problems.grid import grid_from_flat as j_plain_grid
from tpu3drecon.problems.grid import unpermute_points as j_unpermute
from tpu3drecon.problems.wtt import expand_onehots as j_expand
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt

from tpu3drecon_torch.benchmark import medium_config
from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.problems import convert
from tpu3drecon_torch.problems import reorder as t_reorder
from tpu3drecon_torch.problems.convert import (
    grid_bucketed_problem_from_numpy,
    grid_problem_from_numpy,
    wtt_problem_from_numpy,
)
from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat as t_grid
from tpu3drecon_torch.problems.grid import grid_from_flat as t_plain_grid
from tpu3drecon_torch.problems.grid import unpermute_points as t_unpermute
from tpu3drecon_torch.problems.wtt import expand_onehots as t_expand
from tpu3drecon_torch.problems.wtt import wtt_from_flat as t_wtt

JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _eq(a, b, what=""):
    a, b = to_np(a), to_np(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _scenes_equal(ts, js):
    for f in dataclasses.fields(js):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        if isinstance(b, np.ndarray):
            _eq(a, b, f.name)
        else:
            assert a == b, f.name


def _flat_equal(tp, jp):
    for name in ("points3d", "cam_idx", "pt_idx", "uv", "mask", "avg_cam_width"):
        _eq(getattr(tp, name), getattr(jp, name), name)
    for name in ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist"):
        _eq(getattr(tp.cameras, name), getattr(jp.cameras, name), name)


def _wtt_equal(tw, jw):
    """The packed wtt fields must match bit for bit."""
    for name in ("points3d", "point_rows"):
        _eq(getattr(tw, name), getattr(jw, name), name)
    if jw.cam_rows is None:
        assert tw.cam_rows is None
    else:
        _eq(tw.cam_rows, jw.cam_rows, "cam_rows")
    assert tw.bucket_offsets == jw.bucket_offsets
    assert (tw.c_pad, tw.window, tw.n_real_points) == (jw.c_pad, jw.window, jw.n_real_points)
    assert len(tw.buckets) == len(jw.buckets)
    for i, (tb, jb) in enumerate(zip(tw.buckets, jw.buckets)):
        for name in ("uv", "mask", "wcam", "cam_base"):
            _eq(getattr(tb, name), getattr(jb, name), f"bucket {i} {name}")
        assert (tb.window, tb.global_tiles, tb.global_tile0) == (
            jb.window, jb.global_tiles, jb.global_tile0)
    _flat_equal_cams(tw.cameras, jw.cameras)


def _flat_equal_cams(tc, jc):
    for name in ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist"):
        _eq(getattr(tc, name), getattr(jc, name), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scene_and_flat_problem_bit_equal(dtype):
    kw = dict(n_cameras=7, n_points=300, obs_per_camera=150, seed=3,
              dist=(-0.03, 0.004))
    ts, js = t_syn.make_scene(**kw), j_syn.make_scene(**kw)
    _scenes_equal(ts, js)
    tn = t_syn.perturb_scene(ts, seed=4, point2d_noise=0.5)
    jn = j_syn.perturb_scene(js, seed=4, point2d_noise=0.5)
    _scenes_equal(tn, jn)
    tp, tmeta = t_syn.scene_to_ba_problem(tn, observed=ts, dtype=dtype, device="cpu")
    jp, jmeta = j_syn.scene_to_ba_problem(jn, observed=js, dtype=JDT[dtype])
    _flat_equal(tp, jp)
    assert tmeta.n_real_obs == jmeta.n_real_obs


def test_sequential_scene_bit_equal():
    kw = seq_scene_kwargs(SEQ_DISTS["radial"])
    _scenes_equal(t_syn.make_sequential_scene(**kw), j_syn.make_sequential_scene(**kw))


def _seq_flats(dist, **kw):
    kw = {**seq_scene_kwargs(dist), **kw}
    ts, js = t_syn.make_sequential_scene(**kw), j_syn.make_sequential_scene(**kw)
    tn = t_syn.perturb_scene(ts, seed=6, point2d_noise=0.0)
    jn = j_syn.perturb_scene(js, seed=6, point2d_noise=0.0)
    return (t_syn.scene_to_ba_problem(tn, observed=ts, dtype=torch.float64, device="cpu")[0],
            j_syn.scene_to_ba_problem(jn, observed=js, dtype=jnp.float64)[0])


@pytest.mark.parametrize("dist", list(SEQ_DISTS), ids=list(SEQ_DISTS))
def test_wtt_from_flat_bit_equal(dist):
    tf, jf = _seq_flats(SEQ_DISTS[dist])
    tw = t_wtt(tf, point_chunk=64, defer_onehot=True)
    jw = j_wtt(jf, point_chunk=64, defer_onehot=True)
    _wtt_equal(tw, jw)
    # The converters carry the JAX-packed problem across unchanged.
    _wtt_equal(wtt_problem_from_numpy(np_fields(jw), device="cpu"), jw)


def _shuffled(flat_t, flat_j, seed):
    perm = np.random.default_rng(seed).permutation(flat_j.n_cameras)
    return (t_reorder.permute_cameras_flat(flat_t, perm),
            j_reorder.permute_cameras_flat(flat_j, perm))


def test_wtt_from_flat_bit_equal_after_rcm():
    tf, jf = _seq_flats((0.0, 0.0), n_cameras=300, points_per_camera=8,
                        track_span=4, seed=9)
    tf, jf = _shuffled(tf, jf, seed=31)
    _flat_equal(tf, jf)
    args = [np.asarray(x) for x in (jf.cam_idx, jf.pt_idx, jf.mask)]
    tperm, tstats = t_reorder.plan_camera_order(*args, jf.n_cameras, jf.n_points)
    jperm, jstats = j_reorder.plan_camera_order(*args, jf.n_cameras, jf.n_points)
    assert jperm is not None and tstats == jstats
    np.testing.assert_array_equal(tperm, jperm)
    tw = t_wtt(tf, point_chunk=128)
    jw = j_wtt(jf, point_chunk=128, defer_onehot=True)
    assert jw.cam_rows is not None  # RCM relabeled the cameras
    _wtt_equal(tw, jw)


def test_wtt_hub_split_bit_equal():
    """The hub planner's global camera tiles (shared window rows)."""
    js = j_syn.make_hub_scene(n_cameras=640, points_per_camera=10, track_span=4,
                              hub_fraction=0.05, hub_obs=1000, seed=21)
    ts = t_syn.SyntheticScene(**{f.name: getattr(js, f.name)
                                 for f in dataclasses.fields(js)})
    tf, _ = t_syn.scene_to_ba_problem(ts, dtype=torch.float64, device="cpu")
    jf, _ = j_syn.scene_to_ba_problem(js, dtype=jnp.float64)
    tw = t_wtt(tf, point_chunk=128, reorder_cameras="hub")
    jw = j_wtt(jf, point_chunk=128, reorder_cameras="hub", defer_onehot=True)
    assert any(b.global_tiles for b in jw.buckets)
    _wtt_equal(tw, jw)


def test_grid_buckets_and_unpermute_match():
    tf, jf = _seq_flats((0.0, 0.0))
    tg = t_grid(tf, point_block=64, order_points_by_cam=True)
    jg = j_grid(jf, point_block=64, order_points_by_cam=True)
    for name in ("points3d", "uv", "pt_idx", "mask", "point_rows"):
        _eq(getattr(tg, name), getattr(jg, name), name)
    for tb, jb in zip(tg.buckets, jg.buckets):
        for name in ("track_idx", "track_cam", "track_mask"):
            _eq(getattr(tb, name), getattr(jb, name), name)
    _eq(t_unpermute(tg.points3d, tg), j_unpermute(jg.points3d, jg))
    _eq(t_unpermute(tg.points3d, tg), tf.points3d)


GRID_FIELDS = ("points3d", "uv", "pt_idx", "mask", "avg_cam_width")


def _grid_equal(tg, jg, names):
    for name in names:
        _eq(getattr(tg, name), getattr(jg, name), name)
    _flat_equal_cams(tg.cameras, jg.cameras)


@pytest.mark.parametrize("dist", list(SEQ_DISTS), ids=list(SEQ_DISTS))
def test_grid_from_flat_bit_equal(dist):
    tf, jf = _seq_flats(SEQ_DISTS[dist])
    names = GRID_FIELDS + ("track_idx", "track_cam", "track_mask")
    jg = j_plain_grid(jf)
    _grid_equal(t_plain_grid(tf), jg, names)
    # The converter carries the JAX-packed problem across unchanged.
    _grid_equal(grid_problem_from_numpy(np_fields(jg), device="cpu"), jg, names)


def test_grid_bucketed_problem_round_trips():
    tf, jf = _seq_flats((0.0, 0.0))
    jg = j_grid(jf, point_block=64)
    tg = grid_bucketed_problem_from_numpy(np_fields(jg), device="cpu")
    _grid_equal(tg, jg, GRID_FIELDS + ("point_rows",))
    assert tg.n_real_points == jg.n_real_points
    assert len(tg.buckets) == len(jg.buckets) >= 2
    for tb, jb in zip(tg.buckets, jg.buckets):
        for name in ("track_idx", "track_cam", "track_mask"):
            _eq(getattr(tb, name), getattr(jb, name), name)
    _eq(t_unpermute(tg.points3d, tg), tf.points3d)


def test_entry_points_default_to_cuda(monkeypatch):
    """Called without ``device``, every entry point targets the CUDA card
    and raises where there is none; it never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = t_syn.make_scene(n_cameras=3, n_points=40, seed=1)
    _, jf = _seq_flats((0.0, 0.0))
    calls = [
        lambda: t_syn.scene_to_ba_problem(scene),
        lambda: medium_config.build_problem(),
        lambda: medium_config.build_grid_problem(),
        lambda: convert.camera_params_from_numpy(np_fields(jf.cameras)),
        lambda: convert.ba_problem_from_numpy(np_fields(jf)),
        lambda: convert.grid_problem_from_numpy(np_fields(j_plain_grid(jf))),
        lambda: convert.grid_bucketed_problem_from_numpy(np_fields(j_grid(jf))),
        lambda: convert.wtt_problem_from_numpy(np_fields(j_wtt(jf, point_chunk=64))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unsupported_packing_options_raise():
    """A one-hot budget below the packing and a class cap <= 0 raise JAX's
    ``ValueError``; ``split_windows`` packs JAX's window classes bit for bit
    (tests/test_torch_split_windows.py covers caps and hub splits)."""
    tf, jf = _seq_flats((0.0, 0.0))
    for opts in (dict(split_windows=True), dict(split_windows=2)):
        _wtt_equal(t_wtt(tf, point_chunk=64, defer_onehot=True, **opts),
                   j_wtt(jf, point_chunk=64, defer_onehot=True, **opts))
    with pytest.raises(ValueError, match="must be > 0"):
        t_wtt(tf, point_chunk=64, split_windows=-1)
    with pytest.raises(ValueError, match="one-hot"):
        t_wtt(tf, point_chunk=64, max_onehot_bytes=16)


ONEHOT_DTYPES = {"int8": (torch.int8, jnp.int8), "float64": (torch.float64, jnp.float64)}


@pytest.mark.parametrize("name", list(ONEHOT_DTYPES))
def test_wtt_onehot_bit_equal(name):
    """The dense one-hot, built by the packer (the default) or by
    ``expand_onehots`` from a deferred packing, equals JAX's bit for bit
    in its dtype; the size guard counts that dtype's bytes."""
    tdt, jdt = ONEHOT_DTYPES[name]
    tf, jf = _seq_flats(SEQ_DISTS["radial"])
    jw = j_wtt(jf, point_chunk=64, onehot_dtype=jdt)
    tw = t_wtt(tf, point_chunk=64, onehot_dtype=tdt)
    _wtt_equal(tw, jw)
    te = t_expand(t_wtt(tf, point_chunk=64, defer_onehot=True), onehot_dtype=tdt)
    je = j_expand(j_wtt(jf, point_chunk=64, defer_onehot=True), onehot_dtype=jdt)
    tc = wtt_problem_from_numpy(np_fields(jw), device="cpu")
    for i, jb in enumerate(jw.buckets):
        for got in (tw, te, tc):
            _eq(got.buckets[i].onehot, jb.onehot, f"bucket {i} onehot")
        _eq(te.buckets[i].onehot, je.buckets[i].onehot, f"bucket {i} expanded")
    int8_bytes = sum(b.onehot.numel() for b in tw.buckets)
    t_wtt(tf, point_chunk=64, max_onehot_bytes=int8_bytes, defer_onehot=True)
    if tdt != torch.int8:
        with pytest.raises(ValueError, match="one-hot"):
            t_wtt(tf, point_chunk=64, max_onehot_bytes=int8_bytes, onehot_dtype=tdt)
        with pytest.raises(ValueError, match="one-hot"):
            j_wtt(jf, point_chunk=64, max_onehot_bytes=int8_bytes, onehot_dtype=jdt)
