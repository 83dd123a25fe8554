"""The dense track-table kernels B12-B16: plain PyTorch versions vs the JAX
Pallas kernels.

Inputs: the 8-camera, 300-point scene of tests/test_torch_ba_pallas.py
(seed 71, 0.5 px noise), packed by the JAX package's
``tt_from_flat(point_block=64)`` at f64, on every one of its track-length
buckets.  The JAX kernels run in interpret mode and take the bucket's dense
one-hot; the port's public functions take ``cam_ids`` and ``mask`` in its
place and, given CPU tensors, run their plain versions.  Tolerance: rtol
1e-10 with atol 1e-12 * max|ref| (the per-camera sums are taken in another
order; exact zeros need the floor).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.ops.pallas import tt_linearize as j_tt
from tpu3drecon.problems.tt import tt_from_flat as j_tt_from_flat
from tpu3drecon.solvers.ba_tt import _cam_table as j_cam_table
from tpu3drecon.solvers.ba_tt import _sym3_inv_planes as j_sym3_inv
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.ops import tt_linearize as t_tt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

RTOL, ATOL_REL = 1e-10, 1e-12
LAM = 1e-4
FLAGS = ("optimize_focal", "optimize_points", "optimize_dist", "optimize_pp")
NP12 = dict(optimize_dist=True, optimize_pp=True)


@pytest.fixture(scope="module")
def buckets():
    """Per bucket, the numpy kernel inputs: table (C, 19), onehot
    (C, Tb*Pb) int8, cam_ids, mask, uv, pts (3, Pb), inv_w, and random x
    (C, 12) / y (3, Pb) for the matvec kernels."""
    scene = j_syn.make_scene(n_cameras=8, n_points=300, obs_per_camera=120, seed=71)
    noisy = j_syn.perturb_scene(scene, seed=72, point2d_noise=0.5)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=noisy, dtype=jnp.float64)
    tt = j_tt_from_flat(flat, point_block=64)
    cams = tt.cameras
    table = np.asarray(j_cam_table(cams.rmats, cams.tvecs, cams.fx_fy,
                                   cams.cx_cy_skew, cams.dist))
    points = np.asarray(tt.points3d)
    rng = np.random.default_rng(73)
    out = []
    for b, off in zip(tt.buckets, tt.bucket_offsets):
        tb, pb = b.mask.shape
        out.append(dict(
            table=table, onehot=np.asarray(b.onehot), cam_ids=np.asarray(b.cam_ids),
            mask=np.asarray(b.mask), uv=np.asarray(b.uv),
            pts=np.ascontiguousarray(points[off : off + pb].T),
            inv_w=1.0 / float(tt.avg_cam_width),
            x=rng.normal(size=(table.shape[0], 12)), y=rng.normal(size=(3, pb)),
        ))
    assert len(out) >= 3
    return out


def _t(x):
    return torch.as_tensor(np.array(x))


def _configs(loss="trivial", **flags):
    j = JConfig(loss=JLoss(loss), **flags)
    return j, TConfig(loss=TLoss(loss), **flags)


def _np_cam(cfg) -> int:
    return 8 + 2 * bool(cfg.optimize_dist) + 2 * bool(cfg.optimize_pp)


def _b12(d, loss="trivial", **flags):
    """(JAX outputs as numpy, port outputs) of B12 on bucket ``d``."""
    jcfg, tcfg = _configs(loss, **flags)
    np_cam = _np_cam(jcfg)
    tb, pb = d["mask"].shape
    want = j_tt.tt_cam_normal_fused(
        jnp.asarray(d["table"]), jnp.asarray(d["onehot"]), jnp.asarray(d["pts"]),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]), jnp.asarray(d["inv_w"]),
        jcfg, np_cam, tb, pb, interpret=True,
    )
    got = t_tt.tt_cam_normal_fused(
        _t(d["table"]), _t(d["cam_ids"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
        torch.tensor(d["inv_w"], dtype=torch.float64), tcfg, np_cam,
    )
    return [np.asarray(w) for w in want], got


def _b16(d, loss):
    jcfg, tcfg = _configs(loss)
    tb, pb = d["mask"].shape
    want = j_tt.tt_cost_fused(
        jnp.asarray(d["table"]), jnp.asarray(d["onehot"]), jnp.asarray(d["pts"]),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"]), jnp.asarray(d["inv_w"]),
        jcfg, tb, pb, interpret=True,
    )
    got = t_tt.tt_cost_fused(
        _t(d["table"]), _t(d["cam_ids"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
        torch.tensor(d["inv_w"], dtype=torch.float64), tcfg,
    )
    return float(want), got


B12_OUTS = ("jc", "jp", "v6", "g_pt", "ug")


def _assert_b12(want, got):
    for name, a, b in zip(B12_OUTS, got, want):
        assert tuple(a.shape) == b.shape, name
        assert_close(a, b, RTOL, ATOL_REL, err_msg=name)


def test_onehot_is_masked_cam_ids(buckets):
    """The identity the port's kernels rely on: the JAX one-hot is
    mask * onehot(cam_ids), so cam_ids + mask carry all of it."""
    for d in buckets:
        c = d["table"].shape[0]
        flat_cam = d["cam_ids"].reshape(-1)
        real = d["mask"].reshape(-1) > 0
        assert not real.all()  # every bucket has padded slots
        want = (np.arange(c)[:, None] == flat_cam[None, :]) & real[None, :]
        assert d["onehot"].dtype == np.int8
        np.testing.assert_array_equal(d["onehot"], want.astype(np.int8))


@pytest.mark.parametrize("loss", ["trivial", "cauchy", "huber"])
def test_cam_normal_and_cost_match_pallas(buckets, loss):
    for d in buckets:
        want, got = _b12(d, loss)
        _assert_b12(want, got)
        # Padded slots give exact zeros in every plane.
        pad = d["mask"] == 0
        assert pad.any()
        assert (got[0].numpy()[:, pad] == 0).all() and (got[1].numpy()[:, pad] == 0).all()
        want_c, got_c = _b16(d, loss)
        assert got_c.shape == ()
        np.testing.assert_allclose(float(got_c), want_c, rtol=RTOL)


@pytest.mark.parametrize("flags", [{}, NP12], ids=["np8", "np12"])
def test_all_five_match_pallas(buckets, flags):
    """B12-B15 at np = 8 and np = 12 (optimize_dist + optimize_pp), B13-B15
    fed the JAX B12 planes and a damped V^-1."""
    for d in buckets:
        want, got = _b12(d, **flags)
        _assert_b12(want, got)
        jc, jp, v6 = want[0], want[1], want[2]
        np_cam = jc.shape[0] // 2
        tb, pb = d["mask"].shape
        c = d["table"].shape[0]
        damp = LAM * np.clip(v6[[0, 3, 5]], 1e-8, None)
        v6_d = v6.copy()
        v6_d[[0, 3, 5]] += damp
        v_inv = np.asarray(j_sym3_inv(jnp.asarray(v6_d)))
        oh = jnp.asarray(d["onehot"])
        cam_ids, mask = _t(d["cam_ids"]), _t(d["mask"])

        coup = j_tt.tt_coupling_fused(oh, jnp.asarray(jc), jnp.asarray(jp),
                                      jnp.asarray(v_inv), np_cam, tb, pb, interpret=True)
        got = t_tt.tt_coupling_fused(cam_ids, mask, _t(jc), _t(jp), _t(v_inv), c)
        assert tuple(got.shape) == (c, np_cam * (np_cam + 1) // 2)
        assert_close(got, coup, RTOL, ATOL_REL, err_msg="B13")

        x = d["x"][:, :np_cam]
        wtx = j_tt.tt_wt_times_fused(jnp.asarray(x), oh, jnp.asarray(jc), jnp.asarray(jp),
                                     np_cam, tb, pb, interpret=True)
        got = t_tt.tt_wt_times_fused(_t(x), cam_ids, mask, _t(jc), _t(jp))
        assert tuple(got.shape) == (3, pb)
        assert_close(got, wtx, RTOL, ATOL_REL, err_msg="B14")

        wy = j_tt.tt_w_times_fused(jnp.asarray(d["y"]), oh, jnp.asarray(jc),
                                   jnp.asarray(jp), np_cam, tb, pb, interpret=True)
        got = t_tt.tt_w_times_fused(_t(d["y"]), cam_ids, mask, _t(jc), _t(jp), c)
        assert tuple(got.shape) == (c, np_cam)
        assert_close(got, wy, RTOL, ATOL_REL, err_msg="B15")


@pytest.mark.parametrize("flag", ["optimize_focal", "optimize_points"])
def test_cam_normal_frozen_blocks_match_pallas(buckets, flag):
    """B12 with the focal columns or the point Jacobian switched off."""
    for d in buckets:
        want, got = _b12(d, **{flag: False})
        _assert_b12(want, got)
        if flag == "optimize_points":
            assert (got[1] == 0).all() and (got[2] == 0).all()
        else:
            assert (got[0][[6, 7, 14, 15]] == 0).all()


def test_cpu_tensors_run_the_plain_versions(buckets):
    """A CPU call runs the plain version (its counter grows) and never the
    kernel; an unsupported device raises instead of falling back."""
    d = buckets[0]
    counters = (t_tt.CAM_COUNTS, t_tt.COUPLING_COUNTS, t_tt.WT_COUNTS,
                t_tt.W_COUNTS, t_tt.COST_COUNTS)
    before = [(c.kernel, c.plain) for c in counters]
    _, (jc, jp, _, _, _) = _b12(d)
    cam_ids, mask = _t(d["cam_ids"]), _t(d["mask"])
    c, pb = d["table"].shape[0], mask.shape[1]
    t_tt.tt_coupling_fused(cam_ids, mask, jc, jp, torch.ones(6, pb, dtype=jc.dtype), c)
    t_tt.tt_wt_times_fused(_t(d["x"][:, :8]), cam_ids, mask, jc, jp)
    t_tt.tt_w_times_fused(_t(d["y"]), cam_ids, mask, jc, jp, c)
    _b16(d, "trivial")
    after = [(c.kernel, c.plain) for c in counters]
    assert [a[0] - b[0] for a, b in zip(after, before)] == [0] * 5
    assert [a[1] - b[1] for a, b in zip(after, before)] == [1] * 5
    meta = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        t_tt.tt_wt_times_fused(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="np_cam"):
        t_tt.tt_cam_normal_fused(_t(d["table"]), cam_ids, _t(d["pts"]), _t(d["uv"]),
                                 mask, torch.tensor(d["inv_w"]), TConfig(), 10)


def test_shared_memory_sizes():
    """The per-block shared memory of B15's shared mode, the only tt kernel
    that keeps one, against the H100's 227 KB: at the medium size (C = 100)
    it fits in f64 at np = 12, at C = 2422 it does not (the wrapper then
    takes the global mode)."""
    limit = 232448
    assert t_tt.shared_memory_bytes(100, 12, 8) < limit
    assert t_tt.shared_memory_bytes(100, 8, 4) == 4 * 100 * 8
    assert t_tt.shared_memory_bytes(2422, 12, 8) > limit
