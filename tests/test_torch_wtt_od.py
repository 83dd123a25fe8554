"""The band pair rows (``want_od``) of kernels B1 and B8: the plain PyTorch
versions vs the JAX Pallas kernels.

The inputs are the buckets of the sequential fixture packed by the port
(tests/test_ba_wtt.py's scene, bit-equal to JAX's packing) and synthetic
buckets whose tracks walk through adjacent window rows, one of them with
Tb = 1 (no pairs: the od columns are exact zeros).  Each goes through the
JAX function (Pallas in interpret mode, f64) and the port's public function
on CPU tensors, which dispatches to the plain version.  Tolerance: rtol
1e-10 with atol 1e-12 * max|ref|, as tests/test_torch_wtt_kernels.py (the
window reductions are summed in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import SEQ_DISTS, assert_close, seq_scene_kwargs, wtt_kernel_inputs

from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.ops.pallas.wtt_linearize import wtt_contrib_rows_idx as j_contrib
from tpu3drecon.ops.pallas.wtt_linearize import wtt_linearize_fused_idx as j_lin
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.ops import wtt_linearize
from tpu3drecon_torch.problems.wtt import wtt_from_flat
from tpu3drecon_torch.solvers.ba_wtt import _inv_w, _padded_table, _window_idx, _window_rows
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

RTOL, ATOL_REL = 1e-10, 1e-12
LAM = 1e-3
LIN_OUTS = ("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt")


def _t(x):
    return torch.as_tensor(np.array(x))


def _seq_inputs(g, w, tb, np_cam, seed, pc=128):
    """wtt_kernel_inputs with sequential tracks: each point column's slots
    sit on increasing window rows, mostly one apart, then trailing
    padding (-1) as the packer emits it."""
    d = wtt_kernel_inputs(g, w, tb, np_cam, seed, pc)
    rng = np.random.default_rng(seed + 1)
    length = rng.integers(0, tb + 1, size=(g, 1, pc))
    steps = np.where(rng.random((g, tb, pc)) < 0.75, 1, 2)
    steps[:, 0] = rng.integers(0, w - 2 * tb, size=(g, pc))
    rows = np.cumsum(steps, axis=1)
    wcam = np.where(np.arange(tb)[None, :, None] < length, rows, -1).astype(np.int16)
    d["wcam"] = wcam.reshape(g, tb * pc)
    d["mask"] = (wcam >= 0).astype(np.float64)
    return d


def _lin_both(d, loss, np_cam, pc, lam=LAM, inv_w=1.0 / 1280.0):
    g, _, tb, _ = d["uv"].shape
    w = d["tw"].shape[1]
    flags = {"optimize_dist": np_cam >= 10, "optimize_pp": np_cam == 12}
    want = j_lin(
        *(jnp.asarray(d[k]) for k in ("wcam", "tw", "pts", "uv", "mask")),
        jnp.asarray(lam), jnp.asarray(inv_w), JConfig(loss=JLoss(loss), **flags),
        np_cam, tb, pc, w, True, True, interpret=True,
    )
    got = wtt_linearize.wtt_linearize_fused_idx(
        *(_t(d[k]) for k in ("wcam", "tw", "pts", "uv", "mask")),
        torch.tensor(lam, dtype=torch.float64), torch.tensor(inv_w, dtype=torch.float64),
        TConfig(loss=TLoss(loss), **flags), np_cam, True, want_od=True,
    )
    assert got[0].shape == (g, w, wtt_linearize.n_rows_cols(np_cam, True, True))
    for name, a, b in zip(LIN_OUTS, got, want):
        assert_close(a, b, RTOL, ATOL_REL, err_msg=name)
    return got


def _contrib_both(d, jc, jp, r, v_inv, np_cam, pc):
    g, _, tb, _ = d["uv"].shape
    w = d["tw"].shape[1]
    args = (d["wcam"], jc, jp, r, v_inv)
    want = j_contrib(*(jnp.asarray(np.asarray(x)) for x in args), np_cam, tb, pc, w,
                     True, True, interpret=True)
    got = wtt_linearize.wtt_contrib_rows_idx(*(_t(x) for x in args), np_cam, w, True,
                                             want_od=True)
    assert got.shape == (g, w, wtt_linearize.n_contrib_cols(np_cam, True, True))
    assert_close(got, want, RTOL, ATOL_REL)
    return got


# (G, W, Tb, np, loss)
SYN_CASES = [(2, 128, 3, 8, "trivial"), (1, 128, 1, 8, "cauchy"), (2, 256, 4, 10, "huber")]


@pytest.mark.parametrize("g,w,tb,np_cam,loss", SYN_CASES)
def test_od_rows_match_pallas(g, w, tb, np_cam, loss):
    """B1 and B8 with want_od on synthetic sequential buckets."""
    d = _seq_inputs(g, w, tb, np_cam, seed=g * 100 + w + tb)
    rows, jc, jp, v_inv, _, _ = _lin_both(d, loss, np_cam, 128)
    od = rows[..., -np_cam * np_cam:]
    if tb == 1:
        assert (od == 0).all()
    else:
        assert (od != 0).any()
    rng = np.random.default_rng(tb)
    r = rng.normal(size=(2, g, tb, 128))
    contrib = _contrib_both(d, jc.numpy(), jp.numpy(), r, v_inv.numpy(), np_cam, 128)
    # The pair rows depend on jc/jp/v_inv only: B8's od columns equal B1's.
    assert_close(contrib[..., -np_cam * np_cam:], od, RTOL, ATOL_REL)


@pytest.fixture(scope="module")
def seq_buckets():
    """Per-bucket kernel inputs of the sequential fixture (radial), packed
    by the port at its initial parameters."""
    scene = t_syn.make_sequential_scene(**seq_scene_kwargs(SEQ_DISTS["radial"]))
    noisy = t_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = t_syn.scene_to_ba_problem(noisy, observed=scene, dtype=torch.float64,
                                        device="cpu")
    problem = wtt_from_flat(flat, point_chunk=64, defer_onehot=True)
    cams = problem.cameras
    params = (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew, None)
    table = _padded_table(params, problem.c_pad)
    out = []
    for bucket, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, _, pc = bucket.uv.shape
        pts = problem.points3d[off : off + g * pc].reshape(g, pc, 3).permute(2, 0, 1)
        out.append(dict(
            wcam=bucket.wcam.numpy(), tw=_window_rows(table, _window_idx(bucket)).numpy(),
            pts=pts.numpy(), uv=bucket.uv.numpy(), mask=bucket.mask.numpy(),
        ))
    return out, float(_inv_w(problem, torch.float64))


def test_od_rows_match_pallas_on_the_sequential_fixture(seq_buckets):
    buckets, inv_w = seq_buckets
    pairs = 0
    for d in buckets:
        pc = d["uv"].shape[3]
        rows, jc, jp, v_inv, _, _ = _lin_both(d, "trivial", 8, pc, lam=1e-4, inv_w=inv_w)
        pairs += int((rows[..., -64:] != 0).any(dim=2).sum())
        r = np.random.default_rng(pc).normal(size=(2, *jp.shape[1:]))
        _contrib_both(d, jc.numpy(), jp.numpy(), r, v_inv.numpy(), 8, pc)
    assert pairs > 0


def test_want_od_without_sj_and_bad_np_raise():
    d = _seq_inputs(1, 128, 2, 8, seed=2)
    args = [_t(d[k]) for k in ("wcam", "tw", "pts", "uv", "mask")]
    with pytest.raises(ValueError, match="want_od requires use_sj"):
        wtt_linearize.wtt_linearize_fused_idx(*args, LAM, 1.0, TConfig(), 8, False,
                                              want_od=True)
    with pytest.raises(ValueError, match="np_cam"):
        wtt_linearize.wtt_linearize_fused_idx(*args, LAM, 1.0, TConfig(), 10, True,
                                              want_od=True)
    z = torch.zeros(16, 1, 2, 128, dtype=torch.float64)
    with pytest.raises(ValueError, match="want_od requires use_sj"):
        wtt_linearize.wtt_contrib_rows_idx(args[0], z, z[:6], z[:2], z[:6, :, 0], 8, 128,
                                           False, want_od=True)
