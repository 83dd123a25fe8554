"""The four wtt kernels' plain PyTorch versions vs the JAX Pallas kernels.

Each case builds one set of inputs with numpy and runs the JAX function
(Pallas in interpret mode, f64 — as tests/test_pallas_kernels.py runs it)
and the port's public function on CPU tensors, which dispatches to the
plain version.  Tolerance: rtol 1e-10 with atol 1e-12 * max|ref|: the two
sides sum the track and window reductions in different orders (the JAX
kernels through one-hot dots), and a point block seen from one camera has
V^-1 conditioned ~1/lam, so last-bit differences grow there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, wtt_kernel_inputs

from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.ops.pallas.wtt_cost import wtt_cost_cols_idx as j_cost
from tpu3drecon.ops.pallas.wtt_linearize import wtt_linearize_fused_idx as j_lin
from tpu3drecon.ops.pallas.wtt_matvec import wtt_coupling_rows_idx as j_coupling
from tpu3drecon.ops.pallas.wtt_matvec import wtt_wt_planes_idx as j_wt
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.ops import wtt_cost, wtt_linearize, wtt_matvec
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

RTOL, ATOL_REL = 1e-10, 1e-12
LAM = 1e-3
PC = 128


def _inputs(g, w, tb, np_cam, seed):
    return wtt_kernel_inputs(g, w, tb, np_cam, seed, PC)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _flags(np_cam):
    return {"optimize_dist": np_cam == 10}


def _jax_lin(d, loss, np_cam, use_sj):
    g, _, tb, _ = d["uv"].shape
    return j_lin(
        _j(d["wcam"]), _j(d["tw"]), _j(d["pts"]), _j(d["uv"]), _j(d["mask"]),
        jnp.asarray(LAM), jnp.asarray(1.0 / 1280.0),
        JConfig(loss=JLoss(loss), **_flags(np_cam)), np_cam, tb, PC,
        d["tw"].shape[1], use_sj, interpret=True,
    )


def _port_lin(d, loss, np_cam, use_sj):
    return wtt_linearize.wtt_linearize_fused_idx(
        _t(d["wcam"]), _t(d["tw"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
        torch.tensor(LAM, dtype=torch.float64),
        torch.tensor(1.0 / 1280.0, dtype=torch.float64),
        TConfig(loss=TLoss(loss), **_flags(np_cam)), np_cam, use_sj,
    )


# (G, W, Tb, np, loss, use_sj)
LIN_CASES = [
    (2, 128, 2, 8, "trivial", True),
    (2, 256, 3, 8, "cauchy", True),
    (2, 128, 3, 10, "huber", True),
    (3, 256, 2, 8, "huber", False),
    (2, 128, 2, 10, "cauchy", False),
    (2, 256, 3, 8, "trivial", False),
]


@pytest.mark.parametrize("g,w,tb,np_cam,loss,use_sj", LIN_CASES)
def test_linearize_matches_pallas(g, w, tb, np_cam, loss, use_sj):
    d = _inputs(g, w, tb, np_cam, seed=g * 1000 + w + tb)
    want = _jax_lin(d, loss, np_cam, use_sj)
    got = _port_lin(d, loss, np_cam, use_sj)
    assert got[0].shape == (g, w, wtt_linearize.n_rows_cols(np_cam, use_sj))
    for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
        assert_close(a, b, RTOL, ATOL_REL, err_msg=name)
    # Padding slots: exact zeros in jc/jp.
    pad = d["wcam"].reshape(g, tb, PC) < 0
    assert (got[1].numpy()[:, pad] == 0).all() and (got[2].numpy()[:, pad] == 0).all()


MV_CASES = [(2, 128, 2), (2, 128, 3), (2, 256, 2), (3, 256, 3)]


def _normals(d, np_cam):
    _, jc, jp, v_inv, _, _ = _port_lin(d, "trivial", np_cam, True)
    return jc, jp, v_inv


@pytest.mark.parametrize("g,w,tb", MV_CASES)
def test_coupling_and_wt_match_pallas(g, w, tb):
    d = _inputs(g, w, tb, 8, seed=7 * g + w + tb)
    jc, jp, v_inv = _normals(d, 8)
    want_rows = j_coupling(
        _j(d["xw_t"]), _j(d["wcam"]), _j(jc.numpy()), _j(jp.numpy()),
        _j(v_inv.numpy()), 8, tb, PC, w, interpret=True,
    )
    got_rows = wtt_matvec.wtt_coupling_rows_idx(_t(d["xw_t"]), _t(d["wcam"]), jc, jp, v_inv)
    assert got_rows.shape == (g, 8, w)
    assert_close(got_rows, want_rows, RTOL, ATOL_REL, err_msg="coupling rows")
    want_wt = j_wt(
        _j(d["xw_t"]), _j(d["wcam"]), _j(jc.numpy()), _j(jp.numpy()), 8, tb,
        PC, w, interpret=True,
    )
    got_wt = wtt_matvec.wtt_wt_planes_idx(_t(d["xw_t"]), _t(d["wcam"]), jc, jp)
    assert got_wt.shape == (3, g, PC)
    assert_close(got_wt, want_wt, RTOL, ATOL_REL, err_msg="W^T x planes")


COST_CASES = [(2, 128, 2, "trivial"), (2, 256, 3, "cauchy"), (3, 128, 3, "huber"),
              (2, 256, 2, "huber")]


@pytest.mark.parametrize("g,w,tb,loss", COST_CASES)
def test_cost_matches_pallas(g, w, tb, loss):
    d = _inputs(g, w, tb, 8, seed=13 * g + w + tb)
    want = j_cost(
        _j(d["wcam"]), _j(d["tw"]), _j(d["pts"]), _j(d["uv"]), _j(d["mask"]),
        tb, PC, w, JLoss(loss), interpret=True,
    )
    got = wtt_cost.wtt_cost_cols_idx(
        _t(d["wcam"]), _t(d["tw"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
        TLoss(loss),
    )
    assert got.shape == (g, 1, PC)
    assert_close(got, want, RTOL, ATOL_REL)


@pytest.mark.parametrize("loss", ["trivial", "cauchy", "huber"])
def test_ordered_cost_matches_plain_and_pallas(loss):
    """B4's ordered plain form (each track summed slot by slot from zero,
    the kernel's order, to which the card holds B4 bit for bit) equals the
    plain version to 1e-12 and JAX's kernel to this file's tolerance, at
    f64 with 12-slot tracks; also under a mask that is nonzero on the
    padded slots, which both read as all-zero camera rows."""
    g, w, tb = 2, 256, 12
    d = _inputs(g, w, tb, 8, seed=29 + len(loss))
    noisy = np.random.default_rng(3).uniform(0.5, 1.5, size=d["mask"].shape)
    for mask in (d["mask"], noisy):
        args = (_t(d["wcam"]), _t(d["tw"]), _t(d["pts"]), _t(d["uv"]), _t(mask), TLoss(loss))
        got = wtt_cost._cost_cols_ordered(*args)
        assert got.shape == (g, 1, PC)
        assert_close(got, wtt_cost.wtt_cost_cols_idx_plain(*args), 1e-12, 1e-12)
        want = j_cost(_j(d["wcam"]), _j(d["tw"]), _j(d["pts"]), _j(d["uv"]), _j(mask),
                      tb, PC, w, JLoss(loss), interpret=True)
        assert_close(got, want, RTOL, ATOL_REL)


@pytest.mark.parametrize("tb", [1, 12])
def test_ordered_wt_planes_match_plain_and_pallas(tb):
    """B3's ordered plain form (the camera block and the track summed one
    term at a time, the kernel's order) equals the plain version to 1e-12
    and JAX's kernel to this file's tolerance, at f64."""
    g, w = 2, 128
    d = _inputs(g, w, tb, 8, seed=31 + tb)
    jc, jp, _ = _normals(d, 8)
    args = (_t(d["xw_t"]), _t(d["wcam"]), jc, jp)
    got = wtt_matvec._wt_planes_ordered(*args)
    assert got.shape == (3, g, PC)
    assert_close(got, wtt_matvec.wtt_wt_planes_idx_plain(*args), 1e-12, 1e-12)
    want = j_wt(_j(d["xw_t"]), _j(d["wcam"]), _j(jc.numpy()), _j(jp.numpy()), 8, tb, PC, w,
                interpret=True)
    assert_close(got, want, RTOL, ATOL_REL)


def test_cpu_tensors_run_the_plain_versions():
    """A CPU call runs the plain version (its counter grows) and never the
    kernel; an unsupported device raises instead of falling back."""
    d = _inputs(1, 128, 2, 8, seed=1)
    counters = (wtt_linearize.COUNTS, wtt_matvec.COUPLING_COUNTS,
                wtt_matvec.WT_COUNTS, wtt_cost.COUNTS)
    before = [(c.kernel, c.plain) for c in counters]
    jc, jp, v_inv = _normals(d, 8)
    args = (_t(d["xw_t"]), _t(d["wcam"]), jc, jp)
    wtt_matvec.wtt_coupling_rows_idx(*args, v_inv)
    wtt_matvec.wtt_wt_planes_idx(*args)
    wtt_cost.wtt_cost_cols_idx(_t(d["wcam"]), _t(d["tw"]), _t(d["pts"]),
                               _t(d["uv"]), _t(d["mask"]), TLoss.TRIVIAL)
    after = [(c.kernel, c.plain) for c in counters]
    assert [a[0] - b[0] for a, b in zip(after, before)] == [0, 0, 0, 0]
    assert [a[1] - b[1] for a, b in zip(after, before)] == [1, 1, 1, 1]
    with pytest.raises(ValueError, match="device"):
        wtt_cost.wtt_cost_cols_idx(*(torch.empty(1, device="meta") for _ in range(5)),
                                   TLoss.TRIVIAL)


def test_want_od_and_bad_np_raise():
    """want_od needs use_sj (JAX's ValueError); with it the CPU call runs the
    plain version, whose rows gain the np^2 od columns."""
    d = _inputs(1, 128, 2, 8, seed=2)
    with pytest.raises(ValueError, match="want_od requires use_sj"):
        wtt_linearize.wtt_linearize_fused_idx(
            _t(d["wcam"]), _t(d["tw"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
            LAM, 1.0, TConfig(), 8, False, want_od=True,
        )
    before = (wtt_linearize.OD_COUNTS.kernel, wtt_linearize.OD_COUNTS.plain)
    rows = wtt_linearize.wtt_linearize_fused_idx(
        _t(d["wcam"]), _t(d["tw"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
        torch.tensor(LAM, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64),
        TConfig(), 8, True, want_od=True,
    )[0]
    assert rows.shape == (1, 128, wtt_linearize.n_rows_cols(8, True) + 64)
    assert (wtt_linearize.OD_COUNTS.kernel, wtt_linearize.OD_COUNTS.plain) == (
        before[0], before[1] + 1)
    with pytest.raises(ValueError, match="np_cam"):
        wtt_linearize.wtt_linearize_fused_idx(
            _t(d["wcam"]), _t(d["tw"]), _t(d["pts"]), _t(d["uv"]), _t(d["mask"]),
            LAM, 1.0, TConfig(), 10, True,
        )
