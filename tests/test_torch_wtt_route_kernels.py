"""Kernels B5-B8 (the wtt engine's unfused and one-hot routes): the plain
PyTorch versions vs the JAX Pallas kernels.

Each case builds one set of inputs with numpy and runs the JAX function
(Pallas in interpret mode, f64, as tests/test_pallas_kernels.py runs it)
and the port's public function on CPU tensors, which dispatches to the
plain version.  B7 is a pure selection and must match bit for bit.  B5, B6
and B8 reduce slots into window rows, the JAX kernels through one-hot
dots and the plain versions by scatter-add or einsum, so they are held to
rtol 1e-10 with atol 1e-12 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close, wtt_kernel_inputs

from tpu3drecon.ops.pallas.wtt_linearize import wtt_cam_planes_idx as j_planes
from tpu3drecon.ops.pallas.wtt_linearize import wtt_contrib_rows_idx as j_contrib
from tpu3drecon.ops.pallas.wtt_matvec import wtt_coupling_rows_fused as j_fused
from tpu3drecon.ops.pallas.wtt_matvec import wtt_w_rows_idx as j_w_rows

from tpu3drecon_torch.ops import wtt_linearize, wtt_matvec

RTOL, ATOL_REL = 1e-10, 1e-12
PC = 128


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _planes(g, tb, np_cam, seed):
    """Random slot planes jc (2np, G, Tb, Pc), jp (6, ...), r (2, ...), and
    point planes v_inv (6, G, Pc), y (3, G, Pc)."""
    rng = np.random.default_rng(seed)
    return dict(
        jc=rng.normal(size=(2 * np_cam, g, tb, PC)), jp=rng.normal(size=(6, g, tb, PC)),
        r=rng.normal(size=(2, g, tb, PC)), v_inv=rng.normal(size=(6, g, PC)),
        y=rng.normal(size=(3, g, PC)),
    )


def _onehot(wcam, w):
    return (wcam[:, None, :] == np.arange(w)[None, :, None]).astype(np.int8)


@pytest.mark.parametrize("g,w,tb", [(2, 128, 2), (3, 256, 3), (1, 128, 12)])
def test_cam_planes_bit_equal(g, w, tb):
    d = wtt_kernel_inputs(g, w, tb, 8, seed=g + w + tb, pc=PC)
    want = j_planes(_j(d["wcam"]), _j(d["tw"]), tb, PC, w, interpret=True)
    got = wtt_linearize.wtt_cam_planes_idx(_t(d["wcam"]), _t(d["tw"]), tb)
    assert got.shape == (g, 19, tb, PC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pad = d["wcam"].reshape(g, tb, PC) < 0
    assert (got.numpy().transpose(1, 0, 2, 3)[:, pad] == 0).all()


CONTRIB_CASES = [  # (G, W, Tb, np, use_sj)
    (2, 128, 2, 8, True), (2, 256, 3, 8, False), (1, 128, 4, 10, True),
    (3, 128, 3, 10, False), (1, 256, 2, 12, True),
]


@pytest.mark.parametrize("g,w,tb,np_cam,use_sj", CONTRIB_CASES)
def test_contrib_rows_match_pallas(g, w, tb, np_cam, use_sj):
    d = wtt_kernel_inputs(g, w, tb, np_cam, seed=3 * g + w + tb + np_cam, pc=PC)
    p = _planes(g, tb, np_cam, seed=g + tb)
    args = (d["wcam"], p["jc"], p["jp"], p["r"], p["v_inv"])
    want = j_contrib(*map(_j, args), np_cam, tb, PC, w, use_sj, interpret=True)
    got = wtt_linearize.wtt_contrib_rows_idx(*map(_t, args), np_cam, w, use_sj)
    assert got.shape == (g, w, wtt_linearize.n_contrib_cols(np_cam, use_sj))
    assert_close(got, want, RTOL, ATOL_REL)


@pytest.mark.parametrize("g,w,tb,np_cam", [(2, 128, 2, 8), (3, 256, 3, 8), (1, 128, 4, 12)])
def test_w_rows_match_pallas(g, w, tb, np_cam):
    d = wtt_kernel_inputs(g, w, tb, np_cam, seed=5 * g + w + tb, pc=PC)
    p = _planes(g, tb, np_cam, seed=2 * g + tb)
    args = (p["y"], d["wcam"], p["jc"], p["jp"])
    want = j_w_rows(*map(_j, args), np_cam, tb, PC, w, interpret=True)
    got = wtt_matvec.wtt_w_rows_idx(*map(_t, args), w)
    assert got.shape == (g, np_cam, w)
    assert_close(got, want, RTOL, ATOL_REL)


@pytest.mark.parametrize("oh_dtype", [np.int8, np.float64])
@pytest.mark.parametrize("g,w,tb", [(2, 128, 2), (1, 256, 3)])
def test_fused_coupling_matches_pallas(g, w, tb, oh_dtype):
    d = wtt_kernel_inputs(g, w, tb, 8, seed=7 * g + w + tb, pc=PC)
    p = _planes(g, tb, 8, seed=3 * g + tb)
    oh = _onehot(d["wcam"], w).astype(oh_dtype)
    args = (d["xw_t"], oh, p["jc"], p["jp"], p["v_inv"])
    want = j_fused(*map(_j, args), 8, tb, PC, w, interpret=True)
    got = wtt_matvec.wtt_coupling_rows_fused(*map(_t, args))
    assert got.shape == (g, 8, w)
    assert_close(got, want, RTOL, ATOL_REL)
    # The same rows as B2's through wcam, on a well-formed one-hot.
    idx = wtt_matvec.wtt_coupling_rows_idx(*map(_t, (d["xw_t"], d["wcam"], *args[2:])))
    assert_close(got, idx, RTOL, ATOL_REL)


def test_fused_coupling_plain_is_the_literal_product():
    """A malformed column (two 1s) counts both rows in the plain version, as
    in the JAX kernel's one-hot dots; the CUDA kernel reads only the first
    (tests/test_torch_cuda_kernels.py)."""
    g, w, tb = 1, 128, 2
    d = wtt_kernel_inputs(g, w, tb, 8, seed=11, pc=PC)
    p = _planes(g, tb, 8, seed=12)
    oh = _onehot(d["wcam"], w)
    col = int(np.flatnonzero(d["wcam"][0] >= 0)[0])
    oh[0, (d["wcam"][0, col] + 1) % w, col] = 1
    args = (d["xw_t"], oh, p["jc"], p["jp"], p["v_inv"])
    want = j_fused(*map(_j, args), 8, tb, PC, w, interpret=True)
    got = wtt_matvec.wtt_coupling_rows_fused(*map(_t, args))
    assert_close(got, want, RTOL, ATOL_REL)
    well = wtt_matvec.wtt_coupling_rows_fused(*map(_t, (d["xw_t"], _onehot(d["wcam"], w),
                                                         *args[2:])))
    assert not torch.allclose(got, well)


def test_cpu_tensors_run_the_plain_versions():
    """A CPU call runs the plain version (its counter grows) and never the
    kernel; want_od raises as B1's does."""
    g, w, tb = 1, 128, 2
    d = wtt_kernel_inputs(g, w, tb, 8, seed=1, pc=PC)
    p = {k: _t(v) for k, v in _planes(g, tb, 8, seed=1).items()}
    wcam = _t(d["wcam"])
    counters = (wtt_linearize.CAM_PLANES_COUNTS, wtt_linearize.CONTRIB_COUNTS,
                wtt_matvec.W_ROWS_COUNTS, wtt_matvec.FUSED_COUNTS)
    before = [(c.kernel, c.plain) for c in counters]
    wtt_linearize.wtt_cam_planes_idx(wcam, _t(d["tw"]), tb)
    wtt_linearize.wtt_contrib_rows_idx(wcam, p["jc"], p["jp"], p["r"], p["v_inv"], 8, w, True)
    wtt_matvec.wtt_w_rows_idx(p["y"], wcam, p["jc"], p["jp"], w)
    wtt_matvec.wtt_coupling_rows_fused(_t(d["xw_t"]), _t(_onehot(d["wcam"], w)), p["jc"],
                                       p["jp"], p["v_inv"])
    after = [(c.kernel, c.plain) for c in counters]
    assert [a[0] - b[0] for a, b in zip(after, before)] == [0, 0, 0, 0]
    assert [a[1] - b[1] for a, b in zip(after, before)] == [1, 1, 1, 1]
    with pytest.raises(NotImplementedError, match="want_od"):
        wtt_linearize.wtt_contrib_rows_idx(wcam, p["jc"], p["jp"], p["r"], p["v_inv"], 8, w,
                                           True, want_od=True)
    with pytest.raises(ValueError, match="device"):
        wtt_linearize.wtt_cam_planes_idx(wcam, torch.empty(1, device="meta"), tb)
