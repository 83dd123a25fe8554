"""The four CUDA wtt kernels vs their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels build at first use); skips where
``torch.cuda.is_available()`` is false.  Imports no jax, so on a machine
without it run it with the repo's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); rows reduced with atomics (linearize rows, coupling rows)
1e-4 and 1e-10, because the atomic summation order varies from run to run.
"""

import numpy as np
import pytest
import torch

from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops import wtt_cost, wtt_linearize, wtt_matvec
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}
PC = 300  # not a multiple of the 256-thread block: exercises the ragged edge


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, dtype, g, w, tb, np_cam, seed):
    rng = np.random.default_rng(seed)
    wcam = rng.integers(0, w, size=(g, tb * PC)).astype(np.int16)
    wcam[rng.random(wcam.shape) < 0.15] = -1
    # Camera rows near a pinhole camera looking down +z from z ~ -6.
    tw = np.zeros((g, w, 19))
    tw[..., [0, 4, 8]] = 1.0
    tw[..., :9] += rng.normal(scale=0.05, size=(g, w, 9))
    tw[..., 9:11] = rng.normal(scale=0.3, size=(g, w, 2))
    tw[..., 11] = rng.uniform(5.0, 7.0, size=(g, w))
    tw[..., 12:14] = rng.uniform(1000, 1100, size=(g, w, 2))
    tw[..., 14:16] = rng.uniform(600, 680, size=(g, w, 2))
    tw[..., 17] = rng.uniform(-0.05, 0.0, size=(g, w))
    tw[..., 18] = rng.uniform(0.0, 0.01, size=(g, w))

    def t(x, dt=dtype):
        return torch.as_tensor(np.array(x), dtype=dt, device=dev)

    return dict(
        wcam=t(wcam, torch.int16),
        tw=t(tw),
        pts=t(rng.normal(size=(3, g, PC))),
        uv=t(rng.uniform(300, 1000, size=(g, 2, tb, PC))),
        mask=t((wcam >= 0).reshape(g, tb, PC)),
        lam=torch.tensor(1e-4, dtype=dtype, device=dev),
        inv_w=torch.tensor(1.0 / 1280.0, dtype=dtype, device=dev),
        xw_t=t(rng.normal(size=(g, np_cam, w))),
    )


def _close(got, want, rel, what):
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:.0e} * {scale:.3e}"


CASES = [  # (dtype, G, W, Tb, np, loss, use_sj)
    (torch.float32, 1, 128, 2, 8, "trivial", True),
    (torch.float64, 1, 128, 12, 8, "trivial", True),
    (torch.float32, 2, 256, 3, 10, "cauchy", True),
    (torch.float64, 2, 128, 4, 12, "huber", True),
    (torch.float32, 3, 128, 2, 8, "huber", False),
]


@pytest.mark.parametrize("dtype,g,w,tb,np_cam,loss,use_sj", CASES)
def test_kernels_match_plain(dev, dtype, g, w, tb, np_cam, loss, use_sj):
    d = _inputs(dev, dtype, g, w, tb, np_cam, seed=g + w + tb + np_cam)
    elem, reduced = TOL[dtype]
    cfg = BAConfig(loss=RobustLoss(loss), optimize_dist=np_cam >= 10,
                   optimize_pp=np_cam == 12)
    lin_args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"],
                d["inv_w"], cfg, np_cam, use_sj)
    c0 = wtt_linearize.COUNTS.kernel
    got = wtt_linearize.wtt_linearize_fused_idx(*lin_args)
    assert wtt_linearize.COUNTS.kernel == c0 + 1
    want = wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)
    for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
        _close(a, b, reduced if name == "rows" else elem, name)
    pad = (d["wcam"] < 0).reshape(g, tb, PC)
    assert (got[1][:, pad] == 0).all() and (got[2][:, pad] == 0).all()

    _, jc, jp, v_inv, _, _ = want
    mv = (d["xw_t"], d["wcam"], jc, jp)
    _close(wtt_matvec.wtt_coupling_rows_idx(*mv, v_inv),
           wtt_matvec.wtt_coupling_rows_idx_plain(*mv, v_inv), reduced, "coupling")
    _close(wtt_matvec.wtt_wt_planes_idx(*mv),
           wtt_matvec.wtt_wt_planes_idx_plain(*mv), elem, "wt planes")
    cost = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss(loss))
    _close(wtt_cost.wtt_cost_cols_idx(*cost),
           wtt_cost.wtt_cost_cols_idx_plain(*cost), elem, "cost")


def test_bad_inputs_raise(dev):
    d = _inputs(dev, torch.float32, 1, 128, 2, 8, seed=3)
    with pytest.raises(ValueError, match="dtype"):
        wtt_cost.wtt_cost_cols_idx(d["wcam"].int(), d["tw"], d["pts"], d["uv"],
                                   d["mask"], RobustLoss.TRIVIAL)
    with pytest.raises(ValueError, match="contiguous"):
        wtt_matvec.wtt_wt_planes_idx(
            d["xw_t"].transpose(1, 2).contiguous().transpose(1, 2),
            d["wcam"], *wtt_linearize.wtt_linearize_fused_idx(
                d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"],
                d["inv_w"], BAConfig(), 8, True)[1:3],
        )
    wide = _inputs(dev, torch.float64, 1, 1024, 2, 8, seed=4)
    with pytest.raises(RuntimeError, match="shared memory"):
        wtt_linearize.wtt_linearize_fused_idx(
            wide["wcam"], wide["tw"], wide["pts"], wide["uv"], wide["mask"],
            wide["lam"], wide["inv_w"], BAConfig(), 8, True)
