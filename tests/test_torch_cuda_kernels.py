"""The CUDA kernels vs their plain PyTorch versions, on the card: the four
wtt kernels (B1-B4) and the grid engine's three (B9-B11).

Needs an NVIDIA GPU with nvcc (the kernels build at first use); skips where
``torch.cuda.is_available()`` is false.  Imports no jax, so on a machine
without it run it with the repo's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); rows reduced with atomics (linearize rows, coupling rows) and
the grid kernels' per-camera block sums (U, g, coupling) 1e-4 and 1e-10,
because their summation order differs from the plain version's.
"""

import numpy as np
import pytest
import torch

from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops import (
    cam_normal,
    coupling,
    point_normal,
    wtt_cost,
    wtt_linearize,
    wtt_matvec,
)
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


def _grid_inputs(dev, dtype, c, k, p, t2, seed):
    """B9 inputs for C cameras near a pinhole looking down +z from z ~ 6
    with 15 % masked lanes, and B10 track rows for P points (some rows
    zero, as padded track entries are)."""
    rng = np.random.default_rng(seed)
    rmats = np.eye(3) + rng.normal(scale=0.05, size=(c, 3, 3))
    tvecs = np.concatenate([rng.normal(scale=0.3, size=(c, 2)),
                            rng.uniform(5.0, 7.0, size=(c, 1))], axis=1)
    mask = (rng.random((c, k)) > 0.15).astype(np.float64)
    jp_g = rng.normal(size=(p, t2, 3))
    jp_g[rng.random((p, t2)) < 0.3] = 0.0

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return dict(
        cams=(t(rmats), t(tvecs), t(rng.uniform(1000, 1100, size=(c, 2))),
              t(np.concatenate([rng.uniform(600, 680, size=(c, 2)),
                                np.zeros((c, 1))], axis=1)),
              t(np.stack([rng.uniform(-0.05, 0.0, c), rng.uniform(0.0, 0.01, c)], 1))),
        x_w=t(rng.normal(size=(c, 3, k))),
        uv=t(rng.uniform(300, 1000, size=(c, 2, k))),
        mask=t(mask),
        inv_w=torch.tensor(1.0 / 1280.0, dtype=dtype, device=dev),
        jp_g=t(jp_g),
        r_g=t(rng.normal(size=(p, t2))),
        lam=torch.tensor(1e-4, dtype=dtype, device=dev),
        vinv6=t(rng.normal(size=(c, 6, k))),
    )


GRID_CASES = [  # (dtype, loss, K, P, T2); K and P not multiples of 256
    (torch.float32, "trivial", 300, 257, 4),
    (torch.float64, "trivial", 2048, 600, 24),
    (torch.float32, "cauchy", 1000, 513, 6),
    (torch.float64, "huber", 300, 100, 16),
]


@pytest.mark.parametrize("dtype,loss,k,p,t2", GRID_CASES)
def test_grid_kernels_match_plain(dev, dtype, loss, k, p, t2):
    d = _grid_inputs(dev, dtype, 5, k, p, t2, seed=k + p + t2)
    elem, reduced = TOL[dtype]
    counts = (cam_normal.COUNTS, point_normal.COUNTS, coupling.COUNTS)
    before = [c.kernel for c in counts]

    cam_args = (*d["cams"], d["x_w"], d["uv"], d["mask"], d["inv_w"])
    got = cam_normal.cam_normal_fused(*cam_args, loss=RobustLoss(loss))
    want = cam_normal.cam_normal_fused_plain(*cam_args, loss=RobustLoss(loss))
    for name, a, b in zip(("r", "jp", "jc", "u", "g"), got, want):
        _close(a, b, reduced if name in ("u", "g") else elem, name)
    pad = (d["mask"] == 0)[:, None, :]
    for plane in got[:3]:
        assert (plane.masked_select(pad.expand_as(plane)) == 0).all()
    assert (got[2][:, 7] == 0).all() and (got[2][:, 14] == 0).all()

    pn_args = (d["jp_g"], d["r_g"], d["lam"])
    for name, a, b in zip(("v_inv", "g_pt", "damp_pt"),
                          point_normal.point_normal_fused(*pn_args),
                          point_normal.point_normal_fused_plain(*pn_args)):
        _close(a, b, elem, name)

    _, jp, jc, _, _ = want
    _close(coupling.coupling_fused(jc, jp, d["vinv6"]),
           coupling.coupling_fused_plain(jc, jp, d["vinv6"]), reduced, "coupling")
    assert [c.kernel - b for c, b in zip(counts, before)] == [1, 1, 1]


def test_grid_bad_inputs_raise(dev):
    d = _grid_inputs(dev, torch.float32, 3, 256, 64, 4, seed=5)
    cam_args = (*d["cams"], d["x_w"].transpose(1, 2).contiguous().transpose(1, 2),
                d["uv"], d["mask"], d["inv_w"])
    with pytest.raises(ValueError, match="contiguous"):
        cam_normal.cam_normal_fused(*cam_args)
    with pytest.raises(ValueError, match="dtype"):
        point_normal.point_normal_fused(d["jp_g"], d["r_g"].double(), d["lam"])
    jc = torch.zeros((3, 16, 256), device=dev)
    with pytest.raises(ValueError, match="shape"):
        coupling.coupling_fused(jc, d["vinv6"], d["vinv6"][:, :, :128].contiguous())
    with pytest.raises(ValueError, match="float32 or float64"):
        coupling.coupling_fused(jc.half(), d["vinv6"].half(), d["vinv6"].half())
