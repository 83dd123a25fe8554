"""The CUDA kernels vs their plain PyTorch versions, on the card: the four
wtt kernels of the indexed route (B1-B4) and the four of its unfused and
one-hot routes (B5-B8), B1's and B8's band pair rows (``want_od``), the
grid engine's three (B9-B11) and the dense track table's five (B12-B16).

Needs an NVIDIA GPU with nvcc (the kernels build at first use); skips where
``torch.cuda.is_available()`` is false.  Imports no jax, so on a machine
without it run it with the repo's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances, relative to max|plain|: per-element outputs 1e-5 (f32) and
1e-12 (f64); rows reduced with atomics (linearize rows, coupling rows, the
tt kernels' camera columns) and the grid kernels' per-camera block sums
(U, g, coupling) 1e-4 and 1e-10, because their summation order differs
from the plain version's.  B7 (a row selection) must be bit-equal.
"""

import numpy as np
import pytest
import torch

from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops import (
    cam_normal,
    coupling,
    point_normal,
    tt_linearize,
    wtt_cost,
    wtt_linearize,
    wtt_matvec,
)
from tpu3drecon_torch.solvers.ba_tt import _tt_blocks
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
    with pytest.raises(ValueError, match="shared memory"):
        wtt_linearize.wtt_linearize_fused_idx(
            wide["wcam"], wide["tw"], wide["pts"], wide["uv"], wide["mask"],
            wide["lam"], wide["inv_w"], BAConfig(), 8, True)


ROUTE_CASES = [  # (dtype, G, W, Tb, np, use_sj)
    (torch.float32, 1, 128, 2, 8, True),
    (torch.float64, 1, 128, 12, 8, True),
    (torch.float32, 2, 256, 3, 10, False),
    (torch.float64, 2, 128, 4, 12, True),
]


@pytest.mark.parametrize("dtype,g,w,tb,np_cam,use_sj", ROUTE_CASES)
def test_route_kernels_match_plain(dev, dtype, g, w, tb, np_cam, use_sj):
    """B5-B8.  Window row 0 is NaN and only padded slots point at it (and
    padded slots of jc/jp/r are NaN for B5 and B8): a kernel that read them
    would give NaN where the plain version gives exact zeros."""
    d = _inputs(dev, dtype, g, w, tb, np_cam, seed=2 * g + w + tb + np_cam)
    elem, reduced = TOL[dtype]
    counts = (wtt_linearize.CAM_PLANES_COUNTS, wtt_linearize.CONTRIB_COUNTS,
              wtt_matvec.W_ROWS_COUNTS, wtt_matvec.FUSED_COUNTS)
    before = [c.kernel for c in counts]
    wcam = torch.where(d["wcam"] == 0, torch.full_like(d["wcam"], -1), d["wcam"])
    pad = (wcam < 0).reshape(g, tb, PC)
    tw = d["tw"].clone()
    tw[:, 0] = float("nan")

    planes = wtt_linearize.wtt_cam_planes_idx(wcam, tw, tb)
    torch.cuda.synchronize()
    assert torch.equal(planes, wtt_linearize.wtt_cam_planes_idx_plain(wcam, tw, tb)), "B7"
    assert (planes.transpose(0, 1)[:, pad] == 0).all()

    cfg = BAConfig(optimize_dist=np_cam >= 10, optimize_pp=np_cam == 12)
    blocks = _tt_blocks(planes.transpose(0, 1), d["pts"][:, :, None, :],
                        d["uv"].transpose(0, 1), (~pad).to(dtype), d["inv_w"], cfg)
    v_inv = wtt_linearize.point_normal(blocks.jp, blocks.r, d["lam"])[0].contiguous()
    jc, jp, r = blocks.jc.clone(), blocks.jp.clone(), blocks.r.clone()
    for x in (jc, jp, r):
        x[:, pad] = float("nan")
    b8 = (wcam, jc, jp, r, v_inv, np_cam, w, use_sj)
    rows = wtt_linearize.wtt_contrib_rows_idx(*b8)
    assert torch.isfinite(rows).all()
    _close(rows, wtt_linearize.wtt_contrib_rows_idx_plain(*b8), reduced, "B8")
    y = torch.randn(3, g, PC, dtype=dtype, device=dev)
    b5 = (y, wcam, jc, jp, w)
    _close(wtt_matvec.wtt_w_rows_idx(*b5), wtt_matvec.wtt_w_rows_idx_plain(*b5), reduced, "B5")

    jc, jp = blocks.jc, blocks.jp  # B6's plain version is the literal product
    onehot = (wcam[:, None, :] == torch.arange(w, device=dev)[None, :, None]).to(torch.int8)
    for oh in (onehot, onehot.to(dtype)):
        b6 = (d["xw_t"], oh, jc, jp, v_inv)
        _close(wtt_matvec.wtt_coupling_rows_fused(*b6),
               wtt_matvec.wtt_coupling_rows_fused_plain(*b6), reduced, f"B6 {oh.dtype}")
    _close(wtt_matvec.wtt_coupling_rows_fused(d["xw_t"], onehot, jc, jp, v_inv),
           wtt_matvec.wtt_coupling_rows_idx_plain(d["xw_t"], wcam, jc, jp, v_inv),
           reduced, "B6 vs B2")
    # A malformed column (a second 1 below the slot's row): the kernel reads
    # the first 1, the plain version sums both.
    col = int(torch.nonzero((wcam[0] >= 0) & (wcam[0] < w - 1))[0])
    bad = onehot.clone()
    bad[0, int(wcam[0, col]) + 1, col] = 1
    got = wtt_matvec.wtt_coupling_rows_fused(d["xw_t"], bad, jc, jp, v_inv)
    _close(got, wtt_matvec.wtt_coupling_rows_fused_plain(d["xw_t"], onehot, jc, jp, v_inv),
           reduced, "B6 malformed column")
    assert not torch.allclose(
        got, wtt_matvec.wtt_coupling_rows_fused_plain(d["xw_t"], bad, jc, jp, v_inv))
    assert [c.kernel - b for c, b in zip(counts, before)] == [1, 1, 1, 4]


OD_CASES = [  # (dtype, G, W, Tb, np); each (W, K) tile within 227 KB
    (torch.float32, 1, 256, 4, 8),
    (torch.float64, 2, 128, 3, 8),
    (torch.float64, 1, 128, 1, 8),
    (torch.float32, 1, 128, 3, 10),
]


@pytest.mark.parametrize("dtype,g,w,tb,np_cam", OD_CASES)
def test_od_kernels_match_plain(dev, dtype, g, w, tb, np_cam):
    """B1 and B8 with want_od on tracks that walk through adjacent window
    rows; window row 0 and the padded slots' planes are NaN.  Tb = 1 gives
    exact-zero od columns."""
    d = _inputs(dev, dtype, g, w, tb, np_cam, seed=3 * g + w + tb)
    rng = np.random.default_rng(w + tb)
    steps = np.where(rng.random((g, tb, PC)) < 0.75, 1, 2)
    steps[:, 0] = rng.integers(1, w - 2 * tb, size=(g, PC))  # row 0 is poisoned
    length = rng.integers(0, tb + 1, size=(g, 1, PC))
    wcam = np.where(np.arange(tb)[None, :, None] < length, np.cumsum(steps, axis=1), -1)
    wcam = torch.as_tensor(wcam.reshape(g, tb * PC).astype(np.int16), device=dev)
    pad = (wcam < 0).reshape(g, tb, PC)
    tw = d["tw"].clone()
    tw[:, 0] = float("nan")
    elem, reduced = TOL[dtype]
    cfg = BAConfig(optimize_dist=np_cam >= 10, optimize_pp=np_cam == 12)
    lin_args = (wcam, tw, d["pts"], d["uv"], (~pad).to(dtype), d["lam"], d["inv_w"], cfg,
                np_cam, True, True)
    before = (wtt_linearize.OD_COUNTS.kernel, wtt_linearize.CONTRIB_OD_COUNTS.kernel)
    got = wtt_linearize.wtt_linearize_fused_idx(*lin_args)
    want = wtt_linearize.wtt_linearize_fused_idx_plain(*lin_args)
    for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
        assert torch.isfinite(a).all(), name
        _close(a, b, reduced if name == "rows" else elem, f"B1 od {name}")
    od = got[0][..., -np_cam * np_cam:]
    assert (od == 0).all() if tb == 1 else (od != 0).any()

    _, jc, jp, v_inv, _, _ = want
    jc, jp = jc.clone(), jp.clone()
    r = torch.randn(2, g, tb, PC, dtype=dtype, device=dev)
    for x in (jc, jp, r):
        x[:, pad] = float("nan")
    b8 = (wcam, jc, jp, r, v_inv, np_cam, w, True, True)
    rows = wtt_linearize.wtt_contrib_rows_idx(*b8)
    assert torch.isfinite(rows).all()
    _close(rows, wtt_linearize.wtt_contrib_rows_idx_plain(*b8), reduced, "B8 od")
    _close(rows[..., -np_cam * np_cam:], od, reduced, "B8 od vs B1 od")
    assert (wtt_linearize.OD_COUNTS.kernel, wtt_linearize.CONTRIB_OD_COUNTS.kernel) == (
        before[0] + 1, before[1] + 1)


def test_route_kernels_refuse_bad_inputs(dev):
    """B8's (W, K) tile above the card's shared memory raises ValueError;
    B6 takes an int8 or the data's float one-hot only."""
    d = _inputs(dev, torch.float64, 1, 256, 2, 12, seed=9)
    z = torch.zeros((24, 1, 2, PC), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        wtt_linearize.wtt_contrib_rows_idx(d["wcam"], z, z[:6], z[:2],
                                           z[:6, :, 0].contiguous(), 12, 256, True)
    onehot = torch.zeros((1, 256, 2 * PC), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="onehot"):
        wtt_matvec.wtt_coupling_rows_fused(d["xw_t"], onehot, z, z[:6],
                                           z[:6, :, 0].contiguous())


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


def _tt_inputs(dev, dtype, c, tb, pb, seed):
    """tt kernel inputs: C cameras near a pinhole looking down +z from
    z ~ 6, 15 % padded slots.  Padded slots carry camera 0, as the packer
    writes them, and no real slot uses camera 0, whose row is NaN: a kernel
    that read camera 0's row for a padded slot would give NaN."""
    rng = np.random.default_rng(seed)
    mask = rng.random((tb, pb)) > 0.15
    cam_ids = np.where(mask, rng.integers(1, c, size=(tb, pb)), 0).astype(np.int32)
    table = np.zeros((c, 19))
    table[:, [0, 4, 8]] = 1.0
    table[:, :9] += rng.normal(scale=0.05, size=(c, 9))
    table[:, 9:11] = rng.normal(scale=0.3, size=(c, 2))
    table[:, 11] = rng.uniform(5.0, 7.0, size=c)
    table[:, 12:14] = rng.uniform(1000, 1100, size=(c, 2))
    table[:, 14:16] = rng.uniform(600, 680, size=(c, 2))
    table[:, 17] = rng.uniform(-0.05, 0.0, size=c)
    table[:, 18] = rng.uniform(0.0, 0.01, size=c)
    table[0] = np.nan

    def t(x, dt=dtype):
        return torch.as_tensor(np.array(x), dtype=dt, device=dev)

    return dict(
        table=t(table), cam_ids=t(cam_ids, torch.int32), pts=t(rng.normal(size=(3, pb))),
        uv=t(rng.uniform(300, 1000, size=(2, tb, pb))), mask=t(mask),
        inv_w=torch.tensor(1.0 / 1280.0, dtype=dtype, device=dev),
        x=t(rng.normal(size=(c, 12))), y=t(rng.normal(size=(3, pb))),
        v_inv=t(rng.normal(size=(6, pb))),
    )


TT_CASES = [  # (dtype, C, Tb, Pb, np, loss); Pb not a multiple of 256
    (torch.float32, 100, 2, 300, 8, "trivial"),
    (torch.float64, 100, 12, 300, 8, "trivial"),
    (torch.float32, 37, 3, 1000, 10, "cauchy"),
    (torch.float64, 100, 4, 513, 12, "huber"),
]


@pytest.mark.parametrize("dtype,c,tb,pb,np_cam,loss", TT_CASES)
def test_tt_kernels_match_plain(dev, dtype, c, tb, pb, np_cam, loss):
    d = _tt_inputs(dev, dtype, c, tb, pb, seed=c + tb + pb + np_cam)
    elem, reduced = TOL[dtype]
    cfg = BAConfig(loss=RobustLoss(loss), optimize_dist=np_cam >= 10,
                   optimize_pp=np_cam == 12)
    counts = (tt_linearize.CAM_COUNTS, tt_linearize.COUPLING_COUNTS,
              tt_linearize.WT_COUNTS, tt_linearize.W_COUNTS, tt_linearize.COST_COUNTS)
    before = [c_.kernel for c_ in counts]

    b12 = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"], cfg, np_cam)
    got = tt_linearize.tt_cam_normal_fused(*b12)
    want = tt_linearize.tt_cam_normal_fused_plain(*b12)
    for name, a, b in zip(("jc", "jp", "v6", "g_pt", "ug"), got, want):
        assert torch.isfinite(a).all(), name
        _close(a, b, reduced if name == "ug" else elem, name)
    pad = d["mask"] == 0
    assert (got[0][:, pad] == 0).all() and (got[1][:, pad] == 0).all()
    assert (got[4][0] == 0).all()  # camera 0 has only padded slots

    jc, jp = want[0], want[1]
    slots = (d["cam_ids"], d["mask"], jc, jp)
    x = d["x"][:, :np_cam].contiguous()
    _close(tt_linearize.tt_coupling_fused(*slots, d["v_inv"], c),
           tt_linearize.tt_coupling_fused_plain(*slots, d["v_inv"], c), reduced, "B13")
    _close(tt_linearize.tt_wt_times_fused(x, *slots),
           tt_linearize.tt_wt_times_fused_plain(x, *slots), elem, "B14")
    _close(tt_linearize.tt_w_times_fused(d["y"], *slots, c),
           tt_linearize.tt_w_times_fused_plain(d["y"], *slots, c), reduced, "B15")
    b16 = b12[:7]
    _close(tt_linearize.tt_cost_fused(*b16), tt_linearize.tt_cost_fused_plain(*b16),
           elem, "B16")
    assert [c_.kernel - b for c_, b in zip(counts, before)] == [1] * 5


def test_tt_kernels_refuse_wide_camera_axes(dev):
    """Above the card's shared memory per block the wrappers raise
    ValueError naming the limit; they do not fall back."""
    d = _tt_inputs(dev, torch.float64, 400, 2, 300, seed=8)
    cfg = BAConfig(optimize_dist=True, optimize_pp=True)
    with pytest.raises(ValueError, match="shared memory"):
        tt_linearize.tt_cam_normal_fused(d["table"], d["cam_ids"], d["pts"], d["uv"],
                                         d["mask"], d["inv_w"], cfg, 12)
    with pytest.raises(ValueError, match="int32"):
        tt_linearize.tt_wt_times_fused(d["x"][:, :8].contiguous(), d["cam_ids"].long(),
                                       d["mask"], d["x"].new_zeros(16, 2, 300),
                                       d["x"].new_zeros(6, 2, 300))
