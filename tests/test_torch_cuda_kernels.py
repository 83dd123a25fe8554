"""The CUDA kernels vs their plain PyTorch versions, on the card: the four
wtt kernels of the indexed route (B1-B4) and the four of its unfused and
one-hot routes (B5-B8), B1's and B8's band pair rows (``want_od``), B1 at
terms 2 and B2 at terms 1 and 2 (the reduced-fidelity modes), the grid
engine's three (B9-B11), the dense track table's five (B12-B16), and the
probe kernels of ``tpu3drecon_torch.experiments`` (E1's copies of B2, E4's
bit expansion); the slot-major B1, B2, B6, B8 and B12-B15 also on tracks
longer than one block's chunk, all-padding buckets, the hub layout's width
and warps whose lanes hit different rows; B6 at every one-hot load width.
The kernels read camera rows from device memory and reduce into the output
rows directly, so wide windows and camera axes run: one input per kernel
family past the card's shared memory per block.  B15 also keeps a
block-shared tile at small camera counts: its global mode is forced
(``_mode``) on small inputs, and chosen by the wrapper at large camera
counts.

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
    _build,
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
SHARED, GLOBAL = _build.SHARED, _build.GLOBAL
PC = 300  # not a multiple of the 256-thread block: exercises the ragged edge


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, dtype, g, w, tb, np_cam, seed, pc=PC):
    rng = np.random.default_rng(seed)
    wcam = rng.integers(0, w, size=(g, tb * pc)).astype(np.int16)
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
        pts=t(rng.normal(size=(3, g, pc))),
        uv=t(rng.uniform(300, 1000, size=(g, 2, tb, pc))),
        mask=t((wcam >= 0).reshape(g, tb, pc)),
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
    # A window of any width runs (its rows would not fit a shared tile).
    wide = _inputs(dev, torch.float64, 1, 1024, 2, 8, seed=4)
    args = (wide["wcam"], wide["tw"], wide["pts"], wide["uv"], wide["mask"], wide["lam"],
            wide["inv_w"], BAConfig(), 8, True)
    g0 = wtt_linearize.COUNTS.modes.get(GLOBAL, 0)
    _close(wtt_linearize.wtt_linearize_fused_idx(*args)[0],
           wtt_linearize.wtt_linearize_fused_idx_plain(*args)[0], 1e-10, "wide rows")
    assert wtt_linearize.COUNTS.modes[GLOBAL] == g0 + 1


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


def _track_wcam(dev, g, w, tb, seed, pc=PC):
    """(G, Tb * pc) int16 window rows of tracks that walk through adjacent
    rows (steps of 1 or 2, so the od rows have pairs), -1 past each track's
    end; window row 0 is never used (tests poison it)."""
    rng = np.random.default_rng(seed)
    steps = np.where(rng.random((g, tb, pc)) < 0.75, 1, 2)
    steps[:, 0] = rng.integers(1, w - 2 * tb, size=(g, pc))
    length = rng.integers(0, tb + 1, size=(g, 1, pc))
    wcam = np.where(np.arange(tb)[None, :, None] < length, np.cumsum(steps, axis=1), -1)
    return torch.as_tensor(wcam.reshape(g, tb * pc).astype(np.int16), device=dev)


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
    wcam = _track_wcam(dev, g, w, tb, seed=w + tb)
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
    """B8 takes rows wider than the card's shared memory (zero planes give
    zero rows); B6 takes the f64 np = 12 window of 1280 rows whose shared
    tiles the old kernel could not hold (zero planes give zero rows), and an
    int8 or the data's float one-hot only."""
    d = _inputs(dev, torch.float64, 1, 256, 2, 12, seed=9)
    z = torch.zeros((24, 1, 2, PC), dtype=torch.float64, device=dev)
    b8 = (d["wcam"], z, z[:6], z[:2], z[:6, :, 0].contiguous(), 12, 256, True)
    g0 = wtt_linearize.CONTRIB_COUNTS.modes.get(GLOBAL, 0)
    rows = wtt_linearize.wtt_contrib_rows_idx(*b8)
    torch.cuda.synchronize()
    assert (rows == 0).all() and wtt_linearize.CONTRIB_COUNTS.modes[GLOBAL] == g0 + 1
    wide = _inputs(dev, torch.float64, 1, 1280, 2, 12, seed=10)
    b6 = (wide["xw_t"], torch.zeros((1, 1280, 2 * PC), dtype=torch.int8, device=dev),
          z, z[:6], z[:6, :, 0].contiguous())
    rows = wtt_matvec.wtt_coupling_rows_fused(*b6)
    torch.cuda.synchronize()
    assert rows.shape == (1, 12, 1280) and (rows == 0).all()
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
    """A camera axis past the card's shared memory per block runs (B12's
    tiles would not fit; nothing falls back to a plain version), and B15's
    shared mode forced there raises; ``cam_ids`` must be int32."""
    d = _tt_inputs(dev, torch.float64, 400, 2, 300, seed=8)
    cfg = BAConfig(optimize_dist=True, optimize_pp=True)
    b12 = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"], cfg, 12)
    before = (tt_linearize.CAM_COUNTS.modes.get(GLOBAL, 0), tt_linearize.CAM_COUNTS.plain)
    got = tt_linearize.tt_cam_normal_fused(*b12)
    for name, a, b in zip(("jc", "jp", "v6", "g_pt", "ug"), got,
                          tt_linearize.tt_cam_normal_fused_plain(*b12)):
        _close(a, b, 1e-10 if name == "ug" else 1e-12, name)
    assert (tt_linearize.CAM_COUNTS.modes[GLOBAL],
            tt_linearize.CAM_COUNTS.plain) == (before[0] + 1, before[1] + 1)
    y = d["x"].new_zeros(3, 300)
    with pytest.raises(RuntimeError, match="shared-memory mode"):
        tt_linearize.tt_w_times_fused(y, d["cam_ids"], d["mask"], got[0], got[1], 2500,
                                      _mode=SHARED)
    with pytest.raises(ValueError, match="int32"):
        tt_linearize.tt_wt_times_fused(d["x"][:, :8].contiguous(), d["cam_ids"].long(),
                                       d["mask"], d["x"].new_zeros(16, 2, 300),
                                       d["x"].new_zeros(6, 2, 300))


GLOBAL_CASES = [  # (dtype, G, W, Tb, np)
    (torch.float32, 2, 128, 3, 8),
    (torch.float64, 2, 128, 4, 12),
]


@pytest.mark.parametrize("dtype,g,w,tb,np_cam", GLOBAL_CASES)
def test_wtt_global_mode_matches_plain(dev, dtype, g, w, tb, np_cam):
    """B1 (with and without od), B2, B3, B4, B5, B6 and B8 (with and
    without od) in their one mode, on tracks that walk adjacent window rows.  Window row 0 is NaN and only padded
    slots could reach it; B5 and B8 also get NaN jc/jp/r on padded slots."""
    d = _inputs(dev, dtype, g, w, tb, np_cam, seed=5 * g + w + tb)
    wcam = _track_wcam(dev, g, w, tb, seed=w + 2 * tb)
    pad = (wcam < 0).reshape(g, tb, PC)
    mask = (~pad).to(dtype)
    tw = d["tw"].clone()
    tw[:, 0] = float("nan")
    elem, reduced = TOL[dtype]
    cfg = BAConfig(loss=RobustLoss.CAUCHY, optimize_dist=np_cam >= 10,
                   optimize_pp=np_cam == 12)
    counts = (wtt_linearize.COUNTS, wtt_linearize.OD_COUNTS, wtt_matvec.COUPLING_COUNTS,
              wtt_matvec.WT_COUNTS, wtt_cost.COUNTS, wtt_matvec.W_ROWS_COUNTS,
              wtt_matvec.FUSED_COUNTS, wtt_linearize.CONTRIB_COUNTS,
              wtt_linearize.CONTRIB_OD_COUNTS)
    before = [c.modes.get(GLOBAL, 0) for c in counts]

    for od in (False, True):
        args = (wcam, tw, d["pts"], d["uv"], mask, d["lam"], d["inv_w"], cfg, np_cam,
                True, od)
        got = wtt_linearize.wtt_linearize_fused_idx(*args)
        want = wtt_linearize.wtt_linearize_fused_idx_plain(*args)
        for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
            assert torch.isfinite(a).all(), name
            _close(a, b, reduced if name == "rows" else elem, f"B1 od={od} {name}")

    _, jc, jp, v_inv, g_pt, _ = want
    mv = (d["xw_t"], wcam, jc, jp)
    _close(wtt_matvec.wtt_coupling_rows_idx(*mv, v_inv),
           wtt_matvec.wtt_coupling_rows_idx_plain(*mv, v_inv), reduced, "B2")
    _close(wtt_matvec.wtt_wt_planes_idx(*mv),
           wtt_matvec.wtt_wt_planes_idx_plain(*mv), elem, "B3")
    cost = (wcam, tw, d["pts"], d["uv"], mask, RobustLoss.CAUCHY)
    b4 = wtt_cost.wtt_cost_cols_idx(*cost)
    assert torch.isfinite(b4).all()
    _close(b4, wtt_cost.wtt_cost_cols_idx_plain(*cost), elem, "B4")
    onehot = (wcam[:, None, :] == torch.arange(w, device=dev)[None, :, None]).to(torch.int8)
    b6 = (d["xw_t"], onehot, jc, jp, v_inv)
    _close(wtt_matvec.wtt_coupling_rows_fused(*b6),
           wtt_matvec.wtt_coupling_rows_fused_plain(*b6), reduced, "B6")

    r = torch.randn(2, g, tb, PC, dtype=dtype, device=dev)
    jc, jp = jc.clone(), jp.clone()
    for x in (jc, jp, r):
        x[:, pad] = float("nan")
    for use_sj, od in ((False, False), (True, False), (True, True)):
        b8 = (wcam, jc, jp, r, v_inv, np_cam, w, use_sj, od)
        rows = wtt_linearize.wtt_contrib_rows_idx(*b8)
        assert torch.isfinite(rows).all()
        _close(rows, wtt_linearize.wtt_contrib_rows_idx_plain(*b8), reduced,
               f"B8 sj={use_sj} od={od}")
    b5 = (_sym3(v_inv, g_pt), wcam, jc, jp, w)
    rows_b5 = wtt_matvec.wtt_w_rows_idx(*b5)
    assert torch.isfinite(rows_b5).all()
    _close(rows_b5, wtt_matvec.wtt_w_rows_idx_plain(*b5), reduced, "B5")
    assert [c.modes.get(GLOBAL, 0) - b for c, b in zip(counts, before)] == [
        1, 1, 1, 1, 1, 1, 1, 2, 1]


def _sym3(v_inv, x):
    from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec

    return _sym3_matvec(v_inv, x).contiguous()


@pytest.mark.parametrize("dtype,c,tb,pb,np_cam,loss", [TT_CASES[0], TT_CASES[3]])
def test_tt_global_mode_matches_plain(dev, dtype, c, tb, pb, np_cam, loss):
    """B12-B14 and B16 in their one mode and B15 forced into its
    global-memory mode; camera 0's row is NaN and only padded slots carry
    camera 0."""
    d = _tt_inputs(dev, dtype, c, tb, pb, seed=2 * c + tb + pb)
    elem, reduced = TOL[dtype]
    cfg = BAConfig(loss=RobustLoss(loss), optimize_dist=np_cam >= 10,
                   optimize_pp=np_cam == 12)
    counts = (tt_linearize.CAM_COUNTS, tt_linearize.COUPLING_COUNTS,
              tt_linearize.WT_COUNTS, tt_linearize.W_COUNTS, tt_linearize.COST_COUNTS)
    before = [c_.modes.get(GLOBAL, 0) for c_ in counts]
    b12 = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"], cfg, np_cam)
    got = tt_linearize.tt_cam_normal_fused(*b12)
    want = tt_linearize.tt_cam_normal_fused_plain(*b12)
    for name, a, b in zip(("jc", "jp", "v6", "g_pt", "ug"), got, want):
        assert torch.isfinite(a).all(), name
        _close(a, b, reduced if name == "ug" else elem, name)
    slots = (d["cam_ids"], d["mask"], want[0], want[1])
    x = d["x"][:, :np_cam].contiguous()
    _close(tt_linearize.tt_coupling_fused(*slots, d["v_inv"], c),
           tt_linearize.tt_coupling_fused_plain(*slots, d["v_inv"], c), reduced, "B13")
    _close(tt_linearize.tt_wt_times_fused(x, *slots),
           tt_linearize.tt_wt_times_fused_plain(x, *slots), elem, "B14")
    _close(tt_linearize.tt_w_times_fused(d["y"], *slots, c, _mode=GLOBAL),
           tt_linearize.tt_w_times_fused_plain(d["y"], *slots, c), reduced, "B15")
    b16 = b12[:7]
    _close(tt_linearize.tt_cost_fused(*b16),
           tt_linearize.tt_cost_fused_plain(*b16), elem, "B16")
    assert [c_.modes.get(GLOBAL, 0) - b for c_, b in zip(counts, before)] == [1] * 5


def test_wide_inputs_take_the_global_mode(dev):
    """One input per kernel family whose shared tiles would exceed the
    card's limit, with no mode forced: B1 at W = 640 and B8 od at W = 640
    (f32, np = 8), B2 and B6 at W = 1280 (f64, np = 12), B4 at W = 1536
    (f64), B12, B13 and B15 at 7300 cameras (f32, np = 8).  Each runs in the
    global mode (B15 picked by its wrapper) and matches its plain
    version."""
    elem, reduced = TOL[torch.float32]
    d = _inputs(dev, torch.float32, 1, 640, 2, 8, seed=11)
    args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
            BAConfig(), 8, True)
    g0 = wtt_linearize.COUNTS.modes.get(GLOBAL, 0)
    got = wtt_linearize.wtt_linearize_fused_idx(*args)
    want = wtt_linearize.wtt_linearize_fused_idx_plain(*args)
    for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
        _close(a, b, reduced if name == "rows" else elem, f"B1 W=640 {name}")
    assert wtt_linearize.COUNTS.modes[GLOBAL] == g0 + 1
    _, jc, jp, v_inv, _, _ = want
    r = torch.randn(2, 1, 2, PC, device=dev)
    b8 = (d["wcam"], jc, jp, r, v_inv, 8, 640, True, True)
    g0 = wtt_linearize.CONTRIB_OD_COUNTS.modes.get(GLOBAL, 0)
    _close(wtt_linearize.wtt_contrib_rows_idx(*b8),
           wtt_linearize.wtt_contrib_rows_idx_plain(*b8), reduced, "B8 od W=640")
    assert wtt_linearize.CONTRIB_OD_COUNTS.modes[GLOBAL] == g0 + 1

    elem, reduced = TOL[torch.float64]
    cfg = BAConfig(optimize_dist=True, optimize_pp=True)
    d = _inputs(dev, torch.float64, 1, 1280, 2, 12, seed=12)
    want = wtt_linearize.wtt_linearize_fused_idx_plain(
        d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"], cfg, 12,
        True)
    _, jc, jp, v_inv, _, _ = want
    mv = (d["xw_t"], d["wcam"], jc, jp, v_inv)
    onehot = (d["wcam"][:, None, :]
              == torch.arange(1280, device=dev)[None, :, None]).to(torch.int8)
    before = (wtt_matvec.COUPLING_COUNTS.modes.get(GLOBAL, 0),
              wtt_matvec.FUSED_COUNTS.modes.get(GLOBAL, 0))
    _close(wtt_matvec.wtt_coupling_rows_idx(*mv),
           wtt_matvec.wtt_coupling_rows_idx_plain(*mv), reduced, "B2 W=1280")
    b6 = (d["xw_t"], onehot, jc, jp, v_inv)
    _close(wtt_matvec.wtt_coupling_rows_fused(*b6),
           wtt_matvec.wtt_coupling_rows_fused_plain(*b6), reduced, "B6 W=1280")
    assert (wtt_matvec.COUPLING_COUNTS.modes[GLOBAL],
            wtt_matvec.FUSED_COUNTS.modes[GLOBAL]) == (before[0] + 1, before[1] + 1)
    d = _inputs(dev, torch.float64, 1, 1536, 3, 8, seed=13)
    cost = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.HUBER)
    g0 = wtt_cost.COUNTS.modes.get(GLOBAL, 0)
    _close(wtt_cost.wtt_cost_cols_idx(*cost), wtt_cost.wtt_cost_cols_idx_plain(*cost),
           elem, "B4 W=1536")
    assert wtt_cost.COUNTS.modes[GLOBAL] == g0 + 1

    elem, reduced = TOL[torch.float32]
    c = 7300
    d = _tt_inputs(dev, torch.float32, c, 3, 1000, seed=14)
    b12 = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"], BAConfig(), 8)
    counts = (tt_linearize.CAM_COUNTS, tt_linearize.COUPLING_COUNTS, tt_linearize.W_COUNTS)
    before = [c_.modes.get(GLOBAL, 0) for c_ in counts]
    got = tt_linearize.tt_cam_normal_fused(*b12)
    want = tt_linearize.tt_cam_normal_fused_plain(*b12)
    for name, a, b in zip(("jc", "jp", "v6", "g_pt", "ug"), got, want):
        _close(a, b, reduced if name == "ug" else elem, f"B12 C={c} {name}")
    b13 = (d["cam_ids"], d["mask"], want[0], want[1], d["v_inv"], c)
    _close(tt_linearize.tt_coupling_fused(*b13), tt_linearize.tt_coupling_fused_plain(*b13),
           reduced, f"B13 C={c}")
    b15 = (d["y"], d["cam_ids"], d["mask"], want[0], want[1], c)
    _close(tt_linearize.tt_w_times_fused(*b15), tt_linearize.tt_w_times_fused_plain(*b15),
           reduced, f"B15 C={c}")
    assert [c_.modes.get(GLOBAL, 0) - b for c_, b in zip(counts, before)] == [1, 1, 1]


TERMS_CASES = [  # (G, W, Tb, np)
    (1, 128, 3, 8),
    (2, 256, 4, 10),
]


@pytest.mark.parametrize("g,w,tb,np_cam", TERMS_CASES)
def test_reduced_terms_match_plain(dev, g, w, tb, np_cam):
    """B2 at terms 1 and 2 and B1 at terms 2 (with and without the od rows),
    float32, against their plain versions at the same terms: window row 0
    of x and of the camera rows is NaN and only padded slots point at it.
    The plain versions round the same values (``split_round``), so only the
    order of the atomic row sums differs."""
    d = _inputs(dev, torch.float32, g, w, tb, np_cam, seed=5 * g + w + tb)
    elem, reduced = TOL[torch.float32]
    wcam = _track_wcam(dev, g, w, tb, seed=w + 2 * tb)
    pad = (wcam < 0).reshape(g, tb, PC)
    tw, xw_t = d["tw"].clone(), d["xw_t"].clone()
    tw[:, 0] = float("nan")
    xw_t[:, :, 0] = float("nan")
    cfg = BAConfig(optimize_dist=np_cam >= 10)
    counts = (wtt_linearize.TERMS2_COUNTS, wtt_linearize.TERMS2_OD_COUNTS,
              wtt_matvec.COUPLING1_COUNTS, wtt_matvec.COUPLING2_COUNTS)
    before = [c.kernel for c in counts]
    for od in (False, True):
        args = (wcam, tw, d["pts"], d["uv"], (~pad).float(), d["lam"], d["inv_w"], cfg,
                np_cam, True, od)
        got = wtt_linearize.wtt_linearize_fused_idx(*args, terms=2)
        want = wtt_linearize.wtt_linearize_fused_idx_plain(*args, terms=2)
        for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
            assert torch.isfinite(a).all(), name
            _close(a, b, reduced if name == "rows" else elem, f"B1 terms=2 od={od} {name}")
        exact = wtt_linearize.wtt_linearize_fused_idx(*args)[0]
        n_sj = wtt_linearize.n_contrib_cols(np_cam, True)
        _close(got[0][..., n_sj:n_sj + np_cam], exact[..., n_sj:n_sj + np_cam], reduced,
               "B1 terms=2 rhs vs exact")
    _, jc, jp, v_inv, _, _ = want
    for terms in (1, 2):
        mv = (xw_t, wcam, jc, jp, v_inv)
        got = wtt_matvec.wtt_coupling_rows_idx(*mv, terms=terms)
        assert torch.isfinite(got).all()
        _close(got, wtt_matvec.wtt_coupling_rows_idx_plain(*mv, terms=terms), reduced,
               f"B2 terms={terms}")
    assert [c.kernel - b for c, b in zip(counts, before)] == [1, 1, 1, 1]


def _slot_wcam(dev, kind, g, w, tb, seed, pc=PC):
    """(G, Tb * pc) int16 window rows for the slot-major B1 and B2, window
    row 0 never used: "tracks" (``_track_wcam``: lanes of a warp on
    different rows), "grouped" (every 32-point group walks one track, each
    point cut at its own length: row-uniform warps with padded tails),
    "random" (``_inputs``' random rows) or "one" (all padding but the last
    slot of point 37)."""
    rng = np.random.default_rng(seed)
    if kind == "tracks":
        return _track_wcam(dev, g, w, tb, seed, pc)
    if kind == "grouped":
        n_groups = -(-pc // 32)
        steps = np.where(rng.random((g, tb, n_groups)) < 0.75, 1, 2)
        steps[:, 0] = rng.integers(1, w - 2 * tb, size=(g, n_groups))
        rows = np.repeat(np.cumsum(steps, axis=1), 32, axis=2)[:, :, :pc]
        length = rng.integers(1, tb + 1, size=(g, 1, pc))
        wcam = np.where(np.arange(tb)[None, :, None] < length, rows, -1)
    elif kind == "random":
        wcam = rng.integers(1, w, size=(g, tb, pc))
        wcam[rng.random(wcam.shape) < 0.15] = -1
    else:
        wcam = np.full((g, tb, pc), -1)
        wcam[0, tb - 1, 37] = w // 2
    return torch.as_tensor(wcam.reshape(g, tb * pc).astype(np.int16), device=dev)


SLOT_CASES = [  # (dtype, G, W, Tb, np, want_od, rows)
    (torch.float32, 1, 128, 1, 8, False, "tracks"),
    (torch.float64, 2, 128, 3, 10, True, "tracks"),
    (torch.float32, 1, 256, 12, 12, True, "grouped"),
    (torch.float32, 1, 128, 40, 8, True, "grouped"),
    (torch.float64, 1, 128, 40, 12, True, "tracks"),
    (torch.float32, 2, 1664, 12, 8, False, "random"),
    (torch.float64, 2, 256, 4, 8, True, "one"),
]


@pytest.mark.parametrize("dtype,g,w,tb,np_cam,want_od,rows", SLOT_CASES)
def test_slot_major_kernels_match_plain(dev, dtype, g, w, tb, np_cam, want_od, rows):
    """The slot-major B1 (with ``want_od`` as given), B2 and B8 (with and
    without the Schur-Jacobi columns, and with ``want_od`` as given) against
    their plain versions: one-chunk tracks (Tb 1, 3, 12), tracks longer than
    one block's chunk (Tb 40: od pairs across a chunk's edge), the hub
    layout's W = 1664 with random rows (warps that are not row-uniform),
    row-uniform warps, a bucket that is all padding but one slot; in float32
    also B1 at terms 2 and B2 at terms 1 and 2.  Window row 0 of the camera
    rows and of x is NaN and only padded slots point at it; B8 also gets NaN
    jc/jp/r on the padded slots, which it must not read."""
    d = _inputs(dev, dtype, g, w, tb, np_cam, seed=7 * g + w + tb + np_cam)
    wcam = _slot_wcam(dev, rows, g, w, tb, seed=w + 3 * tb)
    pad = (wcam < 0).reshape(g, tb, PC)
    tw, xw_t = d["tw"].clone(), d["xw_t"].clone()
    tw[:, 0] = float("nan")
    xw_t[:, :, 0] = float("nan")
    elem, reduced = TOL[dtype]
    cfg = BAConfig(optimize_dist=np_cam >= 10, optimize_pp=np_cam == 12)
    args = (wcam, tw, d["pts"], d["uv"], (~pad).to(dtype), d["lam"], d["inv_w"], cfg,
            np_cam, True, want_od)
    f32 = dtype == torch.float32
    before = (wtt_linearize.OD_COUNTS if want_od else wtt_linearize.COUNTS).kernel
    for terms in (3, 2) if f32 else (3,):
        got = wtt_linearize.wtt_linearize_fused_idx(*args, terms=terms)
        want = wtt_linearize.wtt_linearize_fused_idx_plain(*args, terms=terms)
        for name, a, b in zip(("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt"), got, want):
            assert torch.isfinite(a).all(), name
            _close(a, b, reduced if name == "rows" else elem, f"B1 terms={terms} {name}")
        assert (got[1][:, pad] == 0).all() and (got[2][:, pad] == 0).all()
    assert (wtt_linearize.OD_COUNTS if want_od else wtt_linearize.COUNTS).kernel == before + 1
    _, jc, jp, v_inv, _, _ = want
    mv = (xw_t, wcam, jc, jp, v_inv)
    for terms in (3, 2, 1) if f32 else (3,):
        got = wtt_matvec.wtt_coupling_rows_idx(*mv, terms=terms)
        assert torch.isfinite(got).all()
        _close(got, wtt_matvec.wtt_coupling_rows_idx_plain(*mv, terms=terms), reduced,
               f"B2 terms={terms}")
    r = torch.as_tensor(np.random.default_rng(w + tb).normal(size=(2, g, tb, PC)),
                        dtype=dtype, device=dev)
    jc, jp = jc.clone(), jp.clone()
    for x in (jc, jp, r):
        x[:, pad] = float("nan")
    counts = (wtt_linearize.CONTRIB_COUNTS, wtt_linearize.CONTRIB_OD_COUNTS)
    before = [c.kernel for c in counts]
    variants = ((False, False), (True, False)) + (((True, True),) if want_od else ())
    for use_sj, od in variants:
        b8 = (wcam, jc, jp, r, v_inv, np_cam, w, use_sj, od)
        rows8 = wtt_linearize.wtt_contrib_rows_idx(*b8)
        assert torch.isfinite(rows8).all(), f"B8 sj={use_sj} od={od} read a padded slot"
        _close(rows8, wtt_linearize.wtt_contrib_rows_idx_plain(*b8), reduced,
               f"B8 sj={use_sj} od={od}")
    assert [c.kernel - b for c, b in zip(counts, before)] == [2, int(want_od)]


def test_probe_kernels_match(dev):
    """E4: both layouts equal E4's numpy formulas; E1: every variant of B2's
    copy matches its plain version (the block variants are B2's rows)."""
    from tpu3drecon_torch.experiments import bits_expand, index_matvec2

    host = bits_expand.packed_input()
    packed = torch.as_tensor(host, device=dev)
    for layout in bits_expand.LAYOUTS:
        got = bits_expand.bits_expand(packed, layout).cpu().numpy()
        assert np.array_equal(got, bits_expand.numpy_expand(host, layout)), layout

    d = _inputs(dev, torch.float32, 2, 256, 3, 8, seed=21)
    _, reduced = TOL[torch.float32]
    _, jc, jp, v_inv, _, _ = wtt_linearize.wtt_linearize_fused_idx_plain(
        d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"], BAConfig(),
        8, True)
    mv = (d["xw_t"], d["wcam"], jc, jp, v_inv)
    for variant in index_matvec2.VARIANTS:
        _close(index_matvec2.probe_coupling_rows(*mv, variant),
               index_matvec2.probe_coupling_rows_plain(*mv, variant), reduced, variant)
    _close(index_matvec2.probe_coupling_rows(*mv, "block512"),
           wtt_matvec.wtt_coupling_rows_idx_plain(*mv), reduced, "block512 vs B2")


ONEHOT_CASES = [  # (dtype, G, W, Tb, np, Pc, rows)
    (torch.float32, 1, 128, 3, 8, 300, "random"),  # int8 4-byte loads, f32 16
    (torch.float32, 2, 128, 2, 8, 512, "grouped"),  # 16-byte loads
    (torch.float64, 1, 128, 40, 10, 512, "tracks"),  # three chunks per track
    (torch.float64, 1, 1280, 2, 12, 300, "random"),  # past the old shared tile
    (torch.float32, 1, 256, 12, 8, 301, "random"),  # int8 1-byte, f32 4-byte loads
    (torch.float64, 1, 128, 4, 12, 520, "one"),  # int8 8-byte loads
]


@pytest.mark.parametrize("dtype,g,w,tb,np_cam,pc,rows", ONEHOT_CASES)
def test_onehot_coupling_matches_plain_and_b2(dev, dtype, g, w, tb, np_cam, pc, rows):
    """B6 (B2's slot-major kernel with each slot's row decoded from the
    one-hot in vector loads) with the int8 and the float one-hot: against
    its plain version (the literal one-hot product), against B2 on the same
    ``wcam`` with window row 0 of x NaN (only padded slots, all-zero
    columns, could reach it), and on a malformed column (a second 1 below
    the slot's row), where it reads the first 1 and the plain version sums
    both.  B6's plain version sums W^T x in another order than the kernel
    (B2's plain version keeps the kernel's), and V^-1 of a point seen once
    (conditioned ~1/lam) carries that order's rounding past the float32
    bound; so the float32 cases draw random rows and one grouped bucket,
    and the tracks of one slot ("tracks", "one") run in float64."""
    d = _inputs(dev, dtype, g, w, tb, np_cam, seed=11 * g + w + tb + pc, pc=pc)
    wcam = _slot_wcam(dev, rows, g, w, tb, seed=w + 5 * tb, pc=pc)
    pad = (wcam < 0).reshape(g, tb, pc)
    tw = d["tw"].clone()
    tw[:, 0] = float("nan")
    _, reduced = TOL[dtype]
    cfg = BAConfig(optimize_dist=np_cam >= 10, optimize_pp=np_cam == 12)
    _, jc, jp, v_inv, _, _ = wtt_linearize.wtt_linearize_fused_idx_plain(
        wcam, tw, d["pts"], d["uv"], (~pad).to(dtype), d["lam"], d["inv_w"], cfg, np_cam,
        True)
    onehot = (wcam[:, None, :] == torch.arange(w, device=dev)[None, :, None]).to(torch.int8)
    xw_nan = d["xw_t"].clone()
    xw_nan[:, :, 0] = float("nan")
    col = int(torch.nonzero((wcam[0] >= 0) & (wcam[0] < w - 1))[0])
    before = wtt_matvec.FUSED_COUNTS.kernel
    for oh in (onehot, onehot.to(dtype)):
        b6 = (d["xw_t"], oh, jc, jp, v_inv)
        _close(wtt_matvec.wtt_coupling_rows_fused(*b6),
               wtt_matvec.wtt_coupling_rows_fused_plain(*b6), reduced, f"B6 {oh.dtype}")
        got = wtt_matvec.wtt_coupling_rows_fused(xw_nan, oh, jc, jp, v_inv)
        assert torch.isfinite(got).all(), f"B6 {oh.dtype} read a padded slot's x"
        b2 = (xw_nan, wcam, jc, jp, v_inv)
        _close(got, wtt_matvec.wtt_coupling_rows_idx_plain(*b2), reduced,
               f"B6 {oh.dtype} vs B2 plain")
        _close(got, wtt_matvec.wtt_coupling_rows_idx(*b2), reduced, f"B6 {oh.dtype} vs B2")
        bad = oh.clone()
        bad[0, int(wcam[0, col]) + 1, col] = 1
        got = wtt_matvec.wtt_coupling_rows_fused(d["xw_t"], bad, jc, jp, v_inv)
        _close(got, wtt_matvec.wtt_coupling_rows_fused_plain(*b6), reduced,
               f"B6 {oh.dtype} malformed column")
        assert not torch.allclose(
            got, wtt_matvec.wtt_coupling_rows_fused_plain(d["xw_t"], bad, jc, jp, v_inv))
    assert wtt_matvec.FUSED_COUNTS.kernel == before + 6


def _three_camera_ids(c, tb, pb, seed):
    """(Tb, Pb) camera ids where every 32-lane group of a slot carries three
    cameras and padding (camera 0, mask 0) at every fifth lane: warps whose
    lanes go to three rows at once."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, c - 3, size=(tb, -(-pb // 32)))
    lane = np.arange(pb) % 32
    cam_ids = np.repeat(base, 32, axis=1)[:, :pb] + lane % 3
    mask = lane % 5 != 0
    return np.where(mask, cam_ids, 0).astype(np.int32), np.broadcast_to(mask, (tb, pb)).copy()


TT_W_CASES = [  # (dtype, C, Tb, Pb, np, cameras)
    (torch.float32, 100, 40, 300, 8, "random"),  # three chunks per track
    (torch.float64, 1024, 3, 1000, 12, "random"),
    (torch.float32, 7300, 3, 1000, 8, "random"),  # past the old shared tile
    (torch.float32, 100, 4, 300, 10, "three"),
    (torch.float64, 37, 12, 513, 8, "three"),
]


@pytest.mark.parametrize("dtype,c,tb,pb,np_cam,cams", TT_W_CASES)
def test_tt_w_times_slot_major_matches_plain(dev, dtype, c, tb, pb, np_cam, cams):
    """B15 (one warp per slot and 32-point group, lanes grouped by camera
    before their atomics) against its plain version: tracks of several
    chunks, camera axes of 1024 and 7300, and warps whose lanes carry
    three cameras and padding.  Camera 0's row is NaN and only padded slots
    carry camera 0, so B12's plain planes of a padded slot are zero and a
    kernel that added one would still add zeros; the padded slots' jc/jp
    are then set to NaN, which B15 must not read."""
    d = _tt_inputs(dev, dtype, c, tb, pb, seed=c + 3 * tb + pb)
    if cams == "three":
        cam_ids, mask = _three_camera_ids(c, tb, pb, seed=c + tb)
        d["cam_ids"] = torch.as_tensor(cam_ids, device=dev)
        d["mask"] = torch.as_tensor(mask, dtype=dtype, device=dev)
    _, reduced = TOL[dtype]
    cfg = BAConfig(optimize_dist=np_cam >= 10, optimize_pp=np_cam == 12)
    b12 = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"], cfg, np_cam)
    jc, jp = (x.clone() for x in tt_linearize.tt_cam_normal_fused_plain(*b12)[:2])
    b15 = (d["y"], d["cam_ids"], d["mask"], jc, jp, c)
    want = tt_linearize.tt_w_times_fused_plain(*b15)
    pad = d["mask"] == 0
    jc[:, pad] = float("nan")
    jp[:, pad] = float("nan")
    before = tt_linearize.W_COUNTS.kernel
    got = tt_linearize.tt_w_times_fused(*b15)
    assert torch.isfinite(got).all()
    _close(got, want, reduced, f"B15 C={c} Tb={tb} {cams}")
    assert tt_linearize.W_COUNTS.kernel == before + 1


TT_SLOT_CASES = [  # (dtype, C, Tb, Pb, np, loss, cameras)
    (torch.float32, 100, 1, 300, 8, "trivial", "random"),
    (torch.float32, 100, 3, 513, 10, "cauchy", "three"),
    (torch.float64, 37, 12, 300, 12, "huber", "three"),
    (torch.float32, 100, 40, 300, 8, "huber", "random"),  # three chunks per track
    (torch.float64, 100, 40, 300, 10, "cauchy", "random"),  # B12: five chunks
    (torch.float64, 100, 4, 300, 8, "trivial", "one"),
    (torch.float32, 1024, 3, 1000, 12, "cauchy", "random"),
    (torch.float32, 7300, 3, 1000, 8, "huber", "random"),
]


@pytest.mark.parametrize("dtype,c,tb,pb,np_cam,loss,cams", TT_SLOT_CASES)
def test_tt_slot_major_b12_b14_match_plain(dev, dtype, c, tb, pb, np_cam, loss, cams):
    """The slot-major B12, B13 and B14 (one lane per track slot, per-point
    sums added in slot order by one lane per point, B12's and B13's camera
    columns through the warp's row tile) against their plain versions: tracks of 1, 3, 12
    and 40 slots (several chunks), a bucket that is all padding but one
    slot, camera axes of 1024 and 7300, np 10 and 12, float64, warps whose
    lanes carry three cameras and padding, and each loss.  jc, jp, v6, g_pt
    and B14's W^T x must equal the plain versions bit for bit (both sum
    each point's track in slot order); ug and B13's columns are atomic
    sums.  Camera 0's row and x row are NaN and only padded slots carry
    camera 0; B13 and B14 also get NaN jc/jp on the padded slots, which
    they must not read."""
    d = _tt_inputs(dev, dtype, c, tb, pb, seed=c + 5 * tb + pb + np_cam)
    if cams == "three":
        cam_ids, mask = _three_camera_ids(c, tb, pb, seed=c + tb)
    elif cams == "one":
        mask = np.zeros((tb, pb), dtype=bool)
        mask[tb - 1, 37] = True
        cam_ids = np.where(mask, c // 2, 0).astype(np.int32)
    if cams != "random":
        d["cam_ids"] = torch.as_tensor(cam_ids, device=dev)
        d["mask"] = torch.as_tensor(mask, dtype=dtype, device=dev)
    _, reduced = TOL[dtype]
    cfg = BAConfig(loss=RobustLoss(loss), optimize_dist=np_cam >= 10,
                   optimize_pp=np_cam == 12)
    counts = (tt_linearize.CAM_COUNTS, tt_linearize.COUPLING_COUNTS, tt_linearize.WT_COUNTS)
    before = [c_.kernel for c_ in counts]
    b12 = (d["table"], d["cam_ids"], d["pts"], d["uv"], d["mask"], d["inv_w"], cfg, np_cam)
    got = tt_linearize.tt_cam_normal_fused(*b12)
    want = tt_linearize.tt_cam_normal_fused_plain(*b12)
    torch.cuda.synchronize()
    for name, a, b in zip(("jc", "jp", "v6", "g_pt"), got, want):
        assert torch.isfinite(a).all(), f"B12 {name}"
        assert torch.equal(a, b), f"B12 {name}: max|diff| {float((a - b).abs().max()):.3e}"
    assert torch.isfinite(got[4]).all()
    _close(got[4], want[4], reduced, f"B12 ug C={c} Tb={tb} {cams}")
    pad = d["mask"] == 0
    assert (got[0][:, pad] == 0).all() and (got[1][:, pad] == 0).all()
    assert (got[4][0] == 0).all()  # camera 0 has only padded slots

    x = d["x"][:, :np_cam].clone()
    x[0] = float("nan")
    jc, jp = (t.clone() for t in want[:2])
    b13 = (d["cam_ids"], d["mask"], jc, jp, d["v_inv"], c)
    b14 = (x, d["cam_ids"], d["mask"], jc, jp)
    ref13 = tt_linearize.tt_coupling_fused_plain(*b13)
    ref = tt_linearize.tt_wt_times_fused_plain(*b14)
    jc[:, pad] = float("nan")
    jp[:, pad] = float("nan")
    coup = tt_linearize.tt_coupling_fused(*b13)
    assert torch.isfinite(coup).all(), "B13 read a padded slot"
    _close(coup, ref13, reduced, f"B13 C={c} Tb={tb} {cams}")
    out = tt_linearize.tt_wt_times_fused(*b14)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all(), "B14 read a padded slot"
    assert torch.equal(out, ref), f"B14: max|diff| {float((out - ref).abs().max()):.3e}"
    assert [c_.kernel - b for c_, b in zip(counts, before)] == [1, 1, 1]
