"""The grid engine's three kernels: plain PyTorch versions vs the JAX Pallas
kernels.

Inputs come from the fixture of tests/test_pallas_kernels.py (4 cameras,
150 points, seed 61; pinhole and radial), packed by the JAX package's
``grid_from_flat`` at f64, and cross as numpy arrays.  The JAX kernels run
in interpret mode; the port's public functions get CPU tensors and so run
their plain versions.  Tolerance: rtol 1e-10 with atol 1e-12 * max|ref|
(the per-camera and per-point sums are taken in other orders, and a point
seen once has V^-1 conditioned ~1/lam).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import assert_close

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon.geometry.losses import RobustLoss as JLoss
from tpu3drecon.ops.pallas.cam_normal import cam_normal_fused as j_cam
from tpu3drecon.ops.pallas.cam_normal import pack_camera_params as j_pack
from tpu3drecon.ops.pallas.coupling import coupling_fused as j_coupling
from tpu3drecon.ops.pallas.point_normal import point_normal_fused as j_point
from tpu3drecon.problems.grid import grid_from_flat

from tpu3drecon_torch.geometry.losses import RobustLoss as TLoss
from tpu3drecon_torch.ops import cam_normal, coupling, point_normal

RTOL, ATOL_REL = 1e-10, 1e-12
LAM = 1e-4
CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


@pytest.fixture(scope="module", params=[(0.0, 0.0), (-0.08, 0.012)],
                ids=["pinhole", "radial"])
def planes(request):
    """numpy kernel inputs of B9: camera arrays, x_w (C,3,K), uv (C,2,K),
    mask (C,K), inv_w, plus pt_idx and the track table."""
    scene = make_scene(n_cameras=4, n_points=150, seed=61, dist=request.param)
    noisy = perturb_scene(scene, seed=62, point2d_noise=0.5)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    grid = grid_from_flat(flat)
    pts = np.asarray(grid.points3d)
    pt_idx = np.asarray(grid.pt_idx)
    return dict(
        cams={k: np.asarray(getattr(grid.cameras, k)) for k in CAM_FIELDS},
        x_w=np.ascontiguousarray(pts[pt_idx].transpose(0, 2, 1)),
        points=pts,
        uv=np.ascontiguousarray(np.asarray(grid.uv).transpose(0, 2, 1)),
        mask=np.asarray(grid.mask),
        inv_w=1.0 / float(grid.avg_cam_width),
        pt_idx=pt_idx,
        track_idx=np.asarray(grid.track_idx),
        track_mask=np.asarray(grid.track_mask),
    )


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_cam(d, loss, mask=None):
    c = d["cams"]
    return j_cam(
        jnp.asarray(c["rmats"]), jnp.asarray(c["tvecs"]), jnp.asarray(c["fx_fy"]),
        jnp.asarray(c["cx_cy_skew"]), jnp.asarray(c["dist"]), jnp.asarray(d["x_w"]),
        jnp.asarray(d["uv"]), jnp.asarray(d["mask"] if mask is None else mask),
        jnp.asarray(d["inv_w"]), loss=JLoss(loss), interpret=True,
    )


def _port_cam(d, loss, mask=None):
    c = d["cams"]
    return cam_normal.cam_normal_fused(
        *(_t(c[k]) for k in CAM_FIELDS), _t(d["x_w"]), _t(d["uv"]),
        _t(d["mask"] if mask is None else mask),
        torch.tensor(d["inv_w"], dtype=torch.float64), loss=TLoss(loss),
    )


def test_pack_camera_params_matches(planes):
    c = planes["cams"]
    want = j_pack(*(jnp.asarray(c[k]) for k in ("rmats", "tvecs", "fx_fy", "cx_cy_skew")),
                  jnp.asarray(planes["inv_w"]), jnp.asarray(c["dist"]))
    got = cam_normal.pack_camera_params(
        *(_t(c[k]) for k in ("rmats", "tvecs", "fx_fy", "cx_cy_skew")),
        torch.tensor(planes["inv_w"], dtype=torch.float64), _t(c["dist"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("loss", ["trivial", "cauchy", "huber"])
def test_cam_normal_matches_pallas(planes, loss):
    want = _jax_cam(planes, loss)
    got = _port_cam(planes, loss)
    for name, a, b in zip(("r", "jp", "jc", "u", "g"), got, want):
        assert a.shape == b.shape, name
        assert_close(a, b, RTOL, ATOL_REL, err_msg=name)
    # Masked lanes (grid padding) give exact zeros in every plane.
    pad = planes["mask"] == 0
    assert pad.any()
    for plane in got[:3]:
        assert (plane.numpy().transpose(0, 2, 1)[pad] == 0).all()


def test_cam_normal_masked_lanes_exact_zero(planes):
    """With the whole mask zeroed every output is exactly 0, as the JAX
    kernel gives (tests/test_pallas_kernels.py)."""
    zero = np.zeros_like(planes["mask"])
    want = _jax_cam(planes, "huber", zero)
    got = _port_cam(planes, "huber", zero)
    for a, b in zip(got, want):
        assert float(np.abs(np.asarray(b)).max()) == 0.0
        assert float(a.abs().max()) == 0.0


def _track_rows(planes, loss="trivial"):
    """(jp_g (P, 2T, 3), r_g (P, 2T)) from the JAX B9 planes through the
    track table, plus one point seen once and all-zero padded rows."""
    r, jp, jc, _, _ = (np.asarray(x) for x in _jax_cam(planes, loss))
    c, _, k = jp.shape
    jpr = np.concatenate([jp, r], axis=1).transpose(0, 2, 1).reshape(c * k, 8)
    p, t = planes["track_idx"].shape
    g = jpr[planes["track_idx"]] * planes["track_mask"][..., None]
    jp_g, r_g = g[..., :6].reshape(p, 2 * t, 3), g[..., 6:].reshape(p, 2 * t)
    once = np.zeros((1, 2 * t, 3))
    once[0, :2] = jp_g[0, :2]  # the first observation of point 0 alone
    once_r = np.zeros((1, 2 * t))
    once_r[0, :2] = r_g[0, :2]
    pad = (-(p + 1)) % 8 or 8  # at least one all-zero padded row
    jp_g = np.concatenate([jp_g, once, np.zeros((pad, 2 * t, 3))])
    r_g = np.concatenate([r_g, once_r, np.zeros((pad, 2 * t))])
    return np.ascontiguousarray(jp_g), np.ascontiguousarray(r_g), (r, jp, jc)


def test_point_normal_matches_pallas(planes):
    jp_g, r_g, _ = _track_rows(planes)
    n = jp_g.shape[0]
    want = j_point(jnp.asarray(jp_g), jnp.asarray(r_g), jnp.asarray(LAM),
                   block_points=n, interpret=True)
    got = point_normal.point_normal_fused(_t(jp_g), _t(r_g),
                                          torch.tensor(LAM, dtype=torch.float64))
    for name, a, b in zip(("v_inv", "g_pt", "damp_pt"), got, want):
        assert a.shape == b.shape, name
        assert_close(a, b, RTOL, ATOL_REL, err_msg=name)
    # The point seen once (row P) is ill-conditioned, ~1/lam, and matches.
    once = planes["track_idx"].shape[0]
    assert np.linalg.cond(got[0].numpy()[once]) > 0.1 / LAM
    assert (got[1].numpy()[once + 1:] == 0).all()  # padded rows


def test_coupling_matches_pallas(planes):
    jp_g, r_g, (_, jp, jc) = _track_rows(planes)
    p = planes["track_idx"].shape[0]
    v_inv, _, _ = j_point(jnp.asarray(jp_g), jnp.asarray(r_g), jnp.asarray(LAM),
                          block_points=jp_g.shape[0], interpret=True)
    v = np.asarray(v_inv)[:p]
    vinv6 = np.stack([v[:, 0, 0], v[:, 0, 1], v[:, 0, 2],
                      v[:, 1, 1], v[:, 1, 2], v[:, 2, 2]], axis=1)
    vinv6_g = np.ascontiguousarray(vinv6[planes["pt_idx"]].transpose(0, 2, 1))
    want = j_coupling(jnp.asarray(jc), jnp.asarray(jp), jnp.asarray(vinv6_g),
                      interpret=True)
    got = coupling.coupling_fused(_t(jc), _t(jp), _t(vinv6_g))
    assert got.shape == (jc.shape[0], 8, 8)
    assert_close(got, want, RTOL, ATOL_REL)
    np.testing.assert_array_equal(got.numpy(), got.numpy().transpose(0, 2, 1))


@pytest.mark.parametrize("loss", ["trivial", "cauchy", "huber"])
def test_cam_normal_idx_matches_pallas(planes, loss):
    """B9's indexed form (the grid solve's call: the points read through
    pt_idx) against JAX's ``cam_normal_fused`` on the planes gathered by
    numpy, and bit for bit against the port's plane form."""
    c = planes["cams"]
    got = cam_normal.cam_normal_idx(
        *(_t(c[k]) for k in CAM_FIELDS), _t(planes["points"]), _t(planes["pt_idx"]),
        _t(planes["uv"]), _t(planes["mask"]),
        torch.tensor(planes["inv_w"], dtype=torch.float64), loss=TLoss(loss))
    assert planes["pt_idx"].dtype == np.int32
    for name, a, b, p in zip(("r", "jp", "jc", "u", "g"), got, _jax_cam(planes, loss),
                             _port_cam(planes, loss)):
        assert a.shape == b.shape, name
        assert_close(a, b, RTOL, ATOL_REL, err_msg=name)
        assert torch.equal(a, p), name
    pad = planes["mask"] == 0
    for plane in got[:3]:
        assert (plane.numpy().transpose(0, 2, 1)[pad] == 0).all()


def test_coupling_idx_matches_pallas(planes):
    """B11's indexed form (V^-1 (P, 3, 3) read through pt_idx) against
    JAX's ``coupling_fused`` on the unique entries gathered by numpy."""
    jp_g, r_g, (_, jp, jc) = _track_rows(planes)
    p = planes["track_idx"].shape[0]
    v_inv, _, _ = j_point(jnp.asarray(jp_g), jnp.asarray(r_g), jnp.asarray(LAM),
                          block_points=jp_g.shape[0], interpret=True)
    v = np.ascontiguousarray(np.asarray(v_inv)[:p])
    vinv6 = np.stack([v[:, 0, 0], v[:, 0, 1], v[:, 0, 2],
                      v[:, 1, 1], v[:, 1, 2], v[:, 2, 2]], axis=1)
    vinv6_g = np.ascontiguousarray(vinv6[planes["pt_idx"]].transpose(0, 2, 1))
    want = j_coupling(jnp.asarray(jc), jnp.asarray(jp), jnp.asarray(vinv6_g),
                      interpret=True)
    got = coupling.coupling_idx(_t(jc), _t(jp), _t(v), _t(planes["pt_idx"]))
    assert got.shape == (jc.shape[0], 8, 8)
    assert_close(got, want, RTOL, ATOL_REL)
    assert torch.equal(got, coupling.coupling_fused(_t(jc), _t(jp), _t(vinv6_g)))


def test_cpu_idx_calls_run_the_plain_versions(planes):
    """On CPU tensors the indexed forms run their plain versions (one
    plain call each, no kernel)."""
    c = planes["cams"]
    before = [(cnt.kernel, cnt.plain) for cnt in (cam_normal.COUNTS, coupling.COUNTS)]
    _, jp, jc, _, _ = cam_normal.cam_normal_idx(
        *(_t(c[k]) for k in CAM_FIELDS), _t(planes["points"]), _t(planes["pt_idx"]),
        _t(planes["uv"]), _t(planes["mask"]), torch.tensor(planes["inv_w"]))
    v = torch.eye(3, dtype=torch.float64).expand(planes["points"].shape[0], 3, 3)
    coupling.coupling_idx(jc, jp, v.contiguous(), _t(planes["pt_idx"]))
    after = [(cnt.kernel, cnt.plain) for cnt in (cam_normal.COUNTS, coupling.COUNTS)]
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == [(0, 1), (0, 1)]


def test_cpu_idx_out_of_range_raises(planes):
    """A pt_idx entry past the points raises on the CPU, from the plain
    versions' gather (the kernels trap on it instead)."""
    c = planes["cams"]
    p = planes["points"].shape[0]
    bad = planes["pt_idx"].copy()
    bad[-1, -1] = p
    with pytest.raises(IndexError):
        cam_normal.cam_normal_idx(
            *(_t(c[k]) for k in CAM_FIELDS), _t(planes["points"]), _t(bad),
            _t(planes["uv"]), _t(planes["mask"]), torch.tensor(planes["inv_w"]))
    n_cams, k = bad.shape
    with pytest.raises(IndexError):
        coupling.coupling_idx(torch.zeros((n_cams, 16, k), dtype=torch.float64),
                              torch.zeros((n_cams, 6, k), dtype=torch.float64),
                              torch.zeros((p, 3, 3), dtype=torch.float64), _t(bad))


def test_cpu_tensors_run_the_plain_versions(planes):
    """A CPU call runs the plain version (its counter grows) and never the
    kernel; an unsupported device raises instead of falling back."""
    counters = (cam_normal.COUNTS, point_normal.COUNTS, coupling.COUNTS)
    before = [(c.kernel, c.plain) for c in counters]
    _port_cam(planes, "trivial")
    jp_g, r_g, (_, jp, jc) = _track_rows(planes)
    point_normal.point_normal_fused(_t(jp_g), _t(r_g), torch.tensor(LAM))
    coupling.coupling_fused(_t(jc), _t(jp), _t(jp))
    after = [(c.kernel, c.plain) for c in counters]
    assert [a[0] - b[0] for a, b in zip(after, before)] == [0, 0, 0]
    assert [a[1] - b[1] for a, b in zip(after, before)] == [1, 1, 1]
    meta = torch.empty((1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        coupling.coupling_fused(meta, meta, meta)


BUCKETS = [(37, 4), (1, 6), (64, 8), (9, 24), (5, 40)]  # (P, T2) of the grouped tests


def _buckets(seed):
    """numpy (jp_g, r_g) of ``BUCKETS``: each observation two rows (u and
    v), 30 % of the observations zero (padded track entries), and point 0
    of each bucket with every row zero."""
    rng = np.random.default_rng(seed)
    out = []
    for p, t2 in BUCKETS:
        jp, r = rng.normal(size=(p, t2, 3)), rng.normal(size=(p, t2))
        zero = np.repeat(rng.random((p, t2 // 2)) < 0.3, 2, axis=1)
        zero[0] = True
        jp[zero], r[zero] = 0.0, 0.0
        out.append((jp, r))
    return out


def test_point_normal_buckets_matches_plain_and_pallas():
    """B10's grouped call (f64, CPU: its plain version) equals each bucket's
    ``point_normal_fused_plain`` concatenated, bit for bit, and JAX's
    ``point_normal_fused`` per bucket (interpret mode, one block of the
    bucket's points) to rtol 1e-10 with atol 1e-12 * max|ref|."""
    buckets = _buckets(seed=71)
    lam = torch.tensor(LAM, dtype=torch.float64)
    got = point_normal.point_normal_buckets([_t(jp) for jp, _ in buckets],
                                            [_t(r) for _, r in buckets], lam)
    assert [tuple(x.shape) for x in got] == [(116, 3, 3), (116, 3), (116, 3)]
    row = 0
    for jp, r in buckets:
        p = jp.shape[0]
        plain = point_normal.point_normal_fused_plain(_t(jp), _t(r), lam)
        want = j_point(jnp.asarray(jp), jnp.asarray(r), jnp.asarray(LAM), block_points=p,
                       interpret=True)
        for name, a, b, c in zip(("v_inv", "g_pt", "damp_pt"), got, plain, want):
            assert torch.equal(a[row:row + p], b), name
            assert_close(a[row:row + p], c, RTOL, ATOL_REL, err_msg=name)
        assert (got[1][row] == 0).all()  # the point no row observes
        row += p


def test_point_normal_buckets_cpu_runs_the_plain_version():
    """On CPU tensors the grouped call runs the plain version once per bucket
    and never the kernel; an empty list or unmatched lists raise."""
    buckets = _buckets(seed=72)
    before = (point_normal.COUNTS.kernel, point_normal.COUNTS.plain)
    point_normal.point_normal_buckets([_t(jp) for jp, _ in buckets],
                                      [_t(r) for _, r in buckets], torch.tensor(LAM))
    assert (point_normal.COUNTS.kernel, point_normal.COUNTS.plain) == (
        before[0], before[1] + len(buckets))
    with pytest.raises(ValueError, match="at least one bucket"):
        point_normal.point_normal_buckets([], [], torch.tensor(LAM))
    with pytest.raises(ValueError, match="one r_g per jp_g"):
        point_normal.point_normal_buckets([_t(buckets[0][0])], [], torch.tensor(LAM))


@pytest.mark.parametrize("p,t2,sms,want", [
    # The medium grid problem's five track buckets in f32 on a card of 132
    # SMs (the H100 SXM), worked by hand:
    # points = min(128, 512 // T2, ceil(P / SMs)), blocks = ceil(P / points),
    # shared = (max(4 * 512 + 8, up4(9 points) + 2 up4(3 points) + 12)
    #           + 9 points (T2 | 1)) * 4 bytes.
    (67584, 4, 132, (128, 528, (2056 + 9 * 640) * 4)),
    (18432, 6, 132, (85, 217, (2056 + 9 * 595) * 4)),
    (9216, 8, 132, (64, 144, (2056 + 9 * 576) * 4)),
    (5632, 16, 132, (32, 176, (2056 + 9 * 544) * 4)),
    (512, 24, 132, (4, 128, (2056 + 9 * 100) * 4)),  # 21 per chunk, 4 fill 128 blocks
    # On 114 SMs (the H100 PCIe) the last bucket takes 5 points per block.
    (512, 24, 114, (5, 103, (2056 + 9 * 125) * 4)),
])
def test_point_geometry_medium_pins(p, t2, sms, want):
    assert tuple(point_normal.point_geometry(p, t2, 4, sms)) == want


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_point_geometry_covers_every_point_once(itemsize, sms):
    """Every point of a bucket lies in exactly one block, a block of several
    points fits one chunk of rows, and the shared bytes stay under the
    card's limit, for T2 from 0 to 2,000 and P from 1 to 200,000, on cards
    of 132 and 114 SMs."""
    from tpu3drecon_torch.ops._wtt_common import SMEM_PER_BLOCK

    for t2 in list(range(0, 64)) + [100, 255, 256, 257, 511, 512, 513, 2000]:
        for p in (1, 2, 3, 113, 114, 115, 131, 132, 133, 1000, 67584, 200_000):
            geo = point_normal.point_geometry(p, t2, itemsize, sms)
            assert 1 <= geo.points <= point_normal.MAX_POINTS
            assert (geo.blocks - 1) * geo.points < p <= geo.blocks * geo.points
            assert geo.points == 1 or geo.points * t2 <= point_normal.CHUNK
            assert geo.smem <= SMEM_PER_BLOCK
            assert geo.smem == point_normal.point_smem(geo.points, t2, itemsize)
