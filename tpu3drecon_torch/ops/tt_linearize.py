"""Kernels B12-B16: the fully fused dense track-table ("tt") engine.

Replaces the five Pallas kernels of ``tpu3drecon/ops/pallas/tt_linearize.py``:

  B12 ``tt_cam_normal_fused`` (body ``_cam_kernel``): per slot, the camera
      row, the residual/Jacobian planes (``ba_tt._tt_blocks``), the point
      sums V (6 planes) and g_pt accumulated over the track, and the camera
      columns U upper triangle | g (``ba_tt._u_g_contribs``) reduced into
      (C, n_triu + np);
  B13 ``tt_coupling_fused`` (``_coupling_kernel``): the Schur-Jacobi columns
      W V^-1 W^T (``ba_tt._coupling_contribs``) reduced into (C, n_triu);
  B14 ``tt_wt_times_fused`` (``_wt_kernel``): W^T x point planes (3, Pb);
  B15 ``tt_w_times_fused`` (``_w_kernel``): W y camera rows (C, np);
  B16 ``tt_cost_fused`` (``_cost_kernel``): 0.5 * the sum of the whitened
      squared residuals of one bucket.

The JAX functions select camera rows and reduce into them through the dense
(C, Tb*Pb) one-hot; these take the slot's camera index ``cam_ids``
(Tb, Pb) int32 and ``mask`` in its place.  A padded slot (mask 0) selects
an all-zero camera row and adds to no camera, as its all-zero one-hot
column does.  Outputs have the JAX functions' shapes and order.

CUDA kernels (``csrc/tt_kernels.cu``): B12-B15 are slot-major, one lane
per track slot (a warp holds slot t of 32 consecutive point columns;
``_wtt_common.slot_geometry("tt_lin" | "tt_coupling" | "tt_wt" |
"tt_w")``), so a bucket runs on Tb * Pb threads.  Their per-point sums
(B12's V and g_pt, B14's W^T x) cross the warps through shared memory and
are added in slot order by one lane per point, the track order of the
plain versions' sums; their per-camera columns (B12's U | g, B13's
coupling, B15's W y) go through the warp's row tile, which groups the
lanes by camera and sends one atomic per (distinct camera, column).  B16
runs one thread per point column, which walks its track and reads its
slots' camera rows from device memory.  So B12's ug, B13 and B15 vary in
the last bits from run to run; every other output matches the plain
version to the last bit.  Any camera count runs.
B15 keeps two memory modes (``memory_mode``): its atomics go to a
block-shared (C, np) tile, flushed once per block, where the tile has at
most ``TILE_ENTRIES`` entries, and straight to the output above (PERF.md:
at C = 100 the tile measured faster on the largest medium bucket, at C =
1024 slower).  B12 has one mode: the same tile measured slower on every
medium bucket and at C = 1024, and so does B13.

Each public function runs its plain PyTorch version on CPU tensors and its
CUDA kernel on CUDA tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.geometry.losses import LOSS_CODES
from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import (
    check_inputs,
    check_shape,
    is_cuda_call,
    slot_geometry,
)
from tpu3drecon_torch.solvers.ba_tt import (
    CAM_TABLE_DIM,
    _coupling_contribs,
    _reduce,
    _select,
    _slot_cams,
    _triu_pairs,
    _tt_blocks,
    _u_g_contribs,
)

CAM_COUNTS = _build.LaunchCounter()  # B12
COUPLING_COUNTS = _build.LaunchCounter()  # B13
WT_COUNTS = _build.LaunchCounter()  # B14
W_COUNTS = _build.LaunchCounter()  # B15
COST_COUNTS = _build.LaunchCounter()  # B16

_V6_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


TILE_ENTRIES = 2048  # B15's block-shared tile at most: 8 entries per thread of 256


def shared_memory_bytes(n_cams: int, np_cam: int, itemsize: int) -> int:
    """Bytes of B15's block-shared (C, np) tile in its shared mode."""
    return n_cams * np_cam * itemsize


def memory_mode(n_cams: int, np_cam: int, forced=None) -> str:
    """B15's memory mode: ``SHARED`` (a block-shared (C, np) tile) where the
    tile has at most ``TILE_ENTRIES`` entries, ``GLOBAL`` (atomics straight
    into the output) above.  ``forced`` (the wrapper's private ``_mode``:
    None, ``SHARED`` or ``GLOBAL``) overrides the choice; a forced
    ``SHARED`` past the card's shared memory fails in the C entry."""
    if forced is not None:
        if forced not in (_build.SHARED, _build.GLOBAL):
            raise ValueError(f"_mode must be None, {_build.SHARED!r} or {_build.GLOBAL!r}, "
                             f"not {forced!r}")
        return forced
    return _build.SHARED if n_cams * np_cam <= TILE_ENTRIES else _build.GLOBAL


def _check_config(config, np_cam: int) -> None:
    want = 8 + 2 * bool(config.optimize_dist) + 2 * bool(config.optimize_pp)
    if np_cam != want:
        raise ValueError(f"np_cam={np_cam} does not match the config's {want}")


def _track_sum(planes) -> torch.Tensor:
    """Sum (K, Tb, Pb) over the track axis in track order, as the kernels
    accumulate: (K, Pb)."""
    acc = planes[:, 0]
    for t in range(1, planes.shape[1]):
        acc = acc + planes[:, t]
    return acc


# ------------------------------------------------------------------ B12 ---
def tt_cam_normal_fused_plain(table, cam_ids, pts, uv, mask, inv_w, config, np_cam: int):
    """Plain PyTorch version of ``tt_cam_normal_fused``."""
    _check_config(config, np_cam)
    CAM_COUNTS.plain += 1
    n_cams = table.shape[0]
    idx = _slot_cams(cam_ids, mask, n_cams)
    blocks = _tt_blocks(_select(table, idx), pts[:, None, :], uv, mask, inv_w, config)
    jc, jp, r = blocks.jc, blocks.jp, blocks.r
    v6 = _track_sum(torch.stack([jp[i] * jp[j] + jp[3 + i] * jp[3 + j] for i, j in _V6_PAIRS]))
    g_pt = _track_sum(torch.stack([jp[i] * r[0] + jp[3 + i] * r[1] for i in range(3)]))
    contribs = torch.stack(_u_g_contribs(jc, r, np_cam, _triu_pairs(np_cam)))
    return jc, jp, v6, g_pt, _reduce(contribs, idx, n_cams)


def tt_cam_normal_fused(table, cam_ids, pts, uv, mask, inv_w, config, np_cam: int):
    """Fused tt linearization of one bucket: (jc (2np, Tb, Pb), jp (6, Tb, Pb),
    v6 (6, Pb), g_pt (3, Pb), ug (C, n_triu + np)).

    ``table`` (C, 19) camera table, ``cam_ids`` (Tb, Pb) int32, ``pts``
    (3, Pb), ``uv`` (2, Tb, Pb), ``mask`` (Tb, Pb), ``inv_w`` a 0-d tensor;
    ``config`` gives the loss and the optimize_* flags.  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if not is_cuda_call(table):
        return tt_cam_normal_fused_plain(table, cam_ids, pts, uv, mask, inv_w, config, np_cam)
    _check_config(config, np_cam)
    name = "tt_cam_normal_fused"
    n_cams = table.shape[0]
    tb, pb = mask.shape
    dtype, dev = table.dtype, table.device
    inv_w = torch.as_tensor(inv_w, dtype=dtype, device=dev)
    check_inputs(name, dev, dtype, table=table, cam_ids=cam_ids, pts=pts, uv=uv,
                 mask=mask, inv_w=inv_w)
    check_shape(name, "table", table, (n_cams, CAM_TABLE_DIM))
    check_shape(name, "cam_ids", cam_ids, (tb, pb))
    check_shape(name, "pts", pts, (3, pb))
    check_shape(name, "uv", uv, (2, tb, pb))
    check_shape(name, "inv_w", inv_w, ())
    n_triu = np_cam * (np_cam + 1) // 2
    geo = slot_geometry("tt_lin", tb, pb, np_cam, table.element_size())
    jc = torch.empty((2 * np_cam, tb, pb), dtype=dtype, device=dev)
    jp = torch.empty((6, tb, pb), dtype=dtype, device=dev)
    v6 = torch.empty((6, pb), dtype=dtype, device=dev)
    g_pt = torch.empty((3, pb), dtype=dtype, device=dev)
    ug = torch.zeros((n_cams, n_triu + np_cam), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.tt_cam_normal(
        _build.dtype_code(dtype), np_cam, table.data_ptr(), cam_ids.data_ptr(),
        pts.data_ptr(), uv.data_ptr(), mask.data_ptr(), inv_w.data_ptr(),
        jc.data_ptr(), jp.data_ptr(), v6.data_ptr(), g_pt.data_ptr(), ug.data_ptr(),
        n_cams, tb, pb, LOSS_CODES[config.loss], int(config.optimize_focal),
        int(config.optimize_points), int(config.optimize_dist),
        int(config.optimize_pp), geo.warps, geo.groups, geo.smem, _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    CAM_COUNTS.launched(_build.GLOBAL)
    return jc, jp, v6, g_pt, ug


# ------------------------------------------------------------------ B13 ---
def tt_coupling_fused_plain(cam_ids, mask, jc, jp, v_inv, n_cams: int):
    """Plain PyTorch version of ``tt_coupling_fused``."""
    COUPLING_COUNTS.plain += 1
    np_cam = jc.shape[0] // 2
    v = v_inv[:, None, :]  # broadcast over the track axis
    vi = [[v[0], v[1], v[2]], [v[1], v[3], v[4]], [v[2], v[4], v[5]]]
    contribs = torch.stack(_coupling_contribs(jc, jp, vi, np_cam, _triu_pairs(np_cam)))
    return _reduce(contribs, _slot_cams(cam_ids, mask, n_cams), n_cams)


def _check_slots(name, lead, cam_ids, mask, jc, jp, **extra):
    """Input checks shared by B13-B15; returns (np, Tb, Pb)."""
    np_cam = jc.shape[0] // 2
    tb, pb = mask.shape
    check_inputs(name, lead.device, lead.dtype, cam_ids=cam_ids, mask=mask, jc=jc,
                 jp=jp, **extra)
    check_shape(name, "cam_ids", cam_ids, (tb, pb))
    check_shape(name, "jc", jc, (2 * np_cam, tb, pb))
    check_shape(name, "jp", jp, (6, tb, pb))
    return np_cam, tb, pb


def tt_coupling_fused(cam_ids, mask, jc, jp, v_inv, n_cams: int):
    """Exact Schur-Jacobi coupling columns (C, n_triu) of one bucket.

    ``cam_ids`` (Tb, Pb) int32, ``mask`` (Tb, Pb), ``jc`` (2np, Tb, Pb),
    ``jp`` (6, Tb, Pb), ``v_inv`` (6, Pb) damped V^-1 planes.  CPU tensors
    run the plain version, CUDA tensors the kernel."""
    if not is_cuda_call(jc):
        return tt_coupling_fused_plain(cam_ids, mask, jc, jp, v_inv, n_cams)
    name = "tt_coupling_fused"
    np_cam, tb, pb = _check_slots(name, jc, cam_ids, mask, jc, jp, v_inv=v_inv)
    check_shape(name, "v_inv", v_inv, (6, pb))
    out = torch.zeros((n_cams, np_cam * (np_cam + 1) // 2), dtype=jc.dtype, device=jc.device)
    geo = slot_geometry("tt_coupling", tb, pb, np_cam, jc.element_size())
    lib = _build.library()
    code = lib.tt_coupling(
        _build.dtype_code(jc.dtype), np_cam, cam_ids.data_ptr(), mask.data_ptr(),
        jc.data_ptr(), jp.data_ptr(), v_inv.data_ptr(), out.data_ptr(), n_cams, tb, pb,
        geo.warps, geo.groups, geo.smem, _build.stream_ptr(jc.device),
    )
    _build.check(lib, name, code)
    COUPLING_COUNTS.launched(_build.GLOBAL)
    return out


# ------------------------------------------------------------------ B14 ---
def tt_wt_times_fused_plain(x, cam_ids, mask, jc, jp):
    """Plain PyTorch version of ``tt_wt_times_fused``."""
    WT_COUNTS.plain += 1
    n_cams, np_cam = x.shape
    xg = _select(x, _slot_cams(cam_ids, mask, n_cams))  # (np, Tb, Pb)
    s0 = sum(jc[i] * xg[i] for i in range(np_cam))
    s1 = sum(jc[np_cam + i] * xg[i] for i in range(np_cam))
    return _track_sum(torch.stack([jp[l] * s0 + jp[3 + l] * s1 for l in range(3)]))


def tt_wt_times_fused(x, cam_ids, mask, jc, jp):
    """(W^T x) point planes (3, Pb) of one bucket; ``x`` (C, np), the rest
    as ``tt_coupling_fused``.  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if not is_cuda_call(x):
        return tt_wt_times_fused_plain(x, cam_ids, mask, jc, jp)
    name = "tt_wt_times_fused"
    np_cam, tb, pb = _check_slots(name, x, cam_ids, mask, jc, jp, x=x)
    n_cams = x.shape[0]
    check_shape(name, "x", x, (n_cams, np_cam))
    geo = slot_geometry("tt_wt", tb, pb, np_cam, x.element_size())
    out = torch.empty((3, pb), dtype=x.dtype, device=x.device)
    lib = _build.library()
    code = lib.tt_wt_times(
        _build.dtype_code(x.dtype), np_cam, x.data_ptr(), cam_ids.data_ptr(),
        mask.data_ptr(), jc.data_ptr(), jp.data_ptr(), out.data_ptr(), n_cams, tb, pb,
        geo.warps, geo.groups, geo.smem, _build.stream_ptr(x.device),
    )
    _build.check(lib, name, code)
    WT_COUNTS.launched(_build.GLOBAL)
    return out


# ------------------------------------------------------------------ B15 ---
def tt_w_times_fused_plain(y, cam_ids, mask, jc, jp, n_cams: int):
    """Plain PyTorch version of ``tt_w_times_fused``."""
    W_COUNTS.plain += 1
    np_cam = jc.shape[0] // 2
    yb = [y[i][None] for i in range(3)]
    s0 = jp[0] * yb[0] + jp[1] * yb[1] + jp[2] * yb[2]
    s1 = jp[3] * yb[0] + jp[4] * yb[1] + jp[5] * yb[2]
    z = torch.stack([jc[i] * s0 + jc[np_cam + i] * s1 for i in range(np_cam)])
    return _reduce(z, _slot_cams(cam_ids, mask, n_cams), n_cams)


def tt_w_times_fused(y, cam_ids, mask, jc, jp, n_cams: int, *, _mode=None):
    """(W y) camera rows (C, np) of one bucket; ``y`` (3, Pb) point planes,
    the rest as ``tt_coupling_fused``.  CPU tensors run the plain version,
    CUDA tensors the kernel in the memory mode of ``memory_mode``
    (``_mode`` forces one, for tests)."""
    if not is_cuda_call(y):
        return tt_w_times_fused_plain(y, cam_ids, mask, jc, jp, n_cams)
    name = "tt_w_times_fused"
    np_cam, tb, pb = _check_slots(name, y, cam_ids, mask, jc, jp, y=y)
    check_shape(name, "y", y, (3, pb))
    mode = memory_mode(n_cams, np_cam, _mode)
    tile = shared_memory_bytes(n_cams, np_cam, y.element_size()) if mode == _build.SHARED else 0
    geo = slot_geometry("tt_w", tb, pb, np_cam, y.element_size(), tile=tile)
    out = torch.zeros((n_cams, np_cam), dtype=y.dtype, device=y.device)
    lib = _build.library()
    code = lib.tt_w_times(
        _build.dtype_code(y.dtype), np_cam, y.data_ptr(), cam_ids.data_ptr(),
        mask.data_ptr(), jc.data_ptr(), jp.data_ptr(), out.data_ptr(), n_cams, tb, pb,
        geo.warps, geo.groups, geo.smem, tile, _build.stream_ptr(y.device),
    )
    _build.check(lib, name, code)
    W_COUNTS.launched(mode)
    return out


# ------------------------------------------------------------------ B16 ---
def tt_cost_fused_plain(table, cam_ids, pts, uv, mask, inv_w, config):
    """Plain PyTorch version of ``tt_cost_fused``."""
    COST_COUNTS.plain += 1
    idx = _slot_cams(cam_ids, mask, table.shape[0])
    r = _tt_blocks(_select(table, idx), pts[:, None, :], uv, mask, inv_w, config).r
    lane = _track_sum((r[0] * r[0] + r[1] * r[1])[None])[0]
    return 0.5 * torch.sum(lane)


def tt_cost_fused(table, cam_ids, pts, uv, mask, inv_w, config):
    """0.5 * sum(whitened r^2) of one bucket (a 0-d tensor); inputs as
    ``tt_cam_normal_fused`` (only ``config.loss`` matters).  The kernel
    writes one partial per point column; their sum is taken here, as the
    JAX function sums its lane partials outside its kernel.  CPU tensors
    run the plain version, CUDA tensors the kernel."""
    if not is_cuda_call(table):
        return tt_cost_fused_plain(table, cam_ids, pts, uv, mask, inv_w, config)
    name = "tt_cost_fused"
    n_cams = table.shape[0]
    tb, pb = mask.shape
    dtype, dev = table.dtype, table.device
    inv_w = torch.as_tensor(inv_w, dtype=dtype, device=dev)
    check_inputs(name, dev, dtype, table=table, cam_ids=cam_ids, pts=pts, uv=uv,
                 mask=mask, inv_w=inv_w)
    check_shape(name, "table", table, (n_cams, CAM_TABLE_DIM))
    check_shape(name, "cam_ids", cam_ids, (tb, pb))
    check_shape(name, "pts", pts, (3, pb))
    check_shape(name, "uv", uv, (2, tb, pb))
    check_shape(name, "inv_w", inv_w, ())
    lane = torch.empty((pb,), dtype=dtype, device=dev)
    lib = _build.library()
    code = lib.tt_cost(
        _build.dtype_code(dtype), table.data_ptr(), cam_ids.data_ptr(), pts.data_ptr(),
        uv.data_ptr(), mask.data_ptr(), inv_w.data_ptr(), lane.data_ptr(), n_cams,
        tb, pb, LOSS_CODES[config.loss], _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    COST_COUNTS.launched(_build.GLOBAL)
    return 0.5 * torch.sum(lane)
