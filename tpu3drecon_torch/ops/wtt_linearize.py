"""Kernel B1, the fully fused wtt linearization, and kernels B7 and B8, the
two halves of the unfused one.

B1 replaces ``tpu3drecon/ops/pallas/wtt_linearize.py:wtt_linearize_fused_idx``
(body ``_lin_fused_kernel``).  Per bucket it selects each slot's camera row
through ``wcam``, builds the residual and Jacobian planes
(``ba_tt._tt_blocks``), the point normal (damped V^-1, g_pt, damp_pt), and
reduces the window-camera rows (G, W, K) with columns

    u (n_triu) | g (np) [| Schur-Jacobi coupling (n_triu)] | rhs = W V^-1 g_pt (np)
    [| od (np^2)]

in the diagonal-major ``_triu_pairs`` order.  jc/jp are written for the CG
kernels.  With ``want_od`` (the band preconditioners ssor/tridiag) the np^2
od columns hold S_{c,c+1}: row w sums, over each track's adjacent slot pair
on window rows (w, w + 1), the i-major outer product of slot t-1's W V^-1
factor with slot t's W factor (``wtt_linearize.py:515-538``).

B7 replaces ``wtt_cam_planes_idx`` (body ``_cam_planes_kernel``): the
per-slot camera planes (G, 19, Tb, Pc), exact zeros on padded slots.  B8
replaces ``wtt_contrib_rows_idx`` (body ``_contrib_kernel``): the rows
(G, W, K) with columns u | g [| coupling] [| od] (B1's without the rhs)
from jc, jp, r and v_inv in device memory.  The unfused linearization of
``solvers/ba_wtt.py`` runs B7, the Jacobian planes and point normal in
PyTorch, then B8: the JAX engine's XLA route, whose two one-hot einsums
these kernels compute without the one-hot.

CUDA kernels: B1 (``csrc/wtt_kernels.cuh:lin_kernel``) is slot-major:
one lane per track slot computes its planes once (pass 1: jc/jp out, the
V | g_pt parts to shared memory, where one lane per point adds them in
slot order and forms V^-1) and keeps them in registers for pass 2, which
puts the K columns (88 per slot at np = 8, 152 with the od columns) into
each warp's row tile; one lane per (row, column) sends the atomic.  The od
pairs read slot t-1's W V^-1 factor from the copy its warp left in shared
memory.  ``_wtt_common.slot_geometry`` gives the launch geometry.  On the
H100 it is bound by latency at the occupancy its registers allow.  B8
(``csrc/wtt_route_kernels.cu:contrib_kernel``) is B1's pass 2 alone on
the same grid (``slot_geometry("contrib")``): one lane per slot reads its
jc/jp/r and puts its columns, in B1's order and with B1's od pairs, into
the warp's row tile.  B7 (``cam_planes_kernel``) is a per-slot copy bound
by the 19 planes it writes.
Row sums are atomic, so f32 rows vary in the last bits from run to run.
Camera rows are read from device memory and nothing is staged per block,
so any window width runs (``csrc/slot.cuh``).

B1 also takes the TPU kernel's ``terms=2`` (``linearize_kernel="index2"``,
``csrc/wtt_terms_kernels.cu``): in float32 the u | g | coupling and od
column values are rounded through two bfloat16 split pieces
(``_wtt_common.split_round``) before their reduction, as the TPU kernel's
2-term reduce dots round them; the camera rows, Jacobian planes, point
normal and rhs columns stay exact (``wtt_linearize.py:502-531``).
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.geometry.losses import LOSS_CODES
from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import (
    check_inputs,
    check_shape,
    is_cuda_call,
    reduce_rows,
    select_rows,
    slot_geometry,
    split_round,
)
from tpu3drecon_torch.solvers.ba_tt import (
    CAM_TABLE_DIM,
    _sym3_inv_planes,
    _sym3_matvec,
    _tt_blocks,
)

COUNTS = _build.LaunchCounter()  # B1
OD_COUNTS = _build.LaunchCounter()  # B1 with want_od
TERMS2_COUNTS = _build.LaunchCounter()  # B1 at terms 2
TERMS2_OD_COUNTS = _build.LaunchCounter()  # B1 at terms 2 with want_od
CAM_PLANES_COUNTS = _build.LaunchCounter()  # B7
CONTRIB_COUNTS = _build.LaunchCounter()  # B8
CONTRIB_OD_COUNTS = _build.LaunchCounter()  # B8 with want_od

_SYM = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


def n_contrib_cols(np_cam: int, use_sj: bool, want_od: bool = False) -> int:
    """K of the contribution rows: u | g [| coupling] [| od] (kernel B8)."""
    n_triu = np_cam * (np_cam + 1) // 2
    return n_triu + np_cam + (n_triu if use_sj else 0) + (np_cam**2 if want_od else 0)


def n_rows_cols(np_cam: int, use_sj: bool, want_od: bool = False) -> int:
    """K, the column count of the linearize rows: u | g [| coupling] | rhs
    [| od]."""
    return n_contrib_cols(np_cam, use_sj, want_od) + np_cam


def _check_od(use_sj: bool, want_od: bool) -> None:
    if want_od and not use_sj:
        raise ValueError("want_od requires use_sj (od reuses the W/WV tiles)")


def _lin_counter(want_od: bool, terms: int) -> _build.LaunchCounter:
    if terms not in (2, 3):
        raise ValueError(f"wtt_linearize_fused_idx: terms must be 2 or 3, not {terms!r}")
    if terms == 2:
        return TERMS2_OD_COUNTS if want_od else TERMS2_COUNTS
    return OD_COUNTS if want_od else COUNTS


def _check_config(blocks_config, np_cam: int, use_sj: bool, want_od: bool) -> None:
    _check_od(use_sj, want_od)
    want = 8 + 2 * bool(blocks_config.optimize_dist) + 2 * bool(blocks_config.optimize_pp)
    if np_cam != want:
        raise ValueError(f"np_cam={np_cam} does not match the config's {want}")


def wtt_linearize_fused_idx(
    wcam, tw, pts, uv, mask, lam, inv_w, blocks_config, np_cam: int,
    use_sj: bool, want_od: bool = False, terms: int = 3,
):
    """(rows (G, W, K), jc (2np, G, Tb, Pc), jp (6, G, Tb, Pc),
    v_inv (6, G, Pc), g_pt (3, G, Pc), damp_pt (3, G, Pc)).

    ``wcam`` (G, Tb*Pc) int16, ``tw`` (G, W, 19) window camera rows,
    ``pts`` (3, G, Pc), ``uv`` (G, 2, Tb, Pc), ``mask`` (G, Tb, Pc);
    ``lam``/``inv_w`` are 0-d tensors on the same device.  ``want_od``
    (needs ``use_sj``) appends the np^2 band pair columns.  ``terms`` 2
    rounds the float32 u | g | coupling | od values through two bfloat16
    split pieces (3: exact).  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    _check_config(blocks_config, np_cam, use_sj, want_od)
    _lin_counter(want_od, terms)
    if not is_cuda_call(tw):
        return wtt_linearize_fused_idx_plain(
            wcam, tw, pts, uv, mask, lam, inv_w, blocks_config, np_cam, use_sj,
            want_od, terms,
        )
    return _launch(wcam, tw, pts, uv, mask, lam, inv_w, blocks_config, np_cam, use_sj,
                   want_od, terms)


def wtt_linearize_fused_idx_plain(
    wcam, tw, pts, uv, mask, lam, inv_w, blocks_config, np_cam: int,
    use_sj: bool, want_od: bool = False, terms: int = 3,
):
    """Plain PyTorch version of ``wtt_linearize_fused_idx``."""
    _check_config(blocks_config, np_cam, use_sj, want_od)
    _lin_counter(want_od, terms).plain += 1
    g, _, tb, pc = uv.shape
    window = tw.shape[1]
    cp = select_rows(tw, wcam, tb, pc)  # (19, G, Tb, Pc)
    blocks = _tt_blocks(
        cp, pts[:, :, None, :], uv.permute(1, 0, 2, 3), mask, inv_w,
        blocks_config,
    )
    jc, jp, r = blocks.jc, blocks.jp, blocks.r  # (k, G, Tb, Pc)

    v_inv, g_pt, damp = point_normal(jp, r, lam)
    vw = _sym3_matvec(v_inv, g_pt)  # V^-1 g_pt, (G, Pc) planes

    parts, w_l, wv_l = _contrib_parts(jc, jp, r, v_inv, np_cam, use_sj)
    parts = [split_round(x, terms) for x in parts]  # the rhs below stays exact
    vwb = [x[:, None, :] for x in vw]
    s0r = jp[0] * vwb[0] + jp[1] * vwb[1] + jp[2] * vwb[2]
    s1r = jp[3] * vwb[0] + jp[4] * vwb[1] + jp[5] * vwb[2]
    parts.append(jc[:np_cam] * s0r[None] + jc[np_cam:] * s1r[None])
    rows = reduce_rows(torch.cat(parts, dim=0), wcam, window)
    if want_od:
        rows = torch.cat([rows, _od_rows(wcam, w_l, wv_l, window, terms)], dim=2)
    return rows, jc, jp, v_inv, g_pt, damp


def point_normal(jp, r, lam):
    """(v_inv (6, G, Pc), g_pt (3, G, Pc), damp_pt (3, G, Pc)) from the
    slot planes jp (6, G, Tb, Pc) and r (2, G, Tb, Pc): V and g_pt summed
    over the track, the diagonal damped by lam * max(V_ii, 1e-8), then the
    closed-form inverse (the JAX engine's unfused order,
    ``ba_wtt.py:436-448``)."""
    v6 = torch.stack([
        torch.sum(jp[i] * jp[j] + jp[3 + i] * jp[3 + j], dim=1)
        for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    ])  # (6, G, Pc)
    g_pt = torch.stack(
        [torch.sum(jp[i] * r[0] + jp[3 + i] * r[1], dim=1) for i in range(3)]
    )
    damp = torch.stack([lam * torch.clamp(v6[k], min=1e-8) for k in (0, 3, 5)])
    v6_d = torch.stack(
        [v6[0] + damp[0], v6[1], v6[2], v6[3] + damp[1], v6[4], v6[5] + damp[2]]
    )
    return _sym3_inv_planes(v6_d), g_pt, damp


def _contrib_parts(jc, jp, r, v_inv, np_cam: int, use_sj: bool):
    """(parts, w_l, wv_l): per-slot contribution planes u | g [| Schur-Jacobi
    coupling], in the diagonal-major ``_triu_pairs`` order (kernel B1's pass
    2 and B8), and with ``use_sj`` the W and W V^-1 factor planes (3 lists
    of (np, G, Tb, Pc)) that the band pair rows reuse."""
    jc0, jc1 = jc[:np_cam], jc[np_cam:]
    parts = [
        jc0[: np_cam - d] * jc0[d:] + jc1[: np_cam - d] * jc1[d:]
        for d in range(np_cam)
    ]
    parts.append(jc0 * r[0][None] + jc1 * r[1][None])
    w_l = wv_l = None
    if use_sj:
        v = v_inv[:, :, None, :]  # broadcast over the track axis
        w_l = [jc0 * jp[l][None] + jc1 * jp[3 + l][None] for l in range(3)]
        wv_l = [
            w_l[0] * v[_SYM[0][l]][None]
            + w_l[1] * v[_SYM[1][l]][None]
            + w_l[2] * v[_SYM[2][l]][None]
            for l in range(3)
        ]
        parts.extend(
            wv_l[0][: np_cam - d] * w_l[0][d:]
            + wv_l[1][: np_cam - d] * w_l[1][d:]
            + wv_l[2][: np_cam - d] * w_l[2][d:]
            for d in range(np_cam)
        )
    return parts, w_l, wv_l


def _od_rows(wcam, w_l, wv_l, window: int, terms: int = 3) -> torch.Tensor:
    """Band pair rows (G, W, np^2) from the factor planes of
    ``_contrib_parts``: od[i * np + j] = sum_l wv_l[l][i] (slot t-1) *
    w_l[l][j] (slot t), rounded by ``split_round(., terms)`` and reduced
    into window row w where slot t-1 sits on w and slot t on w + 1; padded
    slots (-1) never pair, and Tb = 1 gives zeros."""
    np_cam, g, tb, pc = w_l[0].shape
    od = torch.cat([
        wv_l[0][i][None, :, :-1] * w_l[0][:, :, 1:]
        + wv_l[1][i][None, :, :-1] * w_l[1][:, :, 1:]
        + wv_l[2][i][None, :, :-1] * w_l[2][:, :, 1:]
        for i in range(np_cam)
    ], dim=0)  # (np^2, G, Tb-1, Pc), i-major
    idx = wcam.reshape(g, tb, pc).long()
    prev, cur = idx[:, :-1], idx[:, 1:]
    pair = torch.where((prev >= 0) & (cur == prev + 1), prev, torch.full_like(prev, -1))
    return reduce_rows(split_round(od, terms), pair.reshape(g, -1), window)


def _launch(wcam, tw, pts, uv, mask, lam, inv_w, cfg, np_cam, use_sj, want_od, terms):
    name = "wtt_linearize_fused_idx"
    g, _, tb, pc = uv.shape
    window = tw.shape[1]
    dtype, dev = tw.dtype, tw.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    inv_w = torch.as_tensor(inv_w, dtype=dtype, device=dev)
    check_inputs(name, dev, dtype, wcam=wcam, tw=tw, pts=pts, uv=uv,
                 mask=mask, lam=lam, inv_w=inv_w)
    check_shape(name, "wcam", wcam, (g, tb * pc))
    check_shape(name, "tw", tw, (g, window, CAM_TABLE_DIM))
    check_shape(name, "pts", pts, (3, g, pc))
    check_shape(name, "mask", mask, (g, tb, pc))
    check_shape(name, "lam", lam, ())
    check_shape(name, "inv_w", inv_w, ())
    k = n_rows_cols(np_cam, use_sj, want_od)
    rows = torch.zeros((g, window, k), dtype=dtype, device=dev)
    jc = torch.empty((2 * np_cam, g, tb, pc), dtype=dtype, device=dev)
    jp = torch.empty((6, g, tb, pc), dtype=dtype, device=dev)
    v_inv = torch.empty((6, g, pc), dtype=dtype, device=dev)
    g_pt = torch.empty((3, g, pc), dtype=dtype, device=dev)
    damp = torch.empty((3, g, pc), dtype=dtype, device=dev)
    geo = slot_geometry("lin", tb, pc, np_cam, tw.element_size(), want_od)
    lib = _build.library()
    code = lib.wtt_linearize(
        _build.dtype_code(dtype), np_cam, terms, wcam.data_ptr(), tw.data_ptr(),
        pts.data_ptr(), uv.data_ptr(), mask.data_ptr(), lam.data_ptr(),
        inv_w.data_ptr(), rows.data_ptr(), jc.data_ptr(), jp.data_ptr(),
        v_inv.data_ptr(), g_pt.data_ptr(), damp.data_ptr(), g, tb, pc, window,
        int(use_sj), int(want_od), LOSS_CODES[cfg.loss], int(cfg.optimize_focal),
        int(cfg.optimize_points), int(cfg.optimize_dist), int(cfg.optimize_pp),
        geo.warps, geo.groups, geo.smem, _build.stream_ptr(dev),
    )
    _build.check(lib, name, code)
    _lin_counter(want_od, terms).launched(_build.GLOBAL)
    return rows, jc, jp, v_inv, g_pt, damp


# ------------------------------------------------------------------ B7 ---
def wtt_cam_planes_idx_plain(wcam, tw, tb: int):
    """Plain PyTorch version of ``wtt_cam_planes_idx``."""
    CAM_PLANES_COUNTS.plain += 1
    return select_rows(tw, wcam, tb, wcam.shape[1] // tb).transpose(0, 1)


def wtt_cam_planes_idx(wcam, tw, tb: int):
    """(G, 19, Tb, Pc) per-slot camera planes: ``tw[g, wcam[g, n]]`` for
    every slot n = t * Pc + p of group g, exact zeros for padding (-1).

    ``wcam`` (G, Tb*Pc) int16, ``tw`` (G, W, 19) window camera rows.  CPU
    tensors run the plain version, CUDA tensors the kernel."""
    if not is_cuda_call(tw):
        return wtt_cam_planes_idx_plain(wcam, tw, tb)
    name = "wtt_cam_planes_idx"
    g, window, d = tw.shape
    n = wcam.shape[1]
    check_inputs(name, tw.device, tw.dtype, wcam=wcam, tw=tw)
    check_shape(name, "wcam", wcam, (g, n))
    check_shape(name, "tw", tw, (g, window, CAM_TABLE_DIM))
    if n % tb:
        raise ValueError(f"{name}: {n} slots per group is not a multiple of Tb={tb}")
    out = torch.empty((g, d, tb, n // tb), dtype=tw.dtype, device=tw.device)
    lib = _build.library()
    code = lib.wtt_cam_planes(
        _build.dtype_code(tw.dtype), wcam.data_ptr(), tw.data_ptr(), out.data_ptr(),
        g, n, window, _build.stream_ptr(tw.device),
    )
    _build.check(lib, name, code)
    CAM_PLANES_COUNTS.kernel += 1
    return out


# ------------------------------------------------------------------ B8 ---
def wtt_contrib_rows_idx_plain(wcam, jc, jp, r, v_inv, np_cam: int, window: int,
                               use_sj: bool, want_od: bool = False):
    """Plain PyTorch version of ``wtt_contrib_rows_idx``."""
    _check_od(use_sj, want_od)
    (CONTRIB_OD_COUNTS if want_od else CONTRIB_COUNTS).plain += 1
    parts, w_l, wv_l = _contrib_parts(jc, jp, r, v_inv, np_cam, use_sj)
    rows = reduce_rows(torch.cat(parts, dim=0), wcam, window)
    if want_od:
        rows = torch.cat([rows, _od_rows(wcam, w_l, wv_l, window)], dim=2)
    return rows


def wtt_contrib_rows_idx(wcam, jc, jp, r, v_inv, np_cam: int, window: int,
                         use_sj: bool, want_od: bool = False):
    """Window-camera contribution rows (G, W, K), K = n_triu + np
    [+ n_triu with ``use_sj``] [+ np^2 with ``want_od``], columns u | g
    [| coupling] [| od] in the diagonal-major ``_triu_pairs`` order (od as
    B1's, i-major).

    ``wcam`` (G, Tb*Pc) int16, ``jc`` (2np, G, Tb, Pc), ``jp`` (6, G, Tb,
    Pc), ``r`` (2, G, Tb, Pc), ``v_inv`` (6, G, Pc).  ``want_od`` needs
    ``use_sj`` (``ValueError``).  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    _check_od(use_sj, want_od)
    if not is_cuda_call(jc):
        return wtt_contrib_rows_idx_plain(wcam, jc, jp, r, v_inv, np_cam, window, use_sj,
                                          want_od)
    name = "wtt_contrib_rows_idx"
    _, g, tb, pc = jp.shape
    check_inputs(name, jc.device, jc.dtype, wcam=wcam, jc=jc, jp=jp, r=r, v_inv=v_inv)
    check_shape(name, "wcam", wcam, (g, tb * pc))
    check_shape(name, "jc", jc, (2 * np_cam, g, tb, pc))
    check_shape(name, "r", r, (2, g, tb, pc))
    check_shape(name, "v_inv", v_inv, (6, g, pc))
    k = n_contrib_cols(np_cam, use_sj, want_od)
    rows = torch.zeros((g, window, k), dtype=jc.dtype, device=jc.device)
    geo = slot_geometry("contrib", tb, pc, np_cam, jc.element_size(), want_od)
    lib = _build.library()
    code = lib.wtt_contrib(
        _build.dtype_code(jc.dtype), np_cam, wcam.data_ptr(), jc.data_ptr(),
        jp.data_ptr(), r.data_ptr(), v_inv.data_ptr(), rows.data_ptr(), g, tb, pc,
        window, int(use_sj), int(want_od), geo.warps, geo.groups, geo.smem,
        _build.stream_ptr(jc.device),
    )
    _build.check(lib, name, code)
    (CONTRIB_OD_COUNTS if want_od else CONTRIB_COUNTS).launched(_build.GLOBAL)
    return rows
