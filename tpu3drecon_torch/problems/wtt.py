"""Windowed track-table ("wtt") BA problem.

Counterpart of ``tpu3drecon/problems/wtt.py``.  Points are
ordered by their minimum observing camera inside each track-length bucket
and chunked along the point axis, so each chunk's observations fall inside
a narrow, 128-aligned camera WINDOW.  Each slot stores its
window-relative camera index in ``wcam`` (int16, -1 = padding); the
kernels gather the window camera row through it directly.  The dense
(G, W, Tb*Pc) one-hot of the JAX layout is built on the target device
from ``wcam`` unless deferred (``defer_onehot=True``); only the
``matvec_kernel=True``/``"fused"`` route reads it (kernel B6), every
other route reads ``wcam``.

Packing is host-side numpy, identical to the JAX packer step for step, so
both packages produce bit-equal arrays; ``device`` places the result.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams, _to
from tpu3drecon_torch.utils.timing import span, spanned

CAM_TILE = 128


@dataclass(frozen=True)
class WTTBucket:
    """One track-length bucket, chunked along the point axis.

    ``G`` groups of ``Pc`` point columns; slot tables are group-major with
    the (Tb, Pc) slot axes last.  ``wcam[g, t * Pc + p]`` is the
    window-relative camera of slot (t, p) of group g; ``cam_base[g]`` (a
    multiple of 128) maps it back to the global camera axis.  With
    ``global_tiles`` > 0 the last ``128 * global_tiles`` window rows address
    the shared global camera tiles starting at ``global_tile0``.
    ``window`` is the TOTAL window row count (local + global rows).
    ``onehot[g, w, n]`` is 1 where ``wcam[g, n] == w`` (padding columns
    are all zero); None while deferred.
    """

    uv: torch.Tensor  # (G, 2, Tb, Pc)
    mask: torch.Tensor  # (G, Tb, Pc)
    cam_base: torch.Tensor  # (G,) int32, multiples of 128
    wcam: torch.Tensor  # (G, Tb*Pc) int16, -1 = padding
    onehot: torch.Tensor = None  # (G, W, Tb*Pc) {0, 1}; None while deferred
    window: int = CAM_TILE
    global_tiles: int = 0
    global_tile0: int = 0

    def to(self, device) -> "WTTBucket":
        return _to(self, device)


@dataclass(frozen=True)
class BAWTTProblem:
    """BA problem in windowed track-table layout.

    Points are permuted into bucket-major, camera-local order
    (``point_rows`` maps back, see ``problems.grid.unpermute_points``);
    cameras may be relabeled for window locality (``cam_rows[new] = old``,
    None = identity).  ``window`` is the max over the buckets' windows.
    """

    cameras: CameraParams
    points3d: torch.Tensor  # (P_total, 3) permuted + padded
    buckets: Tuple[WTTBucket, ...]
    avg_cam_width: torch.Tensor  # ()
    point_rows: torch.Tensor = None
    cam_rows: torch.Tensor = None
    n_real_points: int = 0
    bucket_offsets: Tuple[int, ...] = ()
    window: int = CAM_TILE
    c_pad: int = CAM_TILE

    @property
    def n_cameras(self) -> int:
        return self.cameras.rmats.shape[0]

    def to(self, device) -> "BAWTTProblem":
        return _to(self, device)


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _expand_wcam(wcam: torch.Tensor, window: int, dtype) -> torch.Tensor:
    """(G, n) window-relative camera indices -> (G, W, n) one-hot, on
    ``wcam``'s device.  Padding slots carry -1, which matches no window
    row, so they expand to all-zero columns."""
    rows = torch.arange(window, device=wcam.device, dtype=torch.int32)[None, :, None]
    return (wcam[:, None, :].to(torch.int32) == rows).to(dtype)


def expand_onehots(problem: "BAWTTProblem", onehot_dtype=None) -> "BAWTTProblem":
    """Materialize deferred one-hots (``wtt_from_flat(defer_onehot=True)``)
    where the problem lives; ``onehot_dtype`` defaults to int8.  Buckets
    that already hold a one-hot keep it."""
    dt = torch.int8 if onehot_dtype is None else onehot_dtype
    buckets = tuple(
        b if b.onehot is not None
        else dataclasses.replace(b, onehot=_expand_wcam(b.wcam, b.window, dt))
        for b in problem.buckets
    )
    return dataclasses.replace(problem, buckets=buckets)


def unpermute_cameras(cameras: CameraParams, cam_rows) -> CameraParams:
    """Map relabeled camera output back to original camera order
    (``cam_rows[new] = old``; identity when None)."""
    if cam_rows is None:
        return cameras
    rows = cam_rows.to(cameras.rmats.device).long()

    def unperm(x):
        out = torch.zeros_like(x)
        out[rows] = x
        return out

    return CameraParams(
        rmats=unperm(cameras.rmats),
        tvecs=unperm(cameras.tvecs),
        fx_fy=unperm(cameras.fx_fy),
        cx_cy_skew=unperm(cameras.cx_cy_skew),
        dist=unperm(cameras.dist),
    )


# Default per-bucket window-class cap under ``split_windows=True``: classes
# beyond it merge into exact covering bins (``_coalesce_window_classes``).
_SPLIT_MAX_CLASSES = 4


def _split_class_cap(split_windows) -> int:
    """Per-bucket window-class cap implied by ``split_windows``: ``True`` ->
    ``_SPLIT_MAX_CLASSES``, an ``int`` N > 0 -> N; raises ``ValueError``
    for an int <= 0."""
    if split_windows is True:
        return _SPLIT_MAX_CLASSES
    cap = int(split_windows)
    if cap <= 0:
        raise ValueError(
            f"split_windows int cap must be > 0 (got {split_windows}); "
            "use False/0 to disable splitting"
        )
    return cap


def _coalesce_window_classes(runs_by_class, max_classes, n_gt, c_pad):
    """Merge window classes into at most ``max_classes`` covering bins.

    A class ``(w, gr)`` (local width ``w``, global-tile range ``gr``: None
    or an inclusive tile hull ``(lo, hi)``) may ride any bin ``(W, GR)``
    with ``W >= w`` and ``GR`` a superset of ``gr``; padded rows contribute
    exact zeros, so values are preserved.  The bins are the subset of
    candidate keys (widths x observed range hulls) of least total
    selection rows (chunks x bin rows), found by exhaustive enumeration;
    above ``_ENUM_BUDGET`` subsets a deterministic greedy add seeded with
    the cover-all key.  Ties resolve through sorted keys (None ranges sort
    first as ``(-1, -1)``), so the bins and their run order are the JAX
    packer's.  Returns {bin: [(clamped base, chunk ids), ...]}.
    """
    import itertools
    import math

    def _r(gr):  # sortable form: None -> (-1, -1)
        return (-1, -1) if gr is None else gr

    def rows(key):
        w, gr = key
        return w + ((gr[1] - gr[0] + 1) * CAM_TILE if gr is not None else 0)

    def n_chunks(runs):
        return sum(len(ids) for _, ids in runs)

    keys = sorted(runs_by_class, key=lambda k: (k[0], _r(k[1])))
    weights = {k: n_chunks(runs_by_class[k]) for k in keys}
    widths = sorted({w for w, _ in keys})
    granges = [gr for _, gr in keys if gr is not None]
    los = sorted({gr[0] for gr in granges})
    his = sorted({gr[1] for gr in granges})
    hulls = [None] + sorted(
        {(lo, hi) for lo in los for hi in his if lo <= hi}
    )
    full = (min(los), max(his)) if granges else None
    top = (widths[-1], full)
    cands = sorted(
        {
            (w, gr)
            for w in widths
            for gr in hulls
            if any(
                w >= kw
                and (kgr is None
                     or (gr is not None and gr[0] <= kgr[0] and gr[1] >= kgr[1]))
                for kw, kgr in keys
            )
        },
        key=lambda k: (k[0], _r(k[1])),
    )

    def admissible(bin_key, cls_key):
        if bin_key[0] < cls_key[0]:
            return False
        gr_b, gr_c = bin_key[1], cls_key[1]
        if gr_c is None:
            return True
        return gr_b is not None and gr_b[0] <= gr_c[0] and gr_b[1] >= gr_c[1]

    def subset_cost(subset):
        cost = 0
        for k in keys:
            fits = [rows(b) for b in subset if admissible(b, k)]
            if not fits:
                return None
            cost += weights[k] * min(fits)
        return cost

    def skey(key):
        return (key[0], _r(key[1]))

    n_bins = min(max_classes, len(cands))
    _ENUM_BUDGET = 200_000
    if math.comb(len(cands), n_bins) <= _ENUM_BUDGET:
        best = None
        for subset in itertools.combinations(cands, n_bins):
            cost = subset_cost(subset)
            if cost is None:
                continue
            cand = (cost, tuple(skey(b) for b in subset), subset)
            if best is None or cand[:2] < best[:2]:
                best = cand
        bins = best[2]
    else:
        chosen = [top]  # the only single-key cover-all
        while len(chosen) < n_bins:
            best_add = min(
                ((subset_cost(chosen + [c]), skey(c), c)
                 for c in cands if c not in chosen),
                key=lambda t: t[:2],
            )
            chosen.append(best_add[2])
        bins = tuple(sorted(chosen, key=skey))

    merged: dict = {}
    for k in keys:
        bk = min(
            (b for b in bins if admissible(b, k)),
            key=lambda b: (rows(b), skey(b)),
        )
        clamp = max(c_pad - bk[0], 0)
        merged.setdefault(bk, []).extend(
            (min(b, clamp), ids) for b, ids in runs_by_class[k]
        )
    return merged


def _hub_point_order(tc, tm, glob_start: int, n_gt: int) -> np.ndarray:
    """Point order of one bucket under a split hub packing: hub-observing
    points after the others, then by global-tile hull (lowest, then
    highest tile) and by minimum local camera; stable, as the JAX packer's
    ``np.lexsort``."""
    real = tm > 0
    loc = np.where(real & (tc < glob_start), tc, np.iinfo(np.int64).max)
    min_local = loc.min(axis=1)
    gp = np.where(real & (tc >= glob_start), tc - glob_start, -1)
    has_gp = gp.max(axis=1) >= 0
    g_hi_p = np.maximum(gp.max(axis=1), 0) // CAM_TILE
    gp_lo = np.where(gp >= 0, gp, np.iinfo(np.int64).max)
    g_lo_p = np.minimum(gp_lo.min(axis=1) // CAM_TILE, n_gt - 1)
    return np.lexsort((min_local, g_hi_p, g_lo_p, has_gp))


def _split_runs(tc, tm, rows_b, n_chunks: int, Pc: int, glob_start: int, c_pad: int):
    """{(window class, global-tile hull): [(base, chunk ids), ...]}: runs of
    consecutive micro-chunks with equal (base, class, hull) keys.  A chunk
    with real but unobserved points takes the key (0, 128, None); a chunk
    with no real point row is dropped (transparent to the runs)."""
    keys = []
    for gi in range(n_chunks):
        sl = slice(gi * Pc, (gi + 1) * Pc)
        cams = tc[sl][tm[sl] > 0]
        if cams.size == 0:
            keys.append(None if (rows_b[sl] < 0).all() else (0, CAM_TILE, None))
            continue
        gcams = cams[cams >= glob_start]
        grange = None
        if gcams.size:
            grange = (
                int(gcams.min() - glob_start) // CAM_TILE,
                int(gcams.max() - glob_start) // CAM_TILE,
            )
        local = cams[cams < glob_start]
        if local.size:
            base = (int(local.min()) // CAM_TILE) * CAM_TILE
            wcls = min(_pad_up(int(local.max()) - base + 1, CAM_TILE), c_pad)
            base = min(base, c_pad - wcls)
        else:
            base, wcls = 0, 0
        keys.append((base, wcls, grange))

    runs_by_class: dict = {}
    cur_key, cur_ids = None, []
    for gi, k in enumerate(keys + [False]):
        if k is None:
            continue
        if k == cur_key:
            cur_ids.append(gi)
            continue
        if cur_key is not None:
            runs_by_class.setdefault(cur_key[1:], []).append((cur_key[0], cur_ids))
        cur_key, cur_ids = (k, [gi]) if k is not False else (None, [])
    return runs_by_class


def _choose_cap(run_lengths, max_waste: float = 0.125, min_groups: int = 1) -> int:
    """Group-size cap (in micro-chunks): fewest groups within a padding cap
    of ``max_waste``; keeps at least ``min_groups`` groups when admissible."""
    if not run_lengths:
        return 1
    base_total = sum(run_lengths)
    candidates = []
    for cap in range(1, max(run_lengths) + 1):
        total = sum(((r + cap - 1) // cap) * cap for r in run_lengths)
        if total > base_total * (1.0 + max_waste):
            continue
        groups = sum((r + cap - 1) // cap for r in run_lengths)
        candidates.append((cap, groups, total))
    pool = [c for c in candidates if c[1] >= min_groups] or candidates
    best = min(pool, key=lambda c: (c[1], c[2], -c[0]))
    return best[0]


def _slots_estimate(pt_idx_real: np.ndarray, n_points: int,
                    bounds: Tuple[int, ...]) -> float:
    """Approximate total slot columns of the bucketed track table."""
    counts = np.bincount(pt_idx_real, minlength=n_points)
    counts = counts[counts > 0]
    tb = np.asarray(sorted(bounds), np.int64)
    idx = np.searchsorted(tb, counts)
    rounded = np.where(idx < len(tb), tb[np.minimum(idx, len(tb) - 1)], counts)
    return float(rounded.sum()) * 1.13


def _plan_camera_order(problem: BAProblem, reorder_cameras: str, bounds,
                       point_chunk: int, max_onehot_bytes: int, itemsize: int):
    """(perm or None, n_local): the window-locality relabeling of
    ``wtt_from_flat``'s ``reorder_cameras`` modes."""
    from tpu3drecon_torch.problems.reorder import (
        estimate_local_window,
        plan_camera_order,
        plan_hub_camera_order,
        rcm_camera_order,
    )

    n_local = problem.n_cameras
    ci = problem.cam_idx.cpu().numpy()
    pi = problem.pt_idx.cpu().numpy()
    mk = problem.mask.cpu().numpy()
    if reorder_cameras == "always":
        real = mk > 0
        return rcm_camera_order(
            ci[real], pi[real], problem.n_cameras, problem.n_points
        ), n_local
    if reorder_cameras == "hub":
        perm, n_local, _ = plan_hub_camera_order(
            ci, pi, mk, problem.n_cameras, problem.n_points,
            point_chunk=point_chunk,
        )
        return perm, n_local
    perm, _ = plan_camera_order(ci, pi, mk, problem.n_cameras, problem.n_points)
    # Estimate the one-hot bytes of the plain (RCM or input) order; if they
    # would not fit, try the hub/global split.
    real = mk > 0
    cr, pr = ci[real].astype(np.int64), pi[real].astype(np.int64)
    if perm is not None:
        inv0 = np.empty(problem.n_cameras, np.int64)
        inv0[perm] = np.arange(problem.n_cameras)
    else:
        inv0 = np.arange(problem.n_cameras)
    w_plain = estimate_local_window(
        cr, pr, problem.n_points, inv0, problem.n_cameras,
        point_chunk=point_chunk,
    )
    slots_est = _slots_estimate(pr, problem.n_points, bounds)
    est_plain = w_plain * slots_est * itemsize
    if est_plain > 0.5 * max_onehot_bytes:
        hub_perm, hub_local, hub_stats = plan_hub_camera_order(
            ci, pi, mk, problem.n_cameras, problem.n_points,
            point_chunk=point_chunk,
        )
        if hub_stats["score"] * slots_est * itemsize < est_plain:
            perm, n_local = hub_perm, hub_local
    return perm, n_local


@spanned("pack.wtt_from_flat")
def wtt_from_flat(
    problem: BAProblem,
    bounds: Tuple[int, ...] = (2, 3, 4, 8),
    point_chunk: int = 512,
    max_onehot_bytes: int = 8 << 30,
    chunk_multiple: int = 1,
    onehot_dtype=None,
    reorder_cameras: str = "auto",
    defer_onehot: bool = False,
    split_windows: bool | int = False,
    device=None,
) -> BAWTTProblem:
    """Repack a flat BAProblem into the windowed track-table layout.

    Same plan as the JAX packer: ``point_chunk``-wide micro-chunks sharing
    a 128-aligned window base merge into groups (the arrays' leading
    axis); windows are per bucket, derived from the data.  Raises
    ``ValueError`` when the windowed one-hots would exceed
    ``max_onehot_bytes`` at ``onehot_dtype``'s itemsize (int8 by default;
    a float dtype is accepted too), deferred or not, as the JAX packer
    does.  ``reorder_cameras`` is "auto", "always", "never" or "hub"
    (problems/reorder.py).  Unless ``defer_onehot``, each bucket's dense
    one-hot is built from ``wcam`` on ``device`` (``expand_onehots``
    builds it later); the fully indexed route never reads it.

    ``split_windows`` refines the window to micro-chunk granularity: chunks
    are classed by their own 128-aligned local window and, under a hub
    split, by the global-tile hull they touch (after a stable re-sort of
    each bucket's points by hull), and each class becomes its own bucket
    (a class of hub-only chunks has no local rows, ``window`` = its global
    rows).  Chunks without a real point are dropped.  ``True`` caps the
    classes per bucket at ``_SPLIT_MAX_CLASSES`` by merging them into exact
    covering bins; an int N > 0 caps them at N (``ValueError`` for N <= 0).
    Values are step-equivalent to the unsplit packing.  ``device`` defaults
    to the problem's device.  The span ``pack.wtt_from_flat`` has one child
    per pass: ``pack.camera_order``, ``pack.grid``, ``pack.windows`` (pass
    1), ``pack.fill`` (pass 2) and ``pack.to_device``.
    """
    oh_dtype = torch.int8 if onehot_dtype is None else onehot_dtype
    itemsize = torch.empty((), dtype=oh_dtype).element_size()
    if reorder_cameras not in ("auto", "always", "never", "hub"):
        raise ValueError(f"reorder_cameras={reorder_cameras!r}")
    if device is None:
        device = problem.points3d.device
    cam_rows = None
    n_local = problem.n_cameras
    if reorder_cameras != "never":
        from tpu3drecon_torch.problems.reorder import permute_cameras_flat

        with span("pack.camera_order"):
            perm, n_local = _plan_camera_order(
                problem, reorder_cameras, bounds, point_chunk, max_onehot_bytes,
                itemsize,
            )
            if perm is not None:
                problem = permute_cameras_flat(problem, perm)
                cam_rows = perm

    with span("pack.grid"):
        g = grid_bucketed_from_flat(
            problem, bounds=bounds, point_block=point_chunk,
            order_points_by_cam=True, device="cpu",
        )
    guv = g.uv.numpy()
    C, K = guv.shape[:2]
    uv_flat = guv.reshape(C * K, 2)
    np_dtype = uv_flat.dtype
    c_pad = _pad_up(max(C, 1), CAM_TILE)
    Pc = point_chunk

    # Hub/global split geometry: cameras labeled >= glob_start live in the
    # n_gt shared global tiles appended to every chunk's window.
    g_tile0 = (n_local // CAM_TILE) if n_local < C else (c_pad // CAM_TILE)
    glob_start = g_tile0 * CAM_TILE
    n_gt = c_pad // CAM_TILE - g_tile0

    # Pass 1: per-bucket window, clamped micro-chunk bases, grouping plan;
    # with split_windows per micro-chunk window classes, each its own bucket.
    with span("pack.windows"):
        plans = []  # (ti, tc, tm, window, groups, cap, grange, porder, row_off)
        onehot_bytes = 0
        row_off = 0
        g_rows_all = g.point_rows.numpy()
        for b in g.buckets:
            ti = b.track_idx.numpy()
            tc = b.track_cam.numpy()
            tm = b.track_mask.numpy()
            Pb, Tb = ti.shape
            n_chunks = Pb // Pc
            if split_windows:
                porder = None
                rows_b = g_rows_all[row_off : row_off + Pb]
                if n_gt > 0:
                    # Cluster hub-observing points by their global-tile hull, so
                    # most chunks skip the global tiles or carry one of them.
                    porder = _hub_point_order(tc, tm, glob_start, n_gt)
                    ti, tc, tm, rows_b = ti[porder], tc[porder], tm[porder], rows_b[porder]
                runs_by_class = _split_runs(tc, tm, rows_b, n_chunks, Pc, glob_start, c_pad)
                max_cls = _split_class_cap(split_windows)
                if max_cls and len(runs_by_class) > max_cls:
                    runs_by_class = _coalesce_window_classes(
                        runs_by_class, max_cls, n_gt, c_pad
                    )
                for (wcls, grange) in sorted(
                    runs_by_class,
                    key=lambda k: (k[0], (-1, -1) if k[1] is None else k[1]),
                ):
                    runs = runs_by_class[(wcls, grange)]
                    cap = _choose_cap(
                        [len(ids) for _, ids in runs], min_groups=max(chunk_multiple, 1)
                    )
                    groups = []
                    for base, ids in runs:
                        for lo in range(0, len(ids), cap):
                            groups.append((base, ids[lo : lo + cap]))
                    while len(groups) % max(chunk_multiple, 1):
                        groups.append((0, []))
                    n_gt_eff = (grange[1] - grange[0] + 1) if grange else 0
                    plans.append((ti, tc, tm, wcls, groups, cap, grange, porder, row_off))
                    onehot_bytes += (
                        (wcls + n_gt_eff * CAM_TILE) * len(groups) * Tb * cap * Pc * itemsize
                    )
                row_off += Pb
                continue

            window = CAM_TILE
            raw_bases = np.zeros(n_chunks, np.int64)
            has_obs = np.zeros(n_chunks, bool)
            for gi in range(n_chunks):
                sl = slice(gi * Pc, (gi + 1) * Pc)
                cams = tc[sl][tm[sl] > 0]
                cams = cams[cams < glob_start]  # globals ride the shared tiles
                if cams.size == 0:
                    continue
                has_obs[gi] = True
                base = (int(cams.min()) // CAM_TILE) * CAM_TILE
                cam_span = int(cams.max()) - base + 1
                raw_bases[gi] = base
                window = max(window, _pad_up(cam_span, CAM_TILE))
            window = min(window, c_pad)

            # Clamp bases inside c_pad; empty (padding) micro-chunks take the
            # previous chunk's base so they merge into its group.
            bases = np.minimum(raw_bases, c_pad - window)
            prev = 0
            for gi in range(n_chunks):
                if has_obs[gi]:
                    prev = int(bases[gi])
                else:
                    bases[gi] = prev

            runs = []
            for gi in range(n_chunks):
                if runs and bases[gi] == runs[-1][0]:
                    runs[-1][1] += 1
                else:
                    runs.append([int(bases[gi]), 1])
            cap = _choose_cap(
                [r for _, r in runs], min_groups=max(chunk_multiple, 1)
            )
            groups = []  # (base, [micro-chunk indices])
            gi = 0
            for base, r in runs:
                for lo in range(0, r, cap):
                    groups.append((base, list(range(gi + lo, gi + min(lo + cap, r)))))
                gi += r
            while len(groups) % max(chunk_multiple, 1):
                groups.append((0, []))

            plans.append((
                ti, tc, tm, window, groups, cap,
                (0, n_gt - 1) if n_gt else None, None, row_off,
            ))
            row_off += Pb
            onehot_bytes += (
                (window + n_gt * CAM_TILE)
                * len(groups) * Tb * cap * Pc * itemsize
            )

    if onehot_bytes > max_onehot_bytes:
        raise ValueError(
            f"windowed one-hots would be {onehot_bytes / 1e9:.2f} GB "
            f"(windows={[p[3] for p in plans]}); data has too little camera "
            "locality at this scale"
        )

    g_pts = g.points3d.numpy()
    g_rows = g.point_rows.numpy()

    def t_(x):
        return torch.as_tensor(x, device=device)

    buckets = []
    offsets = []
    pts_chunks = []
    rows_chunks = []
    off = 0
    for ti, tc, tm, window, groups, cap, grange, porder, g_off in plans:
        with span("pack.fill"):
            g_lo = grange[0] if grange else 0
            n_gt_eff = (grange[1] - grange[0] + 1) if grange else 0
            g_base = glob_start + g_lo * CAM_TILE
            Pb, Tb = ti.shape
            B = len(groups)
            Pc_eff = cap * Pc
            n = Tb * Pc_eff
            uv_b = np.zeros((B, 2, Tb, Pc_eff), np_dtype)
            mask_b = np.zeros((B, Tb, Pc_eff), np_dtype)
            wcam_b = np.full((B, n), -1, np.int16)
            cam_base = np.zeros((B,), np.int32)
            sel = np.full((B, Pc_eff), -1, np.int64)  # g.points3d row per column
            for bi, (base, chunk_ids) in enumerate(groups):
                cam_base[bi] = base
                for j, gi in enumerate(chunk_ids):
                    sl = slice(gi * Pc, (gi + 1) * Pc)
                    ti_g = ti[sl].T  # (Tb, Pc)
                    tc_g = tc[sl].T
                    tm_g = tm[sl].T
                    col0 = j * Pc
                    uv_b[bi, :, :, col0 : col0 + Pc] = np.transpose(
                        uv_flat[ti_g], (2, 0, 1)
                    )
                    mask_b[bi, :, col0 : col0 + Pc] = tm_g
                    tt_i, pp = np.nonzero(tm_g > 0)
                    cols = tt_i * Pc_eff + col0 + pp
                    tcv = tc_g[tm_g > 0]
                    # Local cameras index their chunk window; globals index the
                    # shared tail rows [window, window + n_gt_eff*128).
                    wcam_b[bi, cols] = np.where(
                        tcv < glob_start, tcv - base, window + (tcv - g_base),
                    )
                    rows_g = np.arange(gi * Pc, (gi + 1) * Pc)
                    if porder is not None:  # the bucket's points were re-sorted
                        rows_g = porder[rows_g]
                    sel[bi, col0 : col0 + Pc] = g_off + rows_g
            total_rows = window + n_gt_eff * CAM_TILE
            sel = sel.reshape(-1)
            valid = sel >= 0
            pts_k = np.zeros((sel.size, 3), g_pts.dtype)
            pts_k[valid] = g_pts[sel[valid]]
            rows_k = np.full(sel.size, -1, np.int32)
            rows_k[valid] = g_rows[sel[valid]]
        with span("pack.to_device"):
            wcam = t_(wcam_b)
            buckets.append(
                WTTBucket(
                    uv=t_(uv_b),
                    mask=t_(mask_b),
                    cam_base=t_(cam_base),
                    wcam=wcam,
                    onehot=None if defer_onehot else _expand_wcam(wcam, total_rows, oh_dtype),
                    window=total_rows,
                    global_tiles=n_gt_eff,
                    global_tile0=g_tile0 + g_lo,
                )
            )
        pts_chunks.append(pts_k)
        rows_chunks.append(rows_k)
        offsets.append(off)
        off += sel.size

    windows = [b.window for b in buckets]
    with span("pack.to_device"):
        return BAWTTProblem(
            cameras=g.cameras.to(device),
            points3d=t_(np.concatenate(pts_chunks, axis=0)),
            buckets=tuple(buckets),
            avg_cam_width=g.avg_cam_width.to(device),
            point_rows=t_(np.concatenate(rows_chunks, axis=0)),
            cam_rows=t_(cam_rows.astype(np.int32)) if cam_rows is not None else None,
            n_real_points=g.n_real_points,
            bucket_offsets=tuple(offsets),
            window=max(windows) if windows else CAM_TILE,
            c_pad=c_pad,
        )
