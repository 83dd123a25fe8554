"""Bucketed grid layout: the intermediate the windowed track table packs from.

Counterpart of ``tpu3drecon/problems/grid.py:40-82, 181-347``.
Observations sit on a dense (C, K) camera grid (camera-major, padded to K
per camera with masks); points are permuted into track-length buckets, and
each bucket's (Pb, T) track table indexes its points' observations in the
flattened C*K grid.  Host-side numpy, then tensors on ``device``.

Padding invariants: padded grid cells carry mask 0; padded track entries
point at flat index 0 with their own 0 in ``track_mask``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from tpu3drecon_torch.problems.packing import BAProblem, CameraParams, bucket_size


@dataclass(frozen=True)
class TrackBucket:
    """One track-length bucket: points whose tracks fit in T slots."""

    track_idx: torch.Tensor  # (Pb, T) int32 into flat C*K
    track_cam: torch.Tensor  # (Pb, T) int32
    track_mask: torch.Tensor  # (Pb, T)


@dataclass(frozen=True)
class BAGridBucketedProblem:
    """Grid-layout BA problem with track-length-bucketed point tables.

    Points are PERMUTED so same-bucket points are contiguous;
    ``point_rows`` maps permuted rows back to original rows (-1 = padding).
    """

    cameras: CameraParams
    points3d: torch.Tensor  # (P_pad, 3) permuted + padded
    uv: torch.Tensor  # (C, K, 2)
    pt_idx: torch.Tensor  # (C, K) int32 into permuted points
    mask: torch.Tensor  # (C, K)
    buckets: Tuple[TrackBucket, ...]
    avg_cam_width: torch.Tensor  # ()
    point_rows: torch.Tensor = None
    n_real_points: int = 0

    @property
    def n_cameras(self) -> int:
        return self.uv.shape[0]


def _grid_from_flat_np(problem: BAProblem, obs_pad_multiple: int = 128,
                       track_pad_multiple: int = 8):
    """The plain (C, K) grid and (P, T) track table as numpy arrays
    (``tpu3drecon.problems.grid.grid_from_flat``)."""
    cam_idx = problem.cam_idx.cpu().numpy()
    pt_idx = problem.pt_idx.cpu().numpy()
    uv = problem.uv.cpu().numpy()
    mask = problem.mask.cpu().numpy()
    real = mask > 0
    cam_idx, pt_idx, uv = cam_idx[real], pt_idx[real], uv[real]

    C = problem.n_cameras
    P = problem.n_points
    counts = np.bincount(cam_idx, minlength=C)
    K = bucket_size(max(int(counts.max()), 1), obs_pad_multiple)

    order = np.argsort(cam_idx, kind="stable")
    cam_sorted = cam_idx[order]
    pt_sorted = pt_idx[order]
    uv_sorted = uv[order]
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    guv = np.zeros((C, K, 2), uv.dtype)
    gpt = np.zeros((C, K), np.int32)
    gmask = np.zeros((C, K), uv.dtype)
    local = np.arange(len(cam_sorted)) - starts[cam_sorted]
    guv[cam_sorted, local] = uv_sorted
    gpt[cam_sorted, local] = pt_sorted
    gmask[cam_sorted, local] = 1.0

    flat_of_sorted = cam_sorted.astype(np.int64) * K + local
    porder = np.argsort(pt_sorted, kind="stable")
    p_of = pt_sorted[porder]
    flat_of = flat_of_sorted[porder]
    pcounts = np.bincount(p_of, minlength=P)
    T = bucket_size(max(int(pcounts.max()), 1), track_pad_multiple)
    pstarts = np.zeros(P + 1, np.int64)
    np.cumsum(pcounts, out=pstarts[1:])
    plocal = np.arange(len(p_of)) - pstarts[p_of]
    tidx = np.zeros((P, T), np.int32)
    tcam = np.zeros((P, T), np.int32)
    tmask = np.zeros((P, T), uv.dtype)
    tidx[p_of, plocal] = flat_of.astype(np.int32)
    tcam[p_of, plocal] = cam_sorted[porder].astype(np.int32)
    tmask[p_of, plocal] = 1.0
    return guv, gpt, gmask, tidx, tcam, tmask


def grid_bucketed_from_flat(
    problem: BAProblem,
    obs_pad_multiple: int = 128,
    bounds: Tuple[int, ...] = (2, 3, 4, 8),
    point_block: int = 512,
    small_track: Optional[int] = None,
    order_points_by_cam: bool = False,
    device=None,
) -> BAGridBucketedProblem:
    """Repack a flat BAProblem into the bucketed grid layout on ``device``
    (default: the problem's device).

    ``bounds = (b1, b2, ...)`` splits points by track length into buckets
    (len <= b1), (b1 < len <= b2), ..., (> b_last, T = max length rounded
    to 4); each bucket's point count pads to ``point_block``.
    ``order_points_by_cam`` sorts each bucket's points by their minimum
    observing camera (stable), which gives consecutive point chunks the
    camera locality the windowed track table exploits.
    """
    if device is None:
        device = problem.points3d.device
    if small_track is not None:
        bounds = (small_track,)
    guv, gpt, gmask, tidx, tcam, tmask = _grid_from_flat_np(
        problem, obs_pad_multiple=obs_pad_multiple
    )
    points = problem.points3d.cpu().numpy()
    P, T = tidx.shape

    lengths = tmask.sum(axis=1).astype(np.int64)
    max_len = max(int(lengths.max()), 1)
    uppers = [b for b in sorted(bounds) if b < max_len]
    uppers.append(bucket_size(max_len, 4))
    row_groups = []
    lo = 0
    for t in uppers:
        sel = np.nonzero((lengths > lo) & (lengths <= t))[0]
        lo = t
        row_groups.append((sel, max(t, 1)))
    # Unobserved (length-0) points join the first group so every point
    # keeps a bucket row (unpermute_points requires it).
    zero_rows = np.nonzero(lengths == 0)[0]
    if len(zero_rows):
        sel0, t0 = row_groups[0]
        row_groups[0] = (np.sort(np.concatenate([sel0, zero_rows])), t0)

    if order_points_by_cam:
        min_cam = np.where(tmask > 0, tcam, np.iinfo(np.int32).max).min(axis=1)
        row_groups = [
            (rows[np.argsort(min_cam[rows], kind="stable")], t)
            for rows, t in row_groups
        ]

    def pad_to(n, m):
        return ((n + m - 1) // m) * m if n else 0

    offsets, kept_groups = [], []
    off = 0
    for rows, t in row_groups:
        if not len(rows):
            continue
        p_pad = pad_to(len(rows), point_block)
        offsets.append(off)
        kept_groups.append((rows, p_pad, t))
        off += p_pad

    p_total = off
    new_points = np.zeros((p_total, 3), points.dtype)
    point_rows = np.full(p_total, -1, np.int64)
    old_to_new = np.zeros(P, np.int64)
    for (rows, p_pad, _t), start in zip(kept_groups, offsets):
        new_points[start : start + len(rows)] = points[rows]
        point_rows[start : start + len(rows)] = rows
        old_to_new[rows] = start + np.arange(len(rows))
    new_pt_idx = old_to_new[gpt].astype(np.int32)

    # Order each camera row's observations by final point index (padding
    # cells last) — semantically neutral, deterministic access order.
    C, K = gmask.shape
    sort_key = np.where(gmask > 0, new_pt_idx, np.iinfo(np.int32).max)
    order = np.argsort(sort_key, axis=1, kind="stable")
    rowsel = np.arange(C)[:, None]
    guv = guv[rowsel, order]
    gmask = gmask[rowsel, order]
    new_pt_idx = new_pt_idx[rowsel, order]

    real = gmask.reshape(-1) > 0
    flat_pos = np.nonzero(real)[0].astype(np.int64)
    pids_new = new_pt_idx.reshape(-1)[real].astype(np.int64)
    cams_of = (flat_pos // K).astype(np.int32)
    porder = np.argsort(pids_new, kind="stable")
    p_of = pids_new[porder]
    flat_of = flat_pos[porder]
    cam_of = cams_of[porder]
    counts = np.bincount(p_of, minlength=p_total)
    pstarts = np.zeros(p_total + 1, np.int64)
    np.cumsum(counts, out=pstarts[1:])
    plocal = (np.arange(len(p_of)) - pstarts[p_of]).astype(np.int64)

    def t_(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    dtype = problem.uv.dtype
    buckets = []
    for (rows, p_pad, t), start in zip(kept_groups, offsets):
        bi = np.zeros((p_pad, t), np.int32)
        bc = np.zeros((p_pad, t), np.int32)
        bm = np.zeros((p_pad, t), tmask.dtype)
        in_bucket = (p_of >= start) & (p_of < start + p_pad)
        pr = p_of[in_bucket] - start
        pl = plocal[in_bucket]
        bi[pr, pl] = flat_of[in_bucket].astype(np.int32)
        bc[pr, pl] = cam_of[in_bucket]
        bm[pr, pl] = 1.0
        buckets.append(TrackBucket(t_(bi), t_(bc), t_(bm)))

    return BAGridBucketedProblem(
        cameras=problem.cameras.to(device),
        points3d=t_(new_points, dtype),
        uv=t_(guv, dtype),
        pt_idx=t_(new_pt_idx),
        mask=t_(gmask, dtype),
        buckets=tuple(buckets),
        avg_cam_width=problem.avg_cam_width.to(device),
        point_rows=t_(point_rows.astype(np.int32)),
        n_real_points=P,
    )


def unpermute_points(solved_points: torch.Tensor, problem) -> torch.Tensor:
    """Map bucketed-solver point output back to the original point order.

    Scatter-ADD with zeroed padding rows: every real row is written exactly
    once, padding rows add 0 to row 0."""
    rows = problem.point_rows.to(solved_points.device).long()
    out = torch.zeros(
        (problem.n_real_points, solved_points.shape[1]),
        dtype=solved_points.dtype, device=solved_points.device,
    )
    valid = rows >= 0
    safe_rows = torch.where(valid, rows, torch.zeros_like(rows))
    return out.index_add_(0, safe_rows, solved_points * valid[:, None])
