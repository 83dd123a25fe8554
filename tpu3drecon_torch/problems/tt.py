"""Dense track-table ("tt") BA problem.

Counterpart of ``tpu3drecon/problems/tt.py:50-206``.  Every observation
lives in one slot of a track-length-bucketed (Tb, Pb) table, point-major
and plane-major (component axes first, the slot axes last), so per-point
sums are dense over the track axis.  Each slot stores its camera in
``cam_ids``; the kernels of ``ops/tt_linearize.py`` read it directly.  The
JAX layout's dense (C, Tb*Pb) one-hot, which exists because a TPU turns
gathers into MXU matmuls, is never built.  The size guard still reckons it
(at int8, as the JAX packer does), so both packers accept and refuse the
same problems.

Packing is host-side numpy through ``grid_bucketed_from_flat``, as in JAX,
so both packages produce bit-equal arrays; ``device`` places the result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams, _to

# Bytes per dense one-hot entry in the JAX layout (int8).
_ONEHOT_ITEMSIZE = 1


@dataclass(frozen=True)
class TTBucket:
    """One track-length bucket, plane-major (slot axes last); slot (t, p)
    flattens to n = t * Pb + p."""

    uv: torch.Tensor  # (2, Tb, Pb) observed pixels
    mask: torch.Tensor  # (Tb, Pb) 1.0 = real observation
    cam_ids: torch.Tensor  # (Tb, Pb) int32 (0 on padding)

    def to(self, device) -> "TTBucket":
        return _to(self, device)


@dataclass(frozen=True)
class BATTProblem:
    """BA problem in bucketed track-table layout.

    Points are permuted into bucket-major order as in
    ``BAGridBucketedProblem`` (``point_rows`` maps back, see
    ``problems.grid.unpermute_points``); ``bucket_offsets[b]`` is the first
    row of bucket b's points in ``points3d``.
    """

    cameras: CameraParams
    points3d: torch.Tensor  # (P_total, 3) permuted + padded
    buckets: Tuple[TTBucket, ...]
    avg_cam_width: torch.Tensor  # ()
    point_rows: torch.Tensor = None  # (P_total,) original row or -1
    n_real_points: int = 0
    bucket_offsets: Tuple[int, ...] = ()

    @property
    def n_cameras(self) -> int:
        return self.cameras.rmats.shape[0]

    def to(self, device) -> "BATTProblem":
        return _to(self, device)


def tt_from_flat(
    problem: BAProblem,
    bounds: Tuple[int, ...] = (2, 3, 4, 8),
    point_block: int = 512,
    max_onehot_bytes: int = 2 << 30,
    onehot_dtype=None,
    device=None,
) -> BATTProblem:
    """Repack a flat BAProblem into the track-table layout on ``device``
    (default: the problem's device).

    Raises ``ValueError`` when the JAX layout's one-hot matrices (int8)
    would exceed ``max_onehot_bytes``.  ``onehot_dtype`` selects the JAX
    layout's one-hot encoding; the port stores none, so any value but None
    (int8, the default) raises ``NotImplementedError``.
    """
    if onehot_dtype is not None:
        raise NotImplementedError(
            f"onehot_dtype={onehot_dtype!r}: the port stores no one-hot (the "
            "kernels read cam_ids), so the int8/bit-packed encodings are not "
            "ported (ROADMAP A.9)"
        )
    if device is None:
        device = problem.points3d.device
    g = grid_bucketed_from_flat(problem, bounds=bounds, point_block=point_block,
                                device="cpu")
    guv = g.uv.numpy()
    C, K = guv.shape[:2]
    uv_flat = guv.reshape(C * K, 2)

    total_slots = sum(b.track_mask.numel() for b in g.buckets)
    onehot_bytes = C * total_slots * _ONEHOT_ITEMSIZE
    if onehot_bytes > max_onehot_bytes:
        raise ValueError(
            f"track-table one-hot would be {onehot_bytes / 1e9:.2f} GB "
            f"(C={C}, slots={total_slots}); use the grid/pallas engines for "
            "this camera count"
        )

    def t_(x):
        return torch.as_tensor(x, device=device)

    buckets, offsets = [], []
    off = 0
    for b in g.buckets:
        ti = b.track_idx.numpy()  # (Pb, Tb)
        pb = ti.shape[0]
        uv_planes = np.ascontiguousarray(np.transpose(uv_flat[ti], (2, 1, 0)))
        buckets.append(TTBucket(
            uv=t_(uv_planes),
            mask=t_(np.ascontiguousarray(b.track_mask.numpy().T)),
            cam_ids=t_(np.ascontiguousarray(b.track_cam.numpy().T).astype(np.int32)),
        ))
        offsets.append(off)
        off += pb

    return BATTProblem(
        cameras=g.cameras.to(device),
        points3d=g.points3d.to(device),
        buckets=tuple(buckets),
        avg_cam_width=g.avg_cam_width.to(device),
        point_rows=g.point_rows.to(device),
        n_real_points=g.n_real_points,
        bucket_offsets=tuple(offsets),
    )
