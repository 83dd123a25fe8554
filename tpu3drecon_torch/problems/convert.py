"""Carry problems and parameters across from the JAX package.

The "weights" of a bundle-adjustment system are the packed problem and its
camera/point parameters.  These functions take the fields of the JAX
package's ``CameraParams`` / ``BAProblem`` / ``BAGridProblem`` /
``BAGridBucketedProblem`` / ``BAWTTProblem`` / ``BATTProblem`` as numpy
arrays and static ints (a dict per dataclass, nested for ``cameras`` and
``buckets``) and build the port's objects on ``device`` (default: the CUDA card, see
``tpu3drecon_torch.device``), so the same problem can be handed to both
packages.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.problems.grid import (
    BAGridBucketedProblem,
    BAGridProblem,
    TrackBucket,
)
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams
from tpu3drecon_torch.problems.tt import BATTProblem, TTBucket
from tpu3drecon_torch.problems.wtt import BAWTTProblem, WTTBucket


def _t(x, device):
    return None if x is None else torch.as_tensor(np.array(x), device=device)


def _arrays(d: dict, keys, device) -> dict:
    return {k: _t(d[k], device) for k in keys}


def camera_params_from_numpy(d: dict, device=None) -> CameraParams:
    """``CameraParams`` from the arrays ``rmats``, ``tvecs``, ``fx_fy``,
    ``cx_cy_skew``, ``dist``."""
    device = resolve_device(device)
    return CameraParams(
        **_arrays(d, ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist"), device)
    )


def ba_problem_from_numpy(d: dict, device=None) -> BAProblem:
    """``BAProblem`` from ``cameras`` (a dict) and the arrays ``points3d``,
    ``cam_idx``, ``pt_idx``, ``uv``, ``mask``, ``avg_cam_width``."""
    device = resolve_device(device)
    return BAProblem(
        cameras=camera_params_from_numpy(d["cameras"], device),
        **_arrays(
            d, ("points3d", "cam_idx", "pt_idx", "uv", "mask", "avg_cam_width"),
            device,
        ),
    )


def grid_problem_from_numpy(d: dict, device=None) -> BAGridProblem:
    """``BAGridProblem`` from ``cameras`` (a dict) and the arrays
    ``points3d``, ``uv``, ``pt_idx``, ``mask``, ``track_idx``,
    ``track_cam``, ``track_mask``, ``avg_cam_width``."""
    device = resolve_device(device)
    return BAGridProblem(
        cameras=camera_params_from_numpy(d["cameras"], device),
        **_arrays(
            d,
            ("points3d", "uv", "pt_idx", "mask", "track_idx", "track_cam",
             "track_mask", "avg_cam_width"),
            device,
        ),
    )


def grid_bucketed_problem_from_numpy(d: dict, device=None) -> BAGridBucketedProblem:
    """``BAGridBucketedProblem`` from ``cameras`` (a dict), ``buckets`` (a
    list of dicts with the arrays ``track_idx``, ``track_cam``,
    ``track_mask``), the arrays ``points3d``, ``uv``, ``pt_idx``, ``mask``,
    ``avg_cam_width``, ``point_rows`` and the static int ``n_real_points``."""
    device = resolve_device(device)
    return BAGridBucketedProblem(
        cameras=camera_params_from_numpy(d["cameras"], device),
        buckets=tuple(
            TrackBucket(**_arrays(b, ("track_idx", "track_cam", "track_mask"), device))
            for b in d["buckets"]
        ),
        n_real_points=int(d["n_real_points"]),
        **_arrays(
            d, ("points3d", "uv", "pt_idx", "mask", "avg_cam_width", "point_rows"),
            device,
        ),
    )


def wtt_problem_from_numpy(d: dict, device=None) -> BAWTTProblem:
    """``BAWTTProblem`` from ``cameras`` (a dict), ``buckets`` (a list of
    dicts with the arrays ``uv``, ``mask``, ``cam_base``, ``wcam``, the
    dense ``onehot`` or None, and the ints ``window``, ``global_tiles``,
    ``global_tile0``), the arrays ``points3d``, ``avg_cam_width``,
    ``point_rows``, ``cam_rows`` (or None) and the static ints
    ``n_real_points``, ``bucket_offsets``, ``window``, ``c_pad``."""
    device = resolve_device(device)
    buckets = []
    for b in d["buckets"]:
        wcam = np.asarray(b["wcam"])
        if wcam.dtype != np.int16:
            raise ValueError(f"wcam must be int16, got {wcam.dtype}")
        buckets.append(WTTBucket(
            uv=_t(b["uv"], device),
            mask=_t(b["mask"], device),
            cam_base=_t(b["cam_base"], device),
            wcam=_t(wcam, device),
            onehot=_t(b.get("onehot"), device),
            window=int(b["window"]),
            global_tiles=int(b["global_tiles"]),
            global_tile0=int(b["global_tile0"]),
        ))
    return BAWTTProblem(
        cameras=camera_params_from_numpy(d["cameras"], device),
        points3d=_t(d["points3d"], device),
        buckets=tuple(buckets),
        avg_cam_width=_t(d["avg_cam_width"], device),
        point_rows=_t(d["point_rows"], device),
        cam_rows=_t(d.get("cam_rows"), device),
        n_real_points=int(d["n_real_points"]),
        bucket_offsets=tuple(int(o) for o in d["bucket_offsets"]),
        window=int(d["window"]),
        c_pad=int(d["c_pad"]),
    )


def tt_problem_from_numpy(d: dict, device=None) -> BATTProblem:
    """``BATTProblem`` from ``cameras`` (a dict), ``buckets`` (a list of dicts
    with the arrays ``uv``, ``mask``, ``cam_ids``; the JAX one-hot
    ``onehot`` is dropped: the port's kernels read ``cam_ids``), the arrays
    ``points3d``, ``avg_cam_width``, ``point_rows`` and the static ints
    ``n_real_points``, ``bucket_offsets``."""
    device = resolve_device(device)
    buckets = []
    for b in d["buckets"]:
        cam_ids = np.asarray(b["cam_ids"])
        if cam_ids.dtype != np.int32:
            raise ValueError(f"cam_ids must be int32, got {cam_ids.dtype}")
        buckets.append(TTBucket(uv=_t(b["uv"], device), mask=_t(b["mask"], device),
                                cam_ids=_t(cam_ids, device)))
    return BATTProblem(
        cameras=camera_params_from_numpy(d["cameras"], device),
        points3d=_t(d["points3d"], device),
        buckets=tuple(buckets),
        avg_cam_width=_t(d["avg_cam_width"], device),
        point_rows=_t(d["point_rows"], device),
        n_real_points=int(d["n_real_points"]),
        bucket_offsets=tuple(int(o) for o in d["bucket_offsets"]),
    )
