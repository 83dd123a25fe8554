"""BAL ("Bundle Adjustment in the Large") problem file I/O.

Counterpart of ``tpu3drecon/io/bal.py``.  A BAL file is text:

    <num_cameras> <num_points> <num_observations>
    <camera_index> <point_index> <x> <y>     x num_observations
    <9 camera params per camera: rodrigues(3), t(3), f, k1, k2>
    <3 coords per point>

BAL cameras look down -z with centered pixel coordinates, so the loader
conjugates the extrinsics with diag(1, -1, -1) and negates v into the
solver's +z pinhole convention (the transformation Ceres' examples apply).
The rotation conversions stay in host float64 numpy; the tensors are built
last, with ``dtype`` and ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.io.colmap import native
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams, ProblemMeta, bucket_size


def read_bal(
    path: str, use_native: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a BAL file -> (cam_idx, pt_idx, uv, camera_params(9), points).

    Tokens go through the C++ tokenizer (``bal_parse_doubles``,
    ``std::from_chars``) when its library builds, through Python's
    ``split`` otherwise; ``native.COUNTS["bal"]`` records which one ran.
    ``.bz2`` files are decompressed first.
    """
    opener = open
    if path.endswith(".bz2"):
        import bz2

        opener = bz2.open
    with opener(path, "rb") as f:
        data = f.read()

    head = data[:256].split()
    if len(head) < 3:
        raise ValueError(f"corrupt BAL file {path!r}: missing header")
    try:
        n_cams, n_pts, n_obs = (int(t) for t in head[:3])
    except ValueError as e:
        raise ValueError(f"corrupt BAL file {path!r}: bad header") from e
    expected = 3 + n_obs * 4 + n_cams * 9 + n_pts * 3

    rest = None
    if use_native:
        try:
            all_vals = native.parse_bal_tokens(data, expected)
        except ValueError as e:
            raise ValueError(
                f"corrupt BAL file {path!r}: header promises {n_cams} cams / "
                f"{n_pts} pts / {n_obs} obs = {expected} tokens ({e})"
            ) from e
        if all_vals is not None:
            rest = all_vals[3:]
    if rest is None:
        native.COUNTS.count("numpy", "bal")
        tokens = data.split()
        if len(tokens) < expected:
            raise ValueError(
                f"corrupt BAL file {path!r}: header promises {n_cams} cams / "
                f"{n_pts} pts / {n_obs} obs = {expected} tokens, found {len(tokens)}"
            )
        rest = np.array(tokens[3:expected], dtype=np.float64)
    obs_block = rest[: n_obs * 4].reshape(n_obs, 4)
    cam_idx = obs_block[:, 0].astype(np.int32)
    pt_idx = obs_block[:, 1].astype(np.int32)
    uv = obs_block[:, 2:4]
    off = n_obs * 4
    cam_params = rest[off : off + n_cams * 9].reshape(n_cams, 9)
    off += n_cams * 9
    points = rest[off : off + n_pts * 3].reshape(n_pts, 3)
    return cam_idx, pt_idx, uv, cam_params, points


def write_bal(
    path: str,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    cam_params: np.ndarray,
    points: np.ndarray,
) -> None:
    with open(path, "w") as f:
        f.write(f"{len(cam_params)} {len(points)} {len(cam_idx)}\n")
        for k in range(len(cam_idx)):
            f.write(
                f"{int(cam_idx[k])} {int(pt_idx[k])} "
                f"{float(uv[k, 0])!r} {float(uv[k, 1])!r}\n"
            )
        for row in cam_params:
            for v in row:
                f.write(f"{float(v)!r}\n")
        for p in points:
            for v in p:
                f.write(f"{float(v)!r}\n")


def _host(x, dtype=None) -> np.ndarray:
    """numpy copy of a tensor (any device) or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def export_bal(
    path: str,
    problem,
    cameras=None,
    points3d=None,
) -> None:
    """Write a (possibly solved) BAProblem back to a BAL file.

    Inverse of ``ba_problem_from_bal``: extrinsics are conjugated back with
    diag(1, -1, -1), observations get the v sign restored, distortion and
    focal ride out of CameraParams.
    """
    cams = cameras if cameras is not None else problem.cameras
    pts = _host(points3d if points3d is not None else problem.points3d)
    flip = np.diag([1.0, -1.0, -1.0])
    rmats_bal = np.einsum("ij,cjk->cik", flip, _host(cams.rmats, np.float64))
    tvecs_bal = _host(cams.tvecs, np.float64) @ flip.T
    rvecs = _matrix_to_rodrigues_np(rmats_bal)
    cam_params = np.concatenate(
        [
            rvecs,
            tvecs_bal,
            _host(cams.fx_fy, np.float64)[:, :1],
            _host(cams.dist, np.float64),
        ],
        axis=1,
    )
    mask = _host(problem.mask) > 0
    uv = _host(problem.uv, np.float64)[mask].copy()
    uv[:, 1] = -uv[:, 1]
    write_bal(
        path,
        _host(problem.cam_idx)[mask],
        _host(problem.pt_idx)[mask],
        uv,
        cam_params,
        pts,
    )


def _rodrigues_to_matrix_np(rvecs: np.ndarray) -> np.ndarray:
    """Batched axis-angle -> rotation matrix in float64 numpy (a float32
    device conversion costs ~1e-4 rad per round trip)."""
    rvecs = np.asarray(rvecs, np.float64)
    theta = np.linalg.norm(rvecs, axis=1, keepdims=True)
    safe = np.where(theta < 1e-12, 1.0, theta)
    k = rvecs / safe
    K = np.zeros((len(rvecs), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    out = eye + st * K + (1.0 - ct) * (K @ K)
    return np.where((theta < 1e-12)[..., None], eye, out)


def _matrix_to_rodrigues_np(rmats: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> axis-angle in float64 numpy, via
    quaternions (Shepperd's method): robust at every angle, rotations near
    pi included (BAL rigs facing -z)."""
    rmats = np.asarray(rmats, np.float64)
    n = len(rmats)
    q = np.zeros((n, 4))  # (w, x, y, z)
    t = np.trace(rmats, axis1=1, axis2=2)
    for i in range(n):
        R = rmats[i]
        if t[i] > 0:
            s_ = np.sqrt(t[i] + 1.0) * 2.0
            q[i] = [0.25 * s_, (R[2, 1] - R[1, 2]) / s_,
                    (R[0, 2] - R[2, 0]) / s_, (R[1, 0] - R[0, 1]) / s_]
        else:
            j = int(np.argmax(np.diag(R)))
            k, l = (j + 1) % 3, (j + 2) % 3
            s_ = np.sqrt(max(R[j, j] - R[k, k] - R[l, l] + 1.0, 0.0)) * 2.0
            xyz = np.zeros(3)
            xyz[j] = 0.25 * s_
            xyz[k] = (R[k, j] + R[j, k]) / s_
            xyz[l] = (R[l, j] + R[j, l]) / s_
            q[i] = [(R[l, k] - R[k, l]) / s_, *xyz]
    # Normalize and take the w >= 0 hemisphere.
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1.0
    vec_norm = np.linalg.norm(q[:, 1:], axis=1)
    theta = 2.0 * np.arctan2(vec_norm, q[:, 0])
    safe = np.where(vec_norm < 1e-12, 1.0, vec_norm)
    axis = q[:, 1:] / safe[:, None]
    return np.where(
        (vec_norm < 1e-12)[:, None], 2.0 * q[:, 1:], axis * theta[:, None]
    )


def ba_problem_from_bal(
    path: str,
    dtype: torch.dtype = torch.float32,
    pad_multiple: int = 1024,
    device=None,
) -> Tuple[BAProblem, ProblemMeta]:
    """Load a BAL file as a packed BAProblem on ``device`` (default: the
    CUDA card, see ``tpu3drecon_torch.device``).

    BAL projects p = -f * [x/z, y/z] in a frame looking down -z.
    Conjugating the extrinsics with D = diag(1, -1, -1) maps u exactly but
    flips v, so the v observations are negated on load.  Radial
    coefficients (k1, k2) on normalized coordinates are carried per camera.
    """
    device = resolve_device(device)
    dtype = dtype or torch.float32
    cam_idx, pt_idx, uv, cam_params, points = read_bal(path)
    n_cams = len(cam_params)

    rmats = _rodrigues_to_matrix_np(cam_params[:, :3])
    tvecs = cam_params[:, 3:6]
    flip = np.diag([1.0, -1.0, -1.0])
    rmats = np.einsum("ij,cjk->cik", flip, rmats)
    tvecs = tvecs @ flip.T
    focals = cam_params[:, 6]
    uv = uv.copy()
    uv[:, 1] = -uv[:, 1]  # v' = -v_bal

    n_obs = len(cam_idx)
    n_pad = bucket_size(max(n_obs, 1), pad_multiple)
    pad = n_pad - n_obs
    width = 2.0 * float(np.abs(uv).max() or 1.0)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    problem = BAProblem(
        cameras=CameraParams(
            rmats=t(rmats),
            tvecs=t(tvecs),
            fx_fy=t(np.stack([focals, focals], axis=1)),
            cx_cy_skew=torch.zeros((n_cams, 3), dtype=dtype, device=device),
            dist=t(cam_params[:, 7:9]),  # (k1, k2)
        ),
        points3d=t(points),
        cam_idx=t(np.concatenate([cam_idx, np.zeros(pad, np.int32)]), torch.int32),
        pt_idx=t(np.concatenate([pt_idx, np.zeros(pad, np.int32)]), torch.int32),
        uv=t(np.concatenate([uv, np.zeros((pad, 2))])),
        mask=t(np.concatenate([np.ones(n_obs), np.zeros(pad)])),
        avg_cam_width=t(width),
    )
    meta = ProblemMeta(
        camera_ids=np.arange(n_cams),
        point_ids=np.arange(len(points)),
        widths=np.full(n_cams, width),
        n_real_obs=n_obs,
        distortion=cam_params[:, 7:9],
    )
    return problem, meta
