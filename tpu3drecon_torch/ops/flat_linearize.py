"""The flat engine's linearization: per-observation Jacobian blocks and their
segment sums U, V, g_c, g_p, the coupling blocks W, and the Schur-Jacobi
coupling sum W V^-1 W^T per camera.

Replaces no TPU kernel: the JAX flat engine leaves this to XLA
(``tpu3drecon/solvers/schur.py``, ``tpu3drecon/ops/jacobians.py``).  The
plain version is the port's first code path: ``gather_obs_blocks``
(batched 3x3 products of gathered rows), then ``index_add_`` segment sums
of per-observation temporaries (J_c^T J_c (N, 8, 8), W V^-1 W^T (N, 8, 8),
...), some 1,500 launches per LM iteration at Final-13682's 29.0M
observations.

CUDA kernels (``csrc/flat_kernels.cu``): ``flat_lin_kernel``, one pass
over the observations that forms r, J_c and J_p in registers (the
operation order of ``obs_blocks``), writes W and reduces U and g_c per
camera and V and g_p per point; ``flat_coupling_kernel``, one pass that
recomputes J from the observation (20 B read an observation, against 104 B
for W and the indices) and reduces W V^-1 W^T per camera.  Their byte
floors are ~3.6 GB and ~0.8 GB at Final-13682 in float32, 1.1 and 0.24 ms
at 3.35 TB/s (the coupling's operations take about as long); on an H100
they take 3.1 and 1.7 ms, of which the atomics below are ~0.9 and ~0.2
(``csrc/flat_kernels.cu``).  A warp holds 32 consecutive observations,
groups its lanes by camera, then by point (``__match_any_sync``), and
sends one atomic per distinct row and column, so the reduction adapts to
the observations' order: by point (BAL), the point sums and the few
cameras that see a run of points leave in a few atomics; by camera
(COLMAP), the camera sums do.  Summation order varies from run to run.

The kernels return the packed upper triangles; ``linearize`` returns the
full symmetric blocks of ``solvers/schur.py``'s ``NormalBlocks`` through a
cached index map (built on the card, no host copy), with its ``coupling``
bound to its own inputs.  CPU tensors run the plain version; CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpu3drecon_torch.geometry.losses import LOSS_CODES, RobustLoss
from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import check_inputs, check_shape, is_cuda_call
from tpu3drecon_torch.ops.jacobians import gather_obs_blocks
from tpu3drecon_torch.utils.timing import count

COUNTS = _build.LaunchCounter()  # flat_lin_kernel
COUPLING_COUNTS = _build.LaunchCounter()  # flat_coupling_kernel


class FlatSums(NamedTuple):
    """One linearization's undamped sums over this rank's observations."""

    u: torch.Tensor  # (C, 8, 8) sum J_c^T J_c
    v: torch.Tensor  # (P, 3, 3) sum J_p^T J_p
    w: torch.Tensor  # (N, 8, 3) per-observation J_c^T J_p
    g_cam: torch.Tensor  # (C, 8) sum J_c^T r
    g_pt: torch.Tensor  # (P, 3) sum J_p^T r
    # v_inv (P, 3, 3) -> (C, 8, 8) sum W V^-1[pt] W^T per camera, over the
    # same observations: the Schur-Jacobi coupling of this linearization.
    coupling: Callable[[torch.Tensor], torch.Tensor]


def segment_sum(per_obs: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    out = per_obs.new_zeros((num,) + per_obs.shape[1:])
    return out.index_add_(0, idx.long(), per_obs)


def segment_outer(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """sum_k a[k]^T b[k] accumulated per segment: (N,2,m),(N,2,n) -> (num,m,n)."""
    per_obs = a[:, 0, :, None] * b[:, 0, None, :] + a[:, 1, :, None] * b[:, 1, None, :]
    return segment_sum(per_obs, idx, num)


def segment_jt_r(j: torch.Tensor, r: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """sum_k J[k]^T r[k] per segment: (N,2,m),(N,2) -> (num,m)."""
    per_obs = j[:, 0] * r[:, 0, None] + j[:, 1] * r[:, 1, None]
    return segment_sum(per_obs, idx, num)


def flat_blocks(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx, pt_idx, uv, mask,
                inv_width, loss: RobustLoss, optimize_focal: bool, optimize_points: bool):
    """(r (N,2), J_c (N,2,8), J_p (N,2,3)) of the flat engine: the focal
    columns of J_c zeroed unless ``optimize_focal``, J_p unless
    ``optimize_points``."""
    blocks = gather_obs_blocks(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx,
                               pt_idx, uv, mask, inv_width, loss)
    r, jc, jp = blocks.residual, blocks.j_cam, blocks.j_pt
    if not optimize_focal:
        jc = torch.cat([jc[:, :, :6], torch.zeros_like(jc[:, :, 6:8])], dim=2)
    if not optimize_points:
        jp = jp * 0.0
    return r, jc, jp


def sums_of_blocks(r, jc, jp, cam_idx, pt_idx, n_cameras: int, n_points: int) -> FlatSums:
    """U, V, W and the gradients of per-observation blocks (segment sums)."""
    u = segment_outer(jc, jc, cam_idx, n_cameras)
    v = segment_outer(jp, jp, pt_idx, n_points)
    w = jc[:, 0, :, None] * jp[:, 0, None, :] + jc[:, 1, :, None] * jp[:, 1, None, :]
    g_cam = segment_jt_r(jc, r, cam_idx, n_cameras)
    g_pt = segment_jt_r(jp, r, pt_idx, n_points)
    return FlatSums(u=u, v=v, w=w, g_cam=g_cam, g_pt=g_pt,
                    coupling=lambda v_inv: coupling_of_w(w, v_inv, cam_idx, pt_idx, n_cameras))


def coupling_of_w(w, v_inv, cam_idx, pt_idx, n_cameras: int) -> torch.Tensor:
    """(C, 8, 8) sum W V^-1[pt] W^T per camera, from the per-observation W:
    the plain version of ``flat_coupling_kernel``."""
    COUPLING_COUNTS.plain += 1
    vg = v_inv[pt_idx.long()]
    wv = (
        w[..., 0, None] * vg[:, None, 0, :]
        + w[..., 1, None] * vg[:, None, 1, :]
        + w[..., 2, None] * vg[:, None, 2, :]
    )  # (N, 8, 3)
    g_obs = (
        wv[..., :, None, 0] * w[..., None, :, 0]
        + wv[..., :, None, 1] * w[..., None, :, 1]
        + wv[..., :, None, 2] * w[..., None, :, 2]
    )  # (N, 8, 8)
    return segment_sum(g_obs, cam_idx, n_cameras)


def linearize_plain(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx, pt_idx, uv,
                    mask, inv_width, n_cameras: int, n_points: int,
                    loss: RobustLoss = RobustLoss.TRIVIAL, optimize_focal: bool = True,
                    optimize_points: bool = True) -> FlatSums:
    """Plain PyTorch version of ``linearize``: ``flat_blocks``, then
    ``sums_of_blocks``."""
    COUNTS.plain += 1
    r, jc, jp = flat_blocks(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx, pt_idx,
                            uv, mask, inv_width, loss, optimize_focal, optimize_points)
    return sums_of_blocks(r, jc, jp, cam_idx, pt_idx, n_cameras, n_points)


_SYM_INDEX: dict = {}


def sym_index(n: int, device) -> torch.Tensor:
    """(n * n,) int64: entry (i, j) of an n x n symmetric matrix in its
    row-major upper triangle (i <= j), made on ``device`` once per process
    (arange arithmetic: no host copy, so no sync)."""
    key = (n, torch.device(device))
    if key not in _SYM_INDEX:
        a = torch.arange(n * n, device=device)
        i, j = a // n, a % n
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        _SYM_INDEX[key] = lo * (2 * n - lo + 1) // 2 + hi - lo
    return _SYM_INDEX[key]


def _unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(R, n (n + 1) / 2) row-major upper triangles -> (R, n, n) symmetric."""
    full = torch.index_select(packed, 1, sym_index(n, packed.device))
    return full.view(packed.shape[0], n, n)


def _obs_args(name, rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx, pt_idx, uv,
              mask, inv_w):
    """The checked observation arguments of both C entries (``inv_w`` the
    0-d scale tensor), through ``N, C, P``."""
    dtype, dev = points3d.dtype, points3d.device
    n_cameras, n_points, n_obs = rmats.shape[0], points3d.shape[0], uv.shape[0]
    check_inputs(name, dev, dtype, rmats=rmats, tvecs=tvecs, fx_fy=fx_fy,
                 cx_cy_skew=cx_cy_skew, dist=dist, points3d=points3d, uv=uv, mask=mask,
                 inv_width=inv_w)
    check_inputs(name, dev, torch.int32, cam_idx=cam_idx, pt_idx=pt_idx)
    for key, t, shape in (
        ("rmats", rmats, (n_cameras, 3, 3)), ("tvecs", tvecs, (n_cameras, 3)),
        ("fx_fy", fx_fy, (n_cameras, 2)), ("cx_cy_skew", cx_cy_skew, (n_cameras, 3)),
        ("dist", dist, (n_cameras, 2)), ("points3d", points3d, (n_points, 3)),
        ("cam_idx", cam_idx, (n_obs,)), ("pt_idx", pt_idx, (n_obs,)), ("uv", uv, (n_obs, 2)),
        ("mask", mask, (n_obs,)), ("inv_width", inv_w, ()),
    ):
        check_shape(name, key, t, shape)
    return (rmats.data_ptr(), tvecs.data_ptr(), fx_fy.data_ptr(), cx_cy_skew.data_ptr(),
            dist.data_ptr(), points3d.data_ptr(), cam_idx.data_ptr(), pt_idx.data_ptr(),
            uv.data_ptr(), mask.data_ptr(), inv_w.data_ptr()), (n_obs, n_cameras, n_points)


def linearize(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx, pt_idx, uv, mask,
              inv_width, n_cameras: int, n_points: int, loss: RobustLoss = RobustLoss.TRIVIAL,
              optimize_focal: bool = True, optimize_points: bool = True) -> FlatSums:
    """The flat engine's undamped sums of one linearization.

    Cameras ``rmats`` (C,3,3), ``tvecs`` (C,3), ``fx_fy`` (C,2),
    ``cx_cy_skew`` (C,3), ``dist`` (C,2); ``points3d`` (P,3); observations
    ``cam_idx``, ``pt_idx`` (N,) int32, ``uv`` (N,2), ``mask`` (N,);
    ``inv_width`` the 0-d residual scale.  CPU tensors run the plain
    version, whose ``coupling`` is ``coupling_of_w`` on its W; CUDA tensors
    launch ``flat_lin_kernel`` (counted as ``flat.lin_kernel``), and their
    ``coupling`` launches ``flat_coupling_kernel``, which recomputes W from
    the observations.  Both raise on inputs they do not take (another
    dtype, a non-contiguous tensor)."""
    if not is_cuda_call(points3d):
        return linearize_plain(rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx,
                               pt_idx, uv, mask, inv_width, n_cameras, n_points, loss,
                               optimize_focal, optimize_points)
    name = "flat_linearize"
    dtype, dev = points3d.dtype, points3d.device
    # Every input tensor, the scale too, stays referenced while the sums'
    # coupling can still launch on them.
    inputs = (rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, cam_idx, pt_idx, uv, mask,
              torch.as_tensor(inv_width, dtype=dtype, device=dev))
    ptrs, (n_obs, c, p) = _obs_args(name, *inputs)
    if (c, p) != (n_cameras, n_points):
        raise ValueError(f"{name}: {c} cameras and {p} points, expected "
                         f"{n_cameras} and {n_points}")
    sums = torch.zeros(44 * c + 9 * p, dtype=dtype, device=dev)  # one memset for all four
    u36, g_cam = sums[: 36 * c].view(c, 36), sums[36 * c : 44 * c].view(c, 8)
    v6, g_pt = sums[44 * c : 44 * c + 6 * p].view(p, 6), sums[44 * c + 6 * p :].view(p, 3)
    w = torch.empty((n_obs, 8, 3), dtype=dtype, device=dev)
    lib = _build.library()
    flags = (n_obs, c, p, LOSS_CODES[loss], int(optimize_focal), int(optimize_points))
    code = lib.flat_linearize(_build.dtype_code(dtype), *ptrs, w.data_ptr(), u36.data_ptr(),
                              g_cam.data_ptr(), v6.data_ptr(), g_pt.data_ptr(), *flags,
                              _build.stream_ptr(dev))
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    count("flat.lin_kernel")

    def coupling(v_inv: torch.Tensor) -> torch.Tensor:
        name = "flat_coupling"
        check_inputs(name, dev, dtype, v_inv=v_inv)
        check_shape(name, "v_inv", v_inv, (p, 3, 3))
        out = torch.zeros((c, 36), dtype=dtype, device=dev)
        code = lib.flat_coupling(_build.dtype_code(dtype), *(t.data_ptr() for t in inputs),
                                 v_inv.data_ptr(), out.data_ptr(), *flags,
                                 _build.stream_ptr(dev))
        _build.check(lib, name, code)
        COUPLING_COUNTS.kernel += 1
        return _unpack(out, 8)

    return FlatSums(u=_unpack(u36, 8), v=_unpack(v6, 3), w=w, g_cam=g_cam, g_pt=g_pt,
                    coupling=coupling)
