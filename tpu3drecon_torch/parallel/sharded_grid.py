"""The bucketed-grid engine with camera rows and track-bucket rows sharded
over a mesh.

Counterpart of ``tpu3drecon/parallel/sharded_grid.py``.  Two axes are
split across the ranks, each in contiguous blocks:

  - the camera axis: each rank holds C/D rows of the (C, K) grid (uv,
    ``pt_idx``, mask), their residual and Jacobian planes, U blocks,
    gradients, the CG state and the camera parameters themselves;
  - the point axis: each rank holds Pb/D rows of every track bucket, their
    gathered jp rows, V blocks, V^-1, g_p and the back-substituted dp.

Only ``points3d`` is replicated, since every camera row projects arbitrary
points.  The camera count is padded to a multiple of the mesh size with
inert cameras (``pad_cameras_for_mesh``: all-zero masks, exact zero
steps).  The transport between the two axes is ``all_gather``: per
linearization the packed [jp | r] rows (camera side to point side), V^-1
under Schur-Jacobi and dp (point side to camera side); per CG iteration
the W^T x pairs and y = V^-1 W^T x.  Point vectors are gathered bucket by
bucket (``gather_points``): one gather would interleave the ranks' blocks
across buckets.  Every trust-region and CG decision reads all-reduced
values (``psum`` / ``pmax``), so the ranks step in lockstep.

``kernels="pallas"`` runs the camera side through the plane forms of the
port's kernels on the local rows: B9 (``ops/cam_normal.cam_normal_fused``)
for r, jp, jc, U and g, B11 (``ops/coupling.coupling_fused``) for the
Schur-Jacobi blocks; ``"xla"`` runs the grid engine's plane math
(``solvers/ba_grid.grid_blocks``); ``"auto"`` picks the kernels on the card
and the plane math on the CPU, as JAX picks Pallas on the TPU.  V, the
matvecs and the cost are plain PyTorch on either route, as they are plain
XLA in JAX.  The damped blocks are factored by ``cholesky_or_nan`` (JAX's
``vmap(jnp.linalg.cholesky)``) and the CG loop is JAX's, with all-reduced
dot products.  JAX's jitted factory ``make_sharded_grid_solver`` keys
XLA's cache and has no counterpart (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from tpu3drecon_torch.ops.jacobians import apply_se3_retraction
from tpu3drecon_torch.ops.point_normal import inv3x3
from tpu3drecon_torch.parallel.mesh import Mesh, make_mesh
from tpu3drecon_torch.problems.grid import (
    BAGridBucketedProblem,
    TrackBucket,
    unpermute_points,
)
from tpu3drecon_torch.problems.packing import CameraParams
from tpu3drecon_torch.solvers.ba_grid import GridBlocks, _check_config, _project, grid_blocks
from tpu3drecon_torch.solvers.ba_pallas import _FOCAL_ROWS
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, BAState
from tpu3drecon_torch.solvers.pcg import _guard, cho_block_precond, cholesky_or_nan
from tpu3drecon_torch.solvers.trust_region import trust_region_solve

SHARD_AXIS = "shard"
KERNELS = ("auto", "pallas", "xla")


def pad_cameras_for_mesh(problem: BAGridBucketedProblem, n_devices: int) -> BAGridBucketedProblem:
    """The camera axis padded to a multiple of the mesh size.  Padding rows
    get identity rotations, z-offset translations and unit focals with
    all-zero observation masks: they contribute exact zeros everywhere and
    their LM steps are exactly zero."""
    pad = (-problem.n_cameras) % n_devices
    if pad == 0:
        return problem
    k = problem.uv.shape[1]
    dtype, dev = problem.uv.dtype, problem.uv.device
    cams = problem.cameras

    def cat(x, fill):
        return torch.cat([x, fill.to(dtype=x.dtype, device=x.device)])

    new_cams = CameraParams(
        rmats=cat(cams.rmats, torch.eye(3).expand(pad, 3, 3)),
        tvecs=cat(cams.tvecs, torch.tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)),
        fx_fy=cat(cams.fx_fy, torch.ones(pad, 2)),
        cx_cy_skew=cat(cams.cx_cy_skew, torch.zeros(pad, 3)),
        dist=cat(cams.dist, torch.zeros(pad, 2)),
    )
    return dataclasses.replace(
        problem,
        cameras=new_cams,
        uv=torch.cat([problem.uv, torch.zeros((pad, k, 2), dtype=dtype, device=dev)]),
        pt_idx=torch.cat([problem.pt_idx,
                          torch.zeros((pad, k), dtype=torch.int32, device=dev)]),
        mask=torch.cat([problem.mask, torch.zeros((pad, k), dtype=dtype, device=dev)]),
    )


def shard_grid_problem(problem: BAGridBucketedProblem, mesh: Mesh,
                       axis_name: str = SHARD_AXIS) -> BAGridBucketedProblem:
    """This rank's part of a bucketed grid problem: the camera axis padded to
    the mesh and cut to the rank's rows (grid planes and camera parameters),
    every track bucket cut to the rank's rows, ``points3d`` whole.  Bucket
    point counts are multiples of the point block, so a power-of-two mesh
    up to the block divides them."""
    problem = pad_cameras_for_mesh(problem, mesh.size)
    c = problem.cameras
    return dataclasses.replace(
        problem,
        cameras=CameraParams(
            rmats=mesh.shard(c.rmats), tvecs=mesh.shard(c.tvecs), fx_fy=mesh.shard(c.fx_fy),
            cx_cy_skew=mesh.shard(c.cx_cy_skew), dist=mesh.shard(c.dist),
        ),
        points3d=mesh.replicate(problem.points3d),
        uv=mesh.shard(problem.uv),
        pt_idx=mesh.shard(problem.pt_idx),
        mask=mesh.shard(problem.mask),
        buckets=tuple(
            TrackBucket(track_idx=mesh.shard(b.track_idx), track_cam=mesh.shard(b.track_cam),
                        track_mask=mesh.shard(b.track_mask))
            for b in problem.buckets
        ),
        avg_cam_width=mesh.replicate(problem.avg_cam_width),
        point_rows=mesh.replicate(problem.point_rows),
    )


def ba_solve_grid_sharded(
    problem: BAGridBucketedProblem,
    config: BAConfig = BAConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: Optional[str] = None,
    kernels: str = "auto",
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Sharded bucketed-grid solve over ``mesh`` (default: the whole group);
    the outputs of ``ba_solve_pallas`` (points in their original order,
    the cameras with the mesh's padding rows), whole on every rank."""
    _check_config(config)
    if kernels not in KERNELS:
        raise ValueError(f"kernels must be one of {KERNELS}; got {kernels!r}")
    torch.set_float32_matmul_precision("highest")
    mesh = mesh or make_mesh(axis_name=axis_name or SHARD_AXIS)
    if kernels == "auto":
        kernels = "pallas" if mesh.device.type == "cuda" else "xla"
    placed = shard_grid_problem(problem, mesh)
    cams, pts, state = _solve_local(placed, config, mesh, kernels)
    pts = unpermute_points(pts, placed)
    return cams, pts, state._replace(points3d=pts)


class _ShardNormal(NamedTuple):
    """One rank's linearization."""

    u: torch.Tensor  # (C_l, 8, 8) damped
    u_chol: torch.Tensor
    g_cam: torch.Tensor  # (C_l, 8)
    jc: torch.Tensor  # (C_l, K, 2, 8)
    jp: torch.Tensor  # (C_l, K, 2, 3)
    buckets_jp_g: list  # per bucket (Pb_l, 2Tb, 3)
    v_inv: torch.Tensor  # (P_l, 3, 3)
    g_pt: torch.Tensor  # (P_l, 3)
    damp_cam: torch.Tensor
    damp_pt: torch.Tensor


def _solve_local(problem: BAGridBucketedProblem, config: BAConfig, mesh: Mesh, kernels: str):
    """The per-rank solve body on this rank's rows (JAX's ``_solve_local``)."""
    from tpu3drecon_torch.ops.cam_normal import cam_normal_fused
    from tpu3drecon_torch.ops.coupling import coupling_fused

    cams = problem.cameras  # this rank's camera rows
    dtype = problem.points3d.dtype
    dev = problem.points3d.device
    k = problem.uv.shape[1]
    local_bucket_sizes = tuple(b.track_idx.shape[0] for b in problem.buckets)

    def gather_points(x_local):
        """Point rows of every rank in the global order [bucket 0 | bucket 1
        | ...]: one gather per bucket."""
        parts, off = [], 0
        for n in local_bucket_sizes:
            parts.append(mesh.all_gather(x_local[off : off + n]))
            off += n
        return torch.cat(parts)

    def blocks_for(rmats, tvecs, fx_fy, points3d_full):
        b = grid_blocks(rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, points3d_full,
                        problem, config.loss)
        jc, jp = b.jc, b.jp
        if not config.optimize_focal:
            jc = torch.cat([jc[..., :6], torch.zeros_like(jc[..., 6:8])], dim=-1)
        if not config.optimize_points:
            jp = jp * 0.0
        return GridBlocks(r=b.r, jc=jc, jp=jp)

    def blocks_for_kernels(rmats, tvecs, fx_fy, points3d_full):
        """The same blocks from kernel B9 on the local rows (U and g come
        with them); the planes transposed into the grid layout the products
        read."""
        c_l = problem.uv.shape[0]
        x_w = points3d_full[problem.pt_idx].permute(0, 2, 1).contiguous()
        uv_t = problem.uv.permute(0, 2, 1).contiguous()
        inv_w = (1.0 / problem.avg_cam_width).to(dtype)
        r_pl, jp_pl, jc_pl, u0, g0 = cam_normal_fused(
            rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, x_w, uv_t, problem.mask, inv_w,
            loss=config.loss,
        )
        if not config.optimize_focal:
            jc_pl = jc_pl.index_fill(1, torch.tensor(_FOCAL_ROWS, device=dev), 0.0)
            keep = torch.ones(8, dtype=dtype, device=dev)
            keep[6:8] = 0.0
            u0 = u0 * keep[None, :, None] * keep[None, None, :]
            g0 = g0 * keep[None, :]
        if not config.optimize_points:
            jp_pl = jp_pl * 0.0
        r = r_pl.permute(0, 2, 1)  # (c_l, k, 2)
        jc = jc_pl.reshape(c_l, 2, 8, k).permute(0, 3, 1, 2)
        jp = jp_pl.reshape(c_l, 2, 3, k).permute(0, 3, 1, 2)
        return GridBlocks(r=r, jc=jc, jp=jp), jc_pl, jp_pl, u0, g0

    def linearize(params, lam):
        rmats, tvecs, fx_fy, points3d_full = params
        if kernels == "pallas":
            b, jc_pl, jp_pl, u, g_cam = blocks_for_kernels(rmats, tvecs, fx_fy, points3d_full)
            c_l = b.jc.shape[0]
        else:
            b = blocks_for(rmats, tvecs, fx_fy, points3d_full)
            c_l = b.jc.shape[0]
            jc2 = b.jc.reshape(c_l, k * 2, 8)
            r2 = b.r.reshape(c_l, k * 2)
            u = torch.einsum("cni,cnj->cij", jc2, jc2)
            g_cam = torch.einsum("cni,cn->ci", jc2, r2)

        # The packed [jp | r] rows to the point side.
        jpr_local = torch.cat([b.jp.reshape(c_l * k, 6), b.r.reshape(c_l * k, 2)], dim=1)
        jpr_full = mesh.all_gather(jpr_local)  # (C * k, 8) global flat rows

        buckets_jp_g, v_parts, g_parts = [], [], []
        for bucket in problem.buckets:  # this rank's rows of each bucket
            pb, tb = bucket.track_idx.shape
            jpr_g = jpr_full[bucket.track_idx] * bucket.track_mask[..., None]
            jp_g = jpr_g[..., :6].reshape(pb, tb * 2, 3)
            r_g = jpr_g[..., 6:8].reshape(pb, tb * 2)
            v_parts.append(torch.sum(jp_g[..., :, None] * jp_g[..., None, :], dim=1))
            g_parts.append(torch.sum(jp_g * r_g[..., None], dim=1))
            buckets_jp_g.append(jp_g)
        v = torch.cat(v_parts)
        g_pt = torch.cat(g_parts)

        eye8 = torch.eye(8, dtype=dtype, device=dev)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        damp_cam = lam * torch.clamp(torch.diagonal(u, dim1=-2, dim2=-1), min=1e-8)
        damp_pt = lam * torch.clamp(torch.diagonal(v, dim1=-2, dim2=-1), min=1e-8)
        u_d = u + damp_cam[..., None] * eye8
        v_inv = inv3x3(v + damp_pt[..., None] * eye3)  # this rank's points

        precond_mat = u_d
        if config.precond == "schur_jacobi":
            # V^-1 of the local camera rows' points: one gather (the rows
            # observe arbitrary points).
            if kernels == "pallas":
                vinv6 = torch.stack(
                    [v_inv[:, 0, 0], v_inv[:, 0, 1], v_inv[:, 0, 2],
                     v_inv[:, 1, 1], v_inv[:, 1, 2], v_inv[:, 2, 2]], dim=1)
                vinv6_g = gather_points(vinv6)[problem.pt_idx].permute(0, 2, 1).contiguous()
                coupling = coupling_fused(jc_pl, jp_pl, vinv6_g)
            else:
                vinv_full = gather_points(v_inv.reshape(-1, 9)).reshape(-1, 3, 3)
                w_cell = (b.jc[..., 0, :, None] * b.jp[..., 0, None, :]
                          + b.jc[..., 1, :, None] * b.jp[..., 1, None, :])
                vinv_g = vinv_full[problem.pt_idx]
                wv = (w_cell[..., 0, None] * vinv_g[..., None, 0, :]
                      + w_cell[..., 1, None] * vinv_g[..., None, 1, :]
                      + w_cell[..., 2, None] * vinv_g[..., None, 2, :])
                coupling = torch.einsum("ckil,ckml->cim", wv, w_cell)
            precond_mat = u_d - coupling
        return _ShardNormal(
            u=u_d, u_chol=cholesky_or_nan(precond_mat), g_cam=g_cam, jc=b.jc, jp=b.jp,
            buckets_jp_g=buckets_jp_g, v_inv=v_inv, g_pt=g_pt, damp_cam=damp_cam,
            damp_pt=damp_pt,
        )

    def wt_times(nb, x_local):
        """(W^T x) on this rank's points: the per-observation pairs of every
        camera row gathered."""
        c_l = nb.jc.shape[0]
        s = torch.sum(nb.jc * x_local[:, None, None, :], dim=-1)  # (c_l, k, 2)
        s_full = mesh.all_gather(s.reshape(c_l * k, 2))
        parts = []
        for bucket, jp_g in zip(problem.buckets, nb.buckets_jp_g):
            pb, tb = bucket.track_idx.shape
            s_g = (s_full[bucket.track_idx] * bucket.track_mask[..., None]).reshape(pb, tb * 2)
            parts.append(torch.sum(jp_g * s_g[..., None], dim=1))
        return torch.cat(parts)

    def w_times(nb, y_local):
        """(W y) on this rank's camera rows: y gathered over the point side."""
        y_g = gather_points(y_local)[problem.pt_idx]  # (c_l, k, 3)
        tmp = torch.sum(nb.jp * y_g[:, :, None, :], dim=-1)
        return torch.einsum("ckri,ckr->ci", nb.jc, tmp)

    def schur_matvec(nb, x_local):
        ux = torch.sum(nb.u * x_local[:, None, :], dim=-1)
        vinv_wtx = torch.sum(nb.v_inv * wt_times(nb, x_local)[:, None, :], dim=-1)
        return ux - w_times(nb, vinv_wtx)

    def dot(a, b_):
        return mesh.psum(torch.sum(a * b_))

    def pcg(nb, b_local):
        """JAX's CG loop: every dot product all-reduced."""
        precond = cho_block_precond(nb.u_chol)
        z = precond(b_local)
        rz = dot(b_local, z)
        tol2 = torch.full_like(rz, config.cg_rtol) ** 2 * torch.clamp(
            dot(b_local, b_local), min=1e-32)
        x, r, p, i = torch.zeros_like(b_local), b_local, z, 0
        while i < config.cg_maxiter and bool(dot(r, r) > tol2):
            sp = schur_matvec(nb, p)
            alpha = rz / _guard(dot(p, sp))
            x = x + alpha * p
            r = r - alpha * sp
            z = precond(r)
            rz_new = dot(r, z)
            p = z + rz_new / _guard(rz) * p
            rz = rz_new
            i += 1
        return x, i

    def propose(params, lam):
        nb = linearize(params, lam)
        grad_norm = torch.max(torch.abs(nb.g_cam))
        if config.optimize_points:
            grad_norm = torch.maximum(grad_norm, torch.max(torch.abs(nb.g_pt)))
        else:
            grad_norm = torch.clamp(grad_norm, min=0.0)
        grad_norm = mesh.pmax(grad_norm)
        vinv_gp = torch.sum(nb.v_inv * nb.g_pt[:, None, :], dim=-1)
        b = -nb.g_cam + w_times(nb, vinv_gp)
        dc, cg_iters = pcg(nb, b)
        dp_local = torch.sum(nb.v_inv * (-nb.g_pt - wt_times(nb, dc))[:, None, :], dim=-1)
        if not config.optimize_points:
            dp_local = dp_local * 0.0
        pred = 0.5 * (
            mesh.psum(torch.sum(dc * (nb.damp_cam * dc)))
            + mesh.psum(torch.sum(dp_local * (nb.damp_pt * dp_local)))
            - mesh.psum(torch.sum(dc * nb.g_cam))
            - mesh.psum(torch.sum(dp_local * nb.g_pt))
        )
        return (dc, dp_local), grad_norm, pred, cg_iters

    def apply_step(params, delta):
        rmats, tvecs, fx_fy, points3d_full = params
        dc, dp_local = delta
        new_r, new_t, new_f = apply_se3_retraction(rmats, tvecs, fx_fy, dc)
        return (new_r, new_t, new_f, points3d_full + gather_points(dp_local))

    def cost(params):
        rmats, tvecs, fx_fy, points3d_full = params
        r, _, _ = _project(rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, points3d_full,
                           problem, config.loss)
        return mesh.psum(0.5 * torch.sum(r * r))

    params0 = (cams.rmats, cams.tvecs, cams.fx_fy, problem.points3d)
    final = trust_region_solve(propose, apply_step, cost, params0, config, dtype, dev)
    rmats, tvecs, fx_fy, points3d_full = final.params
    cameras_out = CameraParams(
        rmats=mesh.all_gather(rmats), tvecs=mesh.all_gather(tvecs),
        fx_fy=mesh.all_gather(fx_fy), cx_cy_skew=mesh.all_gather(cams.cx_cy_skew),
        dist=mesh.all_gather(cams.dist),
    )
    state = BAState(
        rmats=cameras_out.rmats, tvecs=cameras_out.tvecs, fx_fy=cameras_out.fx_fy,
        points3d=points3d_full, loss=final.loss, lam=final.lam, nu=final.nu,
        iter_num=final.iter_num, accepted=final.accepted, grad_norm=final.grad_norm,
        converged=final.converged, cg_iters=final.cg_iters, gain=final.gain,
    )
    return cameras_out, points3d_full, state
