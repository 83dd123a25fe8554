"""Bundle adjustment: configuration, state, the flat engine and the
evaluation metric.

Counterpart of ``tpu3drecon/solvers/bundle_adjust.py``: ``BAConfig`` has
the same fields and defaults (the option documentation lives with the JAX
reference), ``BAState`` the same fields.  ``ba_solve`` is the flat
(BAL-layout) engine: per LM iteration

  1. the linearization (``ops/flat_linearize.py``): analytic
     per-observation blocks and their segment sums U, V, g_c, g_p and W;
     on the card two CUDA kernels, one pass over the observations and one
     for the Schur-Jacobi coupling, on the CPU the plain version
     (``ops/jacobians.py`` blocks, ``index_add_`` segment sums);
  2. Marquardt damping, V^-1 and the preconditioner factor
     (``solvers/schur.py damp_normal_blocks``);
  3. matrix-free PCG on the reduced camera system;
  4. point back-substitution, SE(3) retraction and the shared
     trust-region accept/reject (``solvers/trust_region.py``, whose
     decisions are those of JAX's flat ``_ba_solve_impl``).

The JAX engine reaches no Pallas kernel: its linearization is XLA's.
With ``comm`` (a ``parallel.mesh.Mesh``) it runs on one rank's block of an
observation-sharded problem (``parallel/sharded_ba.py``): the segment sums
and the loss are all-reduced, so every rank takes the same steps.
The track-table engines (``solvers/ba_wtt.py``, ``solvers/ba_tt.py``) and
the grid engine (``solvers/ba_pallas.py``) return the same types.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops import flat_linearize
from tpu3drecon_torch.ops.jacobians import apply_se3_retraction, gather_obs_blocks
from tpu3drecon_torch.parallel.mesh import psum
from tpu3drecon_torch.problems.packing import BAProblem, CameraParams
from tpu3drecon_torch.solvers import schur
from tpu3drecon_torch.utils.timing import span, spanned


class BAConfig(NamedTuple):
    """Outer-LM + inner-CG configuration (fields as in the JAX package)."""

    maxiter: int = 50
    gtol: float = 1e-8  # inf-norm of the (whitened) gradient
    ftol: float = 1e-12  # relative cost decrease on accepted steps
    init_lambda: float = 1e-4
    min_lambda: float = 1e-32
    max_lambda: float = 1e32
    cg_maxiter: int = 100
    cg_rtol: float = 1e-5
    loss: RobustLoss = RobustLoss.TRIVIAL
    optimize_focal: bool = True
    optimize_points: bool = True
    optimize_dist: bool = False
    optimize_pp: bool = False
    precond: str = "schur_jacobi"
    matvec_kernel: object = False
    linearize_kernel: object = False
    matvec_bf16: bool = False
    packed_gathers: bool = False


def n_cam_params(config: BAConfig) -> int:
    """Per-camera parameter-block width: pose(6) + focal(2) [+ k1,k2]
    [+ cx,cy].  Column order: so3 | t | fx fy | dist | pp."""
    return 8 + 2 * bool(config.optimize_dist) + 2 * bool(config.optimize_pp)


class BAState(NamedTuple):
    rmats: torch.Tensor  # (C,3,3)
    tvecs: torch.Tensor  # (C,3)
    fx_fy: torch.Tensor  # (C,2)
    points3d: torch.Tensor  # (P,3)
    loss: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    iter_num: int
    accepted: torch.Tensor
    grad_norm: torch.Tensor
    converged: torch.Tensor
    cg_iters: int  # last inner-CG iteration count
    gain: torch.Tensor


def _check_flat_config(config: BAConfig) -> None:
    if config.optimize_pp:
        raise ValueError(
            "optimize_pp is supported by the track-table engines "
            "(ba_solve_tt / ba_solve_wtt) only"
        )
    if config.precond in ("tridiag", "ssor"):
        raise ValueError(
            f"precond={config.precond!r} is supported by the tt/wtt "
            "engines only"
        )


@spanned("ba.solve")
def ba_solve(
    problem: BAProblem, config: BAConfig = BAConfig(), device=None, comm=None
) -> Tuple[CameraParams, torch.Tensor, BAState]:
    """Flat-layout BA solve on ``device`` (default: the CUDA card); returns
    (cameras, points3d, state) with the trust-region trajectory of the JAX
    ``ba_solve``.  ``comm``: the mesh of an observation-sharded problem
    (``problem`` is then this rank's part), as JAX's ``axis_name``."""
    from tpu3drecon_torch.solvers.trust_region import trust_region_solve

    _check_flat_config(config)
    torch.set_float32_matmul_precision("highest")
    dev = resolve_device(device)
    problem = problem.to(dev)
    cams = problem.cameras
    n_cameras, n_points = problem.n_cameras, problem.n_points
    dtype = problem.points3d.dtype
    # A linearization's arguments besides the parameters, contiguous as the
    # card's kernels take them (a no-op where they are).
    cam_idx, pt_idx = problem.cam_idx.contiguous(), problem.pt_idx.contiguous()
    intrinsics = (cams.cx_cy_skew.contiguous(), cams.dist.contiguous())
    obs = (cam_idx, pt_idx, problem.uv.contiguous(), problem.mask.contiguous(),
           1.0 / problem.avg_cam_width)
    flags = dict(loss=config.loss, optimize_focal=config.optimize_focal,
                 optimize_points=config.optimize_points)

    def cost(params):
        rmats, tvecs, fx_fy, points3d = params
        r, _, _ = flat_linearize.flat_blocks(rmats, tvecs, fx_fy, *intrinsics, points3d,
                                             *obs, **flags)
        return psum(0.5 * torch.sum(r * r), comm)

    def propose(params, lam):
        with span("lm.linearize"):
            rmats, tvecs, fx_fy, points3d = params
            sums = flat_linearize.linearize(rmats, tvecs, fx_fy, *intrinsics, points3d, *obs,
                                            n_cameras, n_points, **flags)
            nb = schur.damp_normal_blocks(sums, lam, precond=config.precond, comm=comm)
        with span("lm.rhs"):
            grad_norm = torch.max(torch.abs(nb.g_cam))
            if config.optimize_points:
                grad_norm = torch.maximum(grad_norm, torch.max(torch.abs(nb.g_pt)))
            else:
                grad_norm = torch.clamp(grad_norm, min=0.0)
            # Reduced camera system rhs: b = -g_c + W V^{-1} g_p.
            vinv_gp = torch.sum(nb.v_inv * nb.g_pt[:, None, :], dim=-1)
            b = -nb.g_cam + schur.w_times(nb, vinv_gp, cam_idx, pt_idx, n_cameras, comm)
        out = schur.schur_pcg(nb, b, cam_idx, pt_idx, maxiter=config.cg_maxiter,
                              rtol=config.cg_rtol, comm=comm)
        with span("lm.backsub"):
            dc = out.x
            dp = schur.back_substitute_points(nb, dc, cam_idx, pt_idx, comm)
            if not config.optimize_points:
                dp = dp * 0.0
            pred = 0.5 * (
                torch.sum(dc * (nb.damp_cam * dc))
                + torch.sum(dp * (nb.damp_pt * dp))
                - torch.sum(dc * nb.g_cam)
                - torch.sum(dp * nb.g_pt)
            )
        return (dc, dp), grad_norm, pred, out.iters

    def apply_step(params, delta):
        rmats, tvecs, fx_fy, points3d = params
        dc, dp = delta
        new_r, new_t, new_f = apply_se3_retraction(rmats, tvecs, fx_fy, dc)
        return (new_r, new_t, new_f, points3d + dp)

    params0 = (cams.rmats.contiguous(), cams.tvecs.contiguous(), cams.fx_fy.contiguous(),
               problem.points3d.contiguous())
    final = trust_region_solve(propose, apply_step, cost, params0, config, dtype, dev)
    rmats, tvecs, fx_fy, points3d = final.params
    cameras_out = CameraParams(rmats=rmats, tvecs=tvecs, fx_fy=fx_fy,
                               cx_cy_skew=cams.cx_cy_skew, dist=cams.dist)
    state = BAState(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, points3d=points3d, loss=final.loss,
        lam=final.lam, nu=final.nu, iter_num=final.iter_num, accepted=final.accepted,
        grad_norm=final.grad_norm, converged=final.converged,
        cg_iters=final.cg_iters, gain=final.gain,
    )
    return cameras_out, points3d, state


_SOLVER_CACHE: dict = {}


def make_ba_solver(config: BAConfig = BAConfig()):
    """``problem -> ba_solve(problem, config)``, one closure per config
    (cached).  The JAX package's jit and its dynamic-operand plumbing
    (``DynamicBAParams``, ``static_config``, ...) only key XLA's compile
    cache and have no counterpart (ROADMAP A.8)."""
    _check_flat_config(config)
    if config not in _SOLVER_CACHE:
        _SOLVER_CACHE[config] = functools.partial(ba_solve, config=config)
    return _SOLVER_CACHE[config]


def reprojection_rmse(
    problem: BAProblem, cameras: CameraParams, points3d: torch.Tensor
) -> torch.Tensor:
    """Unwhitened pixel-space RMSE over real observations."""
    blocks = gather_obs_blocks(
        cameras.rmats, cameras.tvecs, cameras.fx_fy, cameras.cx_cy_skew,
        cameras.dist, points3d, problem.cam_idx, problem.pt_idx, problem.uv,
        problem.mask, 1.0, RobustLoss.TRIVIAL,
    )
    n = torch.clamp(torch.sum(problem.mask), min=1.0)
    return torch.sqrt(torch.sum(blocks.residual**2) / (2.0 * n))
