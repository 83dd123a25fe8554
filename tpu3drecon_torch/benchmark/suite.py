"""The BASELINE.md configuration ladder, one JSON line per configuration.

Counterpart of ``tpu3drecon/benchmark/suite.py`` (reference:
src/benchmark/jaxopt_benchmark/benchmark_pose_optimization.py:165-182
measured every scale it defined; BASELINE.md pins five):

    python -m tpu3drecon_torch.benchmark.suite [--cpu] [--cg N]

  1. pnp_parity      -- batched PnP refinement against an in-run scipy
                        ``least_squares`` oracle (pose parity and speed-up)
  2. ba_small        -- 10 cameras / 5k points on the tt engine's PyTorch
                        route, reprojection RMSE against the 1e-3 px target
  3. ba_medium       -- ``run_medium``: the medium problem of
                        ``benchmark/medium_config.py`` on the wtt engine with
                        both index kernels (B1-B4) and deferred one-hots
  4. tracking_500    -- 500 frames in one batched LM solve, ms/frame
  5. bal_lm_iter     -- BAL scale (1712 cameras / 1M points) on the wtt
                        engine, s/LM-iter

Every solve is fixed-work.  The runners take ``device`` (default: the CUDA
card; raises without one); ``--cpu`` runs on the CPU.  On the card
``run_bal`` packs split windows and runs both index kernels (B1-B4),
through the problem cache; on the CPU it runs at BAL-ratio scale
(``ratio_cams`` cameras), unsplit, on the kernels' plain versions, which
read ``wcam`` and so need no one-hot.

Timing: each runner's first call is timed apart (``compile_s``, the first
call's wall: PyTorch compiles nothing, but the first call pays the kernel
loads and allocator growth), then ``reps`` calls, each ended by
``torch.cuda.synchronize()`` and one ``.item()``.  ``vs_baseline`` keeps
the in-run ratios (scipy's wall over ours for PnP, 1e-3 px over the RMSE
for small BA) and is null where the JAX suite divides by a figure recorded
on another platform (tracking, BAL, medium): the port has no recorded
baseline of its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device


def _stats(times: List[float]) -> dict:
    ts = sorted(times)
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {
        "median_s": round(med, 4),
        "min_s": round(ts[0], 4),
        "max_s": round(ts[-1], 4),
        "reps": n,
    }


def _first_tensor(out) -> torch.Tensor:
    """The first tensor of a solver's output (through tuples and dataclasses)."""
    if isinstance(out, torch.Tensor):
        return out
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    for leaf in out:
        if isinstance(leaf, (torch.Tensor, tuple, list)) or dataclasses.is_dataclass(leaf):
            return _first_tensor(leaf)
    raise TypeError("no tensor in the solver's output")


def _sync(out) -> None:
    """Waits for the card (if the output is there) and reads one value back."""
    leaf = _first_tensor(out)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    leaf.reshape(-1)[0].item()


def _timed(run: Callable, reps: int) -> Tuple[float, List[float], object]:
    """(first call's wall, ``reps`` walls, last output)."""
    t0 = time.perf_counter()
    out = run()
    _sync(out)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        _sync(out)
        times.append(time.perf_counter() - t0)
    return compile_s, times, out


def run_pnp_parity(reps: int = 3, n_cameras: int = 8, n_points: int = 2300,
                   seed: int = 5, device=None) -> dict:
    """Config #1: single-image PnP refinement, ~2k matches per image.

    Parity oracle = scipy ``least_squares`` LM on the identical masked
    width-normalized residual, solved per camera in-run
    (``solver_cells.pnp_scipy_oracle``).  value = median batch solve time;
    the parity errors (max over cameras against the oracle's solution)
    ride in extra; vs_baseline = oracle wall / ours.
    """
    from tpu3drecon_torch.benchmark import solver_cells as cells
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.solvers.lm_core import LMConfig
    from tpu3drecon_torch.solvers.pose_refine import refine_poses

    device = resolve_device(device)
    problem, noisy = cells.pnp_problem(device, torch.float32, n_cameras, n_points, seed)
    compile_s, times, (cams, state) = _timed(
        lambda: refine_poses(problem, loss=RobustLoss.TRIVIAL, config=cells.PNP_CONFIG,
                             device=device),
        reps,
    )

    # Small-batch latency decomposition: fixed-work runs at two iteration
    # counts solve out the per-call overhead:
    # O = T(m1) - m1 * rate, rate = (T(m2) - T(m1)) / (m2 - m1).
    m1, m2 = 25, 100
    fixed = {}
    for m in (m1, m2):
        fcfg = LMConfig(maxiter=m, gtol=0.0, ftol=0.0, xtol=0.0)
        _, ftimes, _ = _timed(
            lambda _c=fcfg: refine_poses(problem, loss=RobustLoss.TRIVIAL, config=_c,
                                         device=device),
            reps,
        )
        fixed[m] = sorted(ftimes)[len(ftimes) // 2]
    rate = max((fixed[m2] - fixed[m1]) / (m2 - m1), 0.0)
    overhead = max(fixed[m1] - m1 * rate, 0.0)

    oracle = cells.pnp_scipy_oracle(problem, noisy)
    parity = cells.pnp_parity(cams, oracle)
    scipy_s = oracle[3]
    mask = problem.mask.cpu().numpy()

    st = _stats(times)
    return {
        "metric": "pnp_parity_batched_refine",
        "value": st["median_s"],
        "unit": "s",
        "vs_baseline": round(scipy_s / st["median_s"], 2),
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            # The solve's wall less the per-call overhead solved from the
            # fixed-work pair above.
            "device_s": round(max(st["median_s"] - overhead, 0.0), 4),
            "dispatch_overhead_s": round(overhead, 4),
            "marginal_s_per_lm_iter": round(rate, 6),
            "n_cameras": n_cameras,
            "matches_per_image": int(mask.sum(axis=1).mean()),
            "scipy_oracle_s": round(scipy_s, 3),
            "max_rot_geodesic_err_vs_scipy_rad":
                float(f"{parity['max_rot_geodesic_err_rad']:.3e}"),
            "max_tvec_err_vs_scipy": float(f"{parity['max_tvec_err']:.3e}"),
            "max_focal_err_vs_scipy": float(f"{parity['max_focal_err']:.3e}"),
            "parity_target": "f32 tolerance (BASELINE.md config #1)",
            "device": device.type,
        },
    }


def run_small_ba(reps: int = 3, n_cameras: int = 10, n_points: int = 5000,
                 seed: int = 11, device=None) -> dict:
    """Config #2: small BA (~10 cams / 5k pts) on the tt engine's PyTorch
    route (``kernels=False``, as JAX's XLA route); value = reprojection RMSE
    px against the 1e-3 px target (BASELINE.md), time stats in extra."""
    from tpu3drecon_torch.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_ba_problem,
    )
    from tpu3drecon_torch.problems.tt import tt_from_flat
    from tpu3drecon_torch.solvers.ba_tt import make_tt_ba_solver
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, reprojection_rmse

    device = resolve_device(device)
    scene = make_scene(n_cameras=n_cameras, n_points=n_points, seed=seed)
    noisy = perturb_scene(scene, seed=seed + 1, point2d_noise=0.5)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, device=device)
    tt = tt_from_flat(flat, device=device)
    config = BAConfig(
        maxiter=30, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4,
        precond="schur_jacobi",
    )
    solver = make_tt_ba_solver(config)
    compile_s, times, (cams, pts, state) = _timed(lambda: solver(tt), reps)
    rmse = float(reprojection_rmse(flat, cams, pts))

    st = _stats(times)
    return {
        "metric": "ba_small_10cam_5kpt_rmse",
        "value": float(f"{rmse:.3e}"),
        "unit": "px",
        "vs_baseline": round(1e-3 / max(rmse, 1e-30), 1),
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            "n_cameras": n_cameras,
            "n_points": n_points,
            "accepted_steps": int(state.accepted),
            "rmse_target_px": 1e-3,
            "baseline_desc": "BASELINE.md config #2: RMSE within 1e-3 px",
            "device": device.type,
        },
    }


def run_medium(reps: int = 5, cg: Optional[int] = None, device=None,
               n_cameras: Optional[int] = None, n_points: Optional[int] = None,
               obs_per_camera: Optional[int] = None) -> dict:
    """Config #3: the medium problem (``benchmark/medium_config.py``, 100
    cameras, 100k points, 200,704 observations, 30 fixed LM iterations) on
    the wtt engine with both index kernels (B1-B4 on the card, their plain
    versions on the CPU) and deferred one-hots; value = median solve wall.
    ``cg`` overrides the CG budget; the sizes are parameters only so that
    tests can shrink them."""
    from tpu3drecon_torch.benchmark import medium_config as mc
    from tpu3drecon_torch.problems.wtt import wtt_from_flat
    from tpu3drecon_torch.solvers.ba_wtt import make_wtt_ba_solver
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse

    device = resolve_device(device)
    cfg = mc.BENCH_CONFIG if cg is None else mc.BENCH_CONFIG._replace(cg_maxiter=cg)
    flat = mc.build_problem(
        device, torch.float32,
        n_cameras=n_cameras or mc.N_CAMERAS, n_points=n_points or mc.N_POINTS,
        obs_per_camera=obs_per_camera or mc.OBS_PER_CAMERA,
    )
    problem = wtt_from_flat(flat, defer_onehot=True, device=device)
    solver = make_wtt_ba_solver(cfg._replace(matvec_kernel="index", linearize_kernel="index"))
    compile_s, times, (cams, pts, state) = _timed(lambda: solver(problem), reps)
    rmse = float(reprojection_rmse(flat, cams, pts))

    st = _stats(times)
    result = {
        "metric": "ba_medium_100cam_100kpt_30lm_iters",
        "value": st["median_s"],
        "unit": "s",
        "vs_baseline": None,
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            "reproj_rmse_px": float(f"{rmse:.3e}"),
            "accepted_steps": int(state.accepted),
            "engine": "wtt",
            "n_obs": int(flat.mask.sum()),
            "backend": device.type,
        },
    }
    if cg is not None:
        result["extra"]["cg_maxiter"] = cg
    return result


def run_tracking(reps: int = 2, n_frames: int = 500, n_obs: int = 1000,
                 seed: int = 81, device=None) -> dict:
    """Config #4: batched tracking, one LM solve over ``n_frames`` frames
    with shared intrinsics structure.  value = ms/frame."""
    from tpu3drecon_torch.benchmark import solver_cells as cells
    from tpu3drecon_torch.solvers.pose_refine import PoseRefiner, pose_params_pack

    device = resolve_device(device)
    problem, scene = cells.tracking_problem(device, torch.float32, n_frames, n_obs, seed)
    refiner = PoseRefiner(float(problem.avg_cam_width), config=cells.TRACKING_CONFIG,
                          device=device)
    params0 = pose_params_pack(problem.cameras)

    compile_s, times, (params, state) = _timed(
        lambda: refiner.optimize(
            params0, problem.points3d, problem.points2d,
            problem.cameras.cx_cy_skew, problem.mask,
        ),
        reps,
    )
    t_err = float(np.median(np.abs(
        params[:, 3:6].double().cpu().numpy() - scene.tvecs
    )))

    st = _stats(times)
    ms_per_frame = st["median_s"] / n_frames * 1e3
    return {
        "metric": "tracking_500frame_ms_per_frame",
        "value": round(ms_per_frame, 3),
        "unit": "ms/frame",
        "vs_baseline": None,
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            "n_frames": n_frames,
            "obs_per_frame": n_obs,
            "median_tvec_err": float(f"{t_err:.3e}"),
            # Every frame is a lane of one batched solve call.
            "single_executable": True,
            "baseline_desc": "none recorded for the port",
            "device": device.type,
        },
    }


def run_bal(reps: int = 3, lm_iters: int = 3, full_scale: bool = True,
            ratio_cams: int = 128, ratio_ppc: int = 584, device=None) -> dict:
    """Config #5: BAL-scale wtt solve, s/LM-iter at fixed CG work.

    ``full_scale=False`` runs the same pipeline at BAL-ratio scale
    (``ratio_cams`` cameras), and the JSON says so.  The solve is fully
    indexed (B1-B4 on the card, their plain versions, which read ``wcam``,
    on the CPU), so the one-hots stay deferred; the card's problem packs
    split windows.
    """
    from tpu3drecon_torch.solvers.ba_wtt import make_wtt_ba_solver
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    device = resolve_device(device)
    on_card = device.type == "cuda"
    if full_scale:
        from tpu3drecon_torch.benchmark.balscale import N_CAMERAS, bal_sequential_wtt

        problem = bal_sequential_wtt(verbose=False, split_windows=on_card, device=device)
        n_cams, ppc = N_CAMERAS, 584
    else:
        from tpu3drecon_torch.dataset.synthetic import (
            make_sequential_scene,
            perturb_scene,
            scene_to_ba_problem,
        )
        from tpu3drecon_torch.problems.wtt import wtt_from_flat

        n_cams, ppc = ratio_cams, ratio_ppc
        scene = make_sequential_scene(
            n_cameras=n_cams, points_per_camera=ppc, track_span=4, seed=7
        )
        noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=torch.float32,
                                      device="cpu")
        problem = wtt_from_flat(flat, point_chunk=512, defer_onehot=True,
                                split_windows=on_card, device=device)
    n_obs = int(sum(float(b.mask.sum()) for b in problem.buckets))
    config = BAConfig(
        maxiter=lm_iters, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=0.0,
        precond="schur_jacobi", matvec_kernel="index", linearize_kernel="index",
    )
    _, _, init = make_wtt_ba_solver(config._replace(maxiter=0))(problem)
    solver = make_wtt_ba_solver(config)
    compile_s, times, (cams, pts, state) = _timed(lambda: solver(problem), reps)

    st = _stats(times)
    s_per_iter = st["median_s"] / lm_iters
    # Marginal per-iteration rate: a 4x-iteration solve minus the headline
    # run, over the extra iterations (subtracts the per-call overhead that
    # wall / maxiter folds in at small maxiter).
    solver4 = make_wtt_ba_solver(config._replace(maxiter=4 * lm_iters))
    _, times4, _ = _timed(lambda: solver4(problem), max(2, reps - 1))
    marginal = (sorted(times4)[len(times4) // 2] - st["median_s"]) / (3 * lm_iters)
    return {
        "metric": "bal_wtt_s_per_lm_iter",
        "value": round(s_per_iter, 4),
        "unit": "s/LM-iter",
        "vs_baseline": None,
        "extra": {
            **st,
            "marginal_s_per_lm_iter": round(marginal, 4),
            "compile_s": round(compile_s, 2),
            "n_cameras": n_cams,
            "points_per_camera": ppc,
            "n_obs": n_obs,
            "lm_iters": lm_iters,
            "cg_maxiter": 8,
            "full_scale": full_scale,
            "accepted_steps": int(state.accepted),
            "loss": float(f"{float(state.loss):.4e}"),
            "initial_loss": float(f"{float(init.loss):.4e}"),
            "split_windows": on_card,
            "kernels": "B1-B4" if on_card else "B1-B4 plain versions",
            "baseline_desc": "none recorded for the port",
            "device": device.type,
        },
    }


def run_suite(force_cpu: bool = False, cg: Optional[int] = None,
              emit: Optional[Callable[[dict], None]] = None) -> None:
    """All five BASELINE.md configs on the card (the CPU with
    ``force_cpu``), each result handed to ``emit`` as it completes
    (default: one JSON line on stdout)."""
    device = resolve_device("cpu" if force_cpu else None)
    on_cpu = device.type == "cpu"
    if emit is None:
        def emit(res):
            print(json.dumps(res), flush=True)

    emit(run_pnp_parity(device=device))
    emit(run_small_ba(device=device))
    emit(run_medium(reps=2 if on_cpu else 5, cg=cg, device=device))
    emit(run_tracking(reps=2 if on_cpu else 3, device=device))
    emit(run_bal(full_scale=not on_cpu, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run every BASELINE.md config on the port (one JSON line each).")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--cg", type=int, default=None, metavar="N",
                    help="override the medium config's CG budget (default 8)")
    args = ap.parse_args(argv)
    run_suite(force_cpu=args.cpu, cg=args.cg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
