"""The medium bundle-adjustment configuration: 100 cameras, 100k points.

Counterpart of ``tpu3drecon/benchmark/medium_config.py``: the same scene
(seed 42, 2,000 observations per camera, 0.5 px observation noise) and
the same fixed-work solver config (30 LM iterations, no early stop,
Schur-Jacobi preconditioner, 8 CG iterations).  The ``build_*``
functions put the problem on the CUDA card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import time

import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

N_CAMERAS = 100
N_POINTS = 100_000
OBS_PER_CAMERA = 2_000
SEED = 42

LM_ITERS = 30
BENCH_CONFIG = BAConfig(
    maxiter=LM_ITERS,
    gtol=0.0,
    ftol=0.0,
    cg_maxiter=8,
    cg_rtol=1e-4,
    precond="schur_jacobi",
)


def build_problem(device=None, dtype: torch.dtype = torch.float32):
    """The medium flat BAProblem on ``device`` (default: the CUDA card):
    perturbed parameters, clean observations with 0.5 px noise on the
    perturbed copy."""
    device = resolve_device(device)
    from tpu3drecon_torch.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_ba_problem,
    )

    scene = make_scene(
        n_cameras=N_CAMERAS, n_points=N_POINTS,
        obs_per_camera=OBS_PER_CAMERA, seed=SEED,
    )
    noisy = perturb_scene(scene, seed=SEED + 1, point2d_noise=0.5)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=dtype, device=device)
    return problem


def build_grid_problem(device=None, dtype: torch.dtype = torch.float32):
    """The medium problem in bucketed grid layout on ``device`` (default:
    the CUDA card), packed host-side by ``grid_bucketed_from_flat``."""
    from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat

    device = resolve_device(device)
    return grid_bucketed_from_flat(build_problem(device, dtype))


def build_tt_problem(device=None, dtype: torch.dtype = torch.float32):
    """The medium problem in dense track-table layout on ``device``
    (default: the CUDA card), packed host-side by ``tt_from_flat`` with the
    grid layout's track buckets."""
    from tpu3drecon_torch.problems.tt import tt_from_flat

    device = resolve_device(device)
    return tt_from_flat(build_problem(device, dtype))


def timed_solve_stats(solver, problem, repeats: int = 1):
    """Warm-up solve, then ``repeats`` timed solves, each between two
    ``torch.cuda.synchronize()`` calls (a CUDA device is required).
    Returns (warmup_s, run_times, last result)."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed_solve_stats measures on a CUDA device")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solver(problem)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver(problem)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return warmup_s, times, out
