"""Solve checkpoints: save and restore a state's tensors, and a solve run
as resumable chunks.

Counterpart of ``tpu3drecon/utils/checkpoint.py``, with ``torch.save`` /
``torch.load`` in place of orbax: a checkpoint is one file
``<directory>/step_<step>`` holding a dict of CPU tensors, written to a
temporary name and renamed into place, so a killed writer leaves no
partial checkpoint.  ``ba_solve_checkpointed`` runs a long solve as short
solves of ``chunk_iters`` LM iterations with a checkpoint after each; run
again with the same directory it continues from the last one.  The port
does not read the JAX package's orbax checkpoints.

``TPU3DRECON_TORCH_CHECKPOINT_DELAY_S`` (seconds, default 0) sleeps after
every checkpoint: a fault-injection window for kill-and-resume tests.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import torch

DELAY_ENV = "TPU3DRECON_TORCH_CHECKPOINT_DELAY_S"
CAMERA_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


def _path(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f"step_{step}"))


def save_state(state: dict, directory: str, step: int) -> str:
    """Checkpoint a dict of tensors at ``directory/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({k: v.detach().cpu() for k, v in state.items()}, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_", 1)[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_state(template: Optional[dict], directory: str, step: Optional[int] = None) -> dict:
    """The dict saved at ``step`` (default: the latest), CPU tensors; with a
    ``template`` dict, each tensor on its template's device and dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    saved = torch.load(_path(directory, step), weights_only=True)
    if template is None:
        return saved
    if set(saved) != set(template):
        raise KeyError(f"checkpoint keys {sorted(saved)} != template keys {sorted(template)}")
    return {k: saved[k].to(device=template[k].device, dtype=template[k].dtype)
            for k in template}


def update_problem_solution(problem, cams, pts):
    """A packed problem carrying a solver's (cameras, points) output.

    Solvers return cameras and points in the original order; packed
    layouts store points permuted and padded (``point_rows[packed] =
    original``, -1 = padding) and, for the wtt camera relabelings, cameras
    relabeled (``cam_rows[new] = old``).  Works for every engine's problem
    type."""
    dev = problem.points3d.device
    pts = torch.as_tensor(pts, device=dev)
    rows = getattr(problem, "point_rows", None)
    if rows is None:
        new_pts = pts.to(problem.points3d.dtype)
    else:
        rows = rows.to(dev).long()
        vals = pts[torch.clamp(rows, min=0)]
        new_pts = torch.where((rows >= 0)[:, None], vals,
                              torch.zeros_like(vals)).to(problem.points3d.dtype)
    cam_rows = getattr(problem, "cam_rows", None)
    values = {n: torch.as_tensor(getattr(cams, n), device=dev) for n in CAMERA_FIELDS}
    if cam_rows is not None:
        idx = cam_rows.to(dev).long()
        values = {n: v[idx] for n, v in values.items()}
    new_cams = type(problem.cameras)(**values)
    return dataclasses.replace(problem, cameras=new_cams, points3d=new_pts)


def ba_solve_checkpointed(
    problem,
    config,
    checkpoint_dir: str,
    chunk_iters: int = 10,
    solver_fn=None,
) -> Tuple[object, object, object]:
    """Run BA as resumable chunks of ``chunk_iters`` LM iterations.

    Run again with the same ``checkpoint_dir``, the solve continues from
    the last completed chunk (cameras and points restored; the
    trust-region lambda restarts per chunk, which costs a few extra
    accept/reject probes).  Works with any engine's packed problem: pass
    e.g. ``solver_fn=lambda p, c: make_wtt_ba_solver(c)(p)``.  Returns
    (cameras, points, state); the state is None when the checkpoints
    already covered ``config.maxiter``."""
    from tpu3drecon_torch.problems.packing import CameraParams
    from tpu3drecon_torch.solvers.bundle_adjust import ba_solve

    solver_fn = solver_fn or ba_solve
    total = config.maxiter
    chunk_config = config._replace(maxiter=chunk_iters)

    done = 0
    cams, pts, state = problem.cameras, problem.points3d, None
    step0 = latest_step(checkpoint_dir)
    if step0 is not None:
        saved = restore_state(None, checkpoint_dir)
        dev, dtype = problem.points3d.device, problem.points3d.dtype
        cams = CameraParams(**{n: saved[n].to(device=dev, dtype=dtype) for n in CAMERA_FIELDS})
        pts = saved["points3d"].to(device=dev, dtype=dtype)
        problem = update_problem_solution(problem, cams, pts)
        done = step0

    delay = float(os.environ.get(DELAY_ENV, "0") or 0)
    while done < total:
        cams, pts, state = solver_fn(problem, chunk_config)
        done += chunk_iters
        save_state({**{n: getattr(cams, n) for n in CAMERA_FIELDS}, "points3d": pts},
                   checkpoint_dir, done)
        if delay:
            time.sleep(delay)
        problem = update_problem_solution(problem, cams, pts)
        if state is not None and bool(state.converged):
            break
    return cams, pts, state
