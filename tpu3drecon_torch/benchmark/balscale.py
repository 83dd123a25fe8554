"""The BAL-scale sequential bundle-adjustment problem: 1712 cameras, ~1M
points, 3.81M observations.

Counterpart of ``tpu3drecon/benchmark/balscale.py``'s
``bal_sequential_wtt``: the same scene (``make_sequential_scene`` with
seed 7, 584 points per camera, tracks over 4 cameras), 0.5 px observation
noise (seed 8), f32, packed by ``wtt_from_flat`` with 512-point chunks and
deferred one-hots.  ``BAL_CONFIG`` is the JAX benchmark suite's fixed-work
solver configuration at this scale (8 CG iterations, ``cg_rtol`` 0,
Schur-Jacobi); the CLI picks ``precond="ssor"`` at 1000 cameras or more.

The JAX builder memoizes its output on disk because its host-side build
takes 250-420 s.  This one keeps no cache: the port's builders are numpy on
the host, and ``bal_sequential_wtt`` built the problem onto the card in
6.3 s on the H100 machine (``chip_smoke.py``), so a cache would cost more
in invalidation rules than it saves.

The hub-structured ``bal_hub_wtt`` and ``split_windows`` need the split
window packing, which the port does not have yet.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

N_CAMERAS = 1712
BAL_CONFIG = BAConfig(
    maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=0.0, precond="schur_jacobi",
)


def bal_sequential_flat(
    shuffled: bool = False,
    track_span: int = 4,
    points_per_camera: int = 584,
    device=None,
):
    """The flat BAL-scale BAProblem (f32) on ``device`` (default: the CUDA
    card; raises without one), before packing: what the reprojection RMSE
    of a solve is measured on.  ``shuffled`` relabels the cameras by a
    seeded permutation."""
    device = resolve_device(device)
    from tpu3drecon_torch.dataset.synthetic import (
        make_sequential_scene,
        perturb_scene,
        scene_to_ba_problem,
    )

    scene = make_sequential_scene(
        n_cameras=N_CAMERAS, points_per_camera=points_per_camera,
        track_span=track_span, seed=7,
    )
    noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=torch.float32, device=device)
    if shuffled:
        from tpu3drecon_torch.problems.reorder import permute_cameras_flat

        relabel = np.random.default_rng(99).permutation(flat.n_cameras)  # perm[new] = old
        flat = permute_cameras_flat(flat, relabel)
    return flat


def bal_sequential_wtt(
    shuffled: bool = False,
    chunk_multiple: Optional[int] = None,
    verbose: bool = True,
    track_span: int = 4,
    points_per_camera: int = 584,
    split_windows: bool | int = False,
    device=None,
):
    """The BAL-scale wtt problem with deferred one-hots on ``device``
    (default: the CUDA card; raises without one).

    ``shuffled`` relabels cameras photo-tourism-style (the RCM pass inside
    ``wtt_from_flat`` must recover locality); ``chunk_multiple`` rounds
    group counts.  ``problems.wtt.expand_onehots`` builds the dense one-hot
    for the routes that read it.  A truthy ``split_windows`` raises
    ``NotImplementedError``."""
    if split_windows:
        raise NotImplementedError(
            "split_windows belongs to the hub/split-window slice of the port "
            "(window-row tiling of B1/B8), which is not done yet"
        )
    device = resolve_device(device)
    from tpu3drecon_torch.problems.wtt import wtt_from_flat

    t0 = time.perf_counter()
    flat = bal_sequential_flat(shuffled, track_span, points_per_camera, device="cpu")
    kwargs = {} if chunk_multiple is None else {"chunk_multiple": chunk_multiple}
    problem = wtt_from_flat(flat, point_chunk=512, defer_onehot=True, device=device,
                            **kwargs)
    if verbose:
        print(f"bal_sequential_wtt: built in {time.perf_counter() - t0:.1f} s "
              f"(c_pad {problem.c_pad}, {len(problem.buckets)} buckets)", flush=True)
    return problem
