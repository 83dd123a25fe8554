"""The BAL-scale bundle-adjustment problems: 1712 cameras, ~1M points,
3.81M observations on a sequential capture, and its hub-structured
(photo-tourism) variant.

Counterpart of ``tpu3drecon/benchmark/balscale.py``'s
``bal_sequential_wtt``: the same scene (``make_sequential_scene`` with
seed 7, 584 points per camera, tracks over 4 cameras), 0.5 px observation
noise (seed 8), f32, packed by ``wtt_from_flat`` with 512-point chunks and
deferred one-hots.  ``BAL_CONFIG`` is the JAX benchmark suite's fixed-work
solver configuration at this scale (8 CG iterations, ``cg_rtol`` 0,
Schur-Jacobi); the CLI picks ``precond="ssor"`` at 1000 cameras or more.

Both wtt builders memoize their output on disk through
``utils/problem_cache.cached_problem``, as the JAX builders do: the
problem is built and packed on the host, stored as numpy, and a hit places
it on ``device``.  The keys name every build parameter and carry the
builder's version (``_VERSION``), which is bumped when its semantics change.

``bal_hub_wtt`` is the JAX function of the same name: ``make_hub_scene``
with 5 % interleaved overview hubs of 4000 observations each, packed in
``wtt_from_flat``'s auto mode, which finds the hub/global camera split
itself.  Its windows carry global camera tiles, so its buckets are wider
than the kernels' shared-memory tiles hold (B1 runs in its global-memory
mode there).  Both builders take ``split_windows`` (``wtt_from_flat``'s
per-chunk window classes), as the JAX suite's BAL cell packs them.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tpu3drecon_torch.device import resolve_device
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

N_CAMERAS = 1712
_VERSION = "v1"
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
    group counts; ``split_windows`` packs per-chunk window classes.
    ``problems.wtt.expand_onehots`` builds the dense one-hot for the routes
    that read it."""
    device = resolve_device(device)
    from tpu3drecon_torch.problems.wtt import _split_class_cap, wtt_from_flat
    from tpu3drecon_torch.utils.problem_cache import cached_problem

    def build():
        flat = bal_sequential_flat(shuffled, track_span, points_per_camera, device="cpu")
        kwargs = {} if chunk_multiple is None else {"chunk_multiple": chunk_multiple}
        if split_windows:
            kwargs["split_windows"] = split_windows
        return wtt_from_flat(flat, point_chunk=512, defer_onehot=True, device="cpu",
                             **kwargs)

    key = (f"balseq_{N_CAMERAS}x{points_per_camera}_span{track_span}_s7_n0.5_pc512"
           f"_deferred_{_VERSION}")
    if shuffled:
        key += "_shuffled99"
    if chunk_multiple is not None:
        key += f"_cm{chunk_multiple}"
    if split_windows:
        key += f"_split_c{_split_class_cap(split_windows)}"
    t0 = time.perf_counter()
    problem = cached_problem(key, build, device=device)
    if verbose:
        print(f"bal_sequential_wtt: ready in {time.perf_counter() - t0:.1f} s "
              f"(c_pad {problem.c_pad}, {len(problem.buckets)} buckets)", flush=True)
    return problem


def bal_hub_flat(
    hub_fraction: float = 0.05,
    hub_obs: int = 4000,
    points_per_camera: int = 584,
    track_span: int = 4,
    device=None,
):
    """The flat BAL-scale hub problem (f32) on ``device`` (default: the CUDA
    card; raises without one), before packing."""
    device = resolve_device(device)
    from tpu3drecon_torch.dataset.synthetic import (
        make_hub_scene,
        perturb_scene,
        scene_to_ba_problem,
    )

    scene = make_hub_scene(
        n_cameras=N_CAMERAS, points_per_camera=points_per_camera, track_span=track_span,
        hub_fraction=hub_fraction, hub_obs=hub_obs, seed=7,
    )
    noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=torch.float32, device=device)
    return flat


def bal_hub_wtt(
    verbose: bool = True,
    hub_fraction: float = 0.05,
    hub_obs: int = 4000,
    points_per_camera: int = 584,
    track_span: int = 4,
    split_windows: bool | int = False,
    device=None,
):
    """The BAL-scale hub-structured wtt problem with deferred one-hots on
    ``device`` (default: the CUDA card; raises without one): 1712 cameras
    with ``hub_fraction`` interleaved hubs of ``hub_obs`` observations,
    packed by ``wtt_from_flat``'s auto mode with 512-point chunks
    (``split_windows`` as ``bal_sequential_wtt``'s)."""
    device = resolve_device(device)
    from tpu3drecon_torch.problems.wtt import _split_class_cap, wtt_from_flat
    from tpu3drecon_torch.utils.problem_cache import cached_problem

    def build():
        flat = bal_hub_flat(hub_fraction, hub_obs, points_per_camera, track_span,
                            device="cpu")
        return wtt_from_flat(flat, point_chunk=512, defer_onehot=True,
                             split_windows=split_windows, device="cpu")

    key = (f"balhub_{N_CAMERAS}x{points_per_camera}_span{track_span}"
           f"_h{hub_fraction}x{hub_obs}_s7_n0.5_pc512_deferred_{_VERSION}")
    if split_windows:
        key += f"_split_c{_split_class_cap(split_windows)}"
    t0 = time.perf_counter()
    problem = cached_problem(key, build, device=device)
    if verbose:
        print(f"bal_hub_wtt: ready in {time.perf_counter() - t0:.1f} s "
              f"(c_pad {problem.c_pad}, {len(problem.buckets)} buckets)", flush=True)
    return problem
