"""The linearized BAL buckets that the B2 probes (E1, E2) run on."""

from __future__ import annotations

import torch


def bal_normal(problem=None, lam: float = 1e-3):
    """(problem, config, WTTNormal): the BAL sequential problem
    (``bal_sequential_wtt()`` on the card unless given), linearized by
    kernel B1 at its initial parameters and damping ``lam`` under the JAX
    suite's BAL config, fully indexed."""
    from tpu3drecon_torch.benchmark.balscale import BAL_CONFIG, bal_sequential_wtt
    from tpu3drecon_torch.solvers.ba_wtt import _linearize

    if problem is None:
        problem = bal_sequential_wtt(verbose=False)
    config = BAL_CONFIG._replace(matvec_kernel="index", linearize_kernel="index")
    cams = problem.cameras
    pts = []
    for bucket, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, _, pc = bucket.uv.shape
        block = problem.points3d[off : off + g * pc]
        pts.append(block.reshape(g, pc, 3).permute(2, 0, 1).contiguous())
    params = (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew, tuple(pts))
    lam_t = torch.tensor(lam, dtype=problem.points3d.dtype, device=problem.points3d.device)
    return problem, config, _linearize(params, lam_t, problem, config)


def random_x(problem, np_cam: int, seed: int = 0) -> torch.Tensor:
    """(c_pad, np) float32 standard normal x from numpy's generator ``seed``,
    on the problem's device."""
    import numpy as np

    x = np.random.default_rng(seed).standard_normal((problem.c_pad, np_cam), np.float32)
    return torch.as_tensor(x, device=problem.points3d.device)
