"""Shared inputs for the PyTorch-port tests (tests/test_torch_*.py).

Every input is built once from a seed with numpy and handed to both the JAX
reference package (CPU, x64) and ``tpu3drecon_torch`` (CPU, float64, plain
kernel versions).  Objects cross between the packages as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# One intra-op thread per test worker: the suite runs under pytest-xdist.
torch.set_num_threads(1)


def np_fields(obj):
    """A JAX-package dataclass as nested dicts of numpy arrays and static
    values (the input format of ``tpu3drecon_torch.problems.convert``)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = np_fields(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            out[f.name] = [np_fields(b) for b in v]
        elif v is None or isinstance(v, (int, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def to_np(x) -> np.ndarray:
    """numpy copy of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol, atol_rel=0.0, err_msg=""):
    """assert_allclose with atol = atol_rel * max|want|."""
    got, want = to_np(got), to_np(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * scale, err_msg=err_msg
    )


def seq_scene_kwargs(dist):
    """The sequential fixture of tests/test_ba_wtt.py (24 cameras, 25
    points each, track span 3, seed 5) with radial distortion ``dist``."""
    return dict(n_cameras=24, points_per_camera=25, track_span=3, seed=5, dist=dist)


SEQ_DISTS = {"pinhole": (0.0, 0.0), "radial": (-0.05, 0.008)}
