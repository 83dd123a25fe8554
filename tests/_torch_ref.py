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


def wtt_kernel_inputs(g, w, tb, np_cam, seed, pc=128):
    """wtt-layout kernel inputs with realistic geometry, as numpy arrays;
    wcam (G, Tb*Pc) has -1 padding (mask 0 there, as the packer emits)."""
    rng = np.random.default_rng(seed)
    n_slot = tb * pc
    wcam = rng.integers(0, w, size=(g, n_slot)).astype(np.int16)
    wcam[rng.random(wcam.shape) < 0.15] = -1
    mask = (wcam >= 0).astype(np.float64).reshape(g, tb, pc)
    # Camera window rows: R (small rotations) | t (z ~ 6) | f | c | k.
    ang = rng.normal(scale=0.1, size=(g, w, 3))
    th = np.linalg.norm(ang, axis=-1, keepdims=True)
    k = ang / th
    kx = np.zeros((g, w, 3, 3))
    kx[..., 0, 1], kx[..., 0, 2], kx[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    kx = kx - np.swapaxes(kx, -1, -2)
    eye = np.eye(3)
    rot = eye + np.sin(th)[..., None] * kx + (1 - np.cos(th))[..., None] * kx @ kx
    t = np.concatenate([rng.normal(scale=0.3, size=(g, w, 2)),
                        rng.uniform(5.0, 7.0, size=(g, w, 1))], axis=-1)
    f = rng.uniform(1000, 1100, size=(g, w, 2))
    c = np.concatenate([rng.uniform(600, 680, size=(g, w, 2)),
                        np.zeros((g, w, 1))], axis=-1)
    dist = np.stack([rng.uniform(-0.05, 0.0, size=(g, w)),
                     rng.uniform(0.0, 0.01, size=(g, w))], axis=-1)
    tw = np.concatenate([rot.reshape(g, w, 9), t, f, c, dist], axis=-1)
    pts = rng.normal(size=(3, g, pc))
    uv = rng.uniform(300, 1000, size=(g, 2, tb, pc))
    xw_t = rng.normal(size=(g, np_cam, w))
    return dict(wcam=wcam, tw=tw, pts=pts, uv=uv, mask=mask, xw_t=xw_t)


CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


def assert_same_solve(port, ref, n_iter):
    """A port solve (cameras, points, state) against a JAX one: equal
    ``iter_num``, ``accepted`` and ``cg_iters``, loss to rtol 1e-8 (the rtol
    of tests/test_ba_wtt.py), cameras and points to rtol 1e-7 / atol 1e-9
    (CG reductions are summed in different orders)."""
    cams, pts, state = port
    jcams, jpts, jstate = ref
    assert state.iter_num == int(jstate.iter_num) == n_iter
    assert int(state.accepted) == int(jstate.accepted)
    assert state.cg_iters == int(jstate.cg_iters)
    np.testing.assert_allclose(float(state.loss), float(jstate.loss), rtol=1e-8)
    for name in CAM_FIELDS:
        np.testing.assert_allclose(to_np(getattr(cams, name)), to_np(getattr(jcams, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(to_np(pts), to_np(jpts), rtol=1e-7, atol=1e-9)
