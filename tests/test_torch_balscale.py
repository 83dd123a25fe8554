"""The port's BAL-scale builder (``tpu3drecon_torch.benchmark.balscale``)
vs the JAX build pipeline of ``tpu3drecon/benchmark/balscale.py``, run
directly with the same arguments and no disk cache.

1712 cameras at 8 points per camera (the full camera count, a thin point
set): every packed array must be bit-equal, with RCM relabelling
(``shuffled``) and without.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import np_fields, to_np

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.problems.reorder import permute_cameras_flat as j_permute
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt

from tpu3drecon_torch.benchmark import balscale


def _jax_build(shuffled, points_per_camera=8, track_span=4, split_windows=False):
    """The body of the JAX ``bal_sequential_wtt`` build, without its cache."""
    scene = j_syn.make_sequential_scene(n_cameras=1712, points_per_camera=points_per_camera,
                                        track_span=track_span, seed=7)
    noisy = j_syn.perturb_scene(scene, seed=8, point2d_noise=0.5)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
    if shuffled:
        flat = j_permute(flat, np.random.default_rng(99).permutation(flat.n_cameras))
    kwargs = {"split_windows": split_windows} if split_windows else {}
    return j_wtt(flat, point_chunk=512, defer_onehot=True, **kwargs)


def _fields(obj):
    """A port dataclass as the nested dicts of ``np_fields``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            out[f.name] = [_fields(b) for b in v]
        elif isinstance(v, torch.Tensor):
            out[f.name] = to_np(v)
        else:
            out[f.name] = v
    return out


def _assert_bit_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_bit_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, f"{path}: {got.dtype} != {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("shuffled", [False, True], ids=["sequential", "shuffled"])
def test_bal_sequential_wtt_bit_equal(shuffled):
    got = balscale.bal_sequential_wtt(shuffled=shuffled, points_per_camera=8,
                                      verbose=False, device="cpu")
    want = _jax_build(shuffled)
    assert got.c_pad == want.c_pad == 1792
    assert (got.cam_rows is not None) == shuffled
    _assert_bit_equal(_fields(got), np_fields(want))


def test_bal_sequential_wtt_needs_a_card_and_refuses_split_windows(monkeypatch):
    """Without a card the builders raise; ``split_windows`` reaches the
    packer, as in the JAX builder: the split packing is bit-equal to JAX's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        balscale.bal_sequential_wtt(points_per_camera=8, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        balscale.bal_sequential_flat(points_per_camera=8)
    got = balscale.bal_sequential_wtt(points_per_camera=8, split_windows=True, verbose=False,
                                      device="cpu")
    want = _jax_build(False, split_windows=True)
    assert len(want.buckets) > 3  # more buckets than the unsplit packing's
    _assert_bit_equal(_fields(got), np_fields(want))
