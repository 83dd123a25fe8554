"""The probes of ``tpu3drecon_torch.experiments`` without a card: the plain
versions of their kernels, and their entry points' refusal to run on the
CPU (each times the card, so ``run()`` raises without one).

- E4 (``bits_expand``): both layouts' plain versions equal E4's numpy
  formulas (``experiments/tpu_bits_expand_probe.py:60-67``) exactly.
- E1 (``index_matvec2``): the plain versions of B2's copy equal B2's plain
  rows for the block-size variants, B2's rows with every real slot on
  window row 0 for ``no_gather``, and the per-point track sums of z for
  ``no_atomics``.
- E3 (``term_stack``): its inputs are E3's shapes, 10 % padded slots.
"""

import numpy as np
import pytest
import torch

from _torch_ref import wtt_kernel_inputs

from tpu3drecon_torch.experiments import (
    bits_expand,
    index_matvec2,
    index_matvec3,
    term_stack,
)
from tpu3drecon_torch.ops import wtt_linearize, wtt_matvec
from tpu3drecon_torch.ops._wtt_common import reduce_rows
from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig


@pytest.mark.parametrize("layout", bits_expand.LAYOUTS)
def test_bits_expand_plain_matches_numpy(layout):
    host = bits_expand.packed_input()
    assert host.shape == (100, 128) and host.dtype == np.uint8
    before = (bits_expand._counter(layout).kernel, bits_expand._counter(layout).plain)
    got = bits_expand.bits_expand(torch.as_tensor(host), layout)
    assert got.shape == (100, 1024) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), bits_expand.numpy_expand(host, layout))
    assert (bits_expand._counter(layout).kernel,
            bits_expand._counter(layout).plain) == (before[0], before[1] + 1)


def _mv_inputs():
    d = wtt_kernel_inputs(2, 128, 3, 8, seed=5)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    _, jc, jp, v_inv, _, _ = wtt_linearize.wtt_linearize_fused_idx(
        t["wcam"], t["tw"], t["pts"], t["uv"], t["mask"], torch.tensor(1e-3, dtype=torch.float64),
        torch.tensor(1 / 1280, dtype=torch.float64), BAConfig(), 8, True)
    return t["xw_t"], t["wcam"], jc, jp, v_inv


@pytest.mark.parametrize("variant", list(index_matvec2.VARIANTS))
def test_probe_coupling_plain_versions(variant):
    xw_t, wcam, jc, jp, v_inv = mv = _mv_inputs()
    got = index_matvec2.probe_coupling_rows(*mv, variant)
    b2 = wtt_matvec.wtt_coupling_rows_idx_plain(*mv)
    if variant.startswith("block"):
        np.testing.assert_array_equal(got.numpy(), b2.numpy())
    elif variant == "no_gather":
        row0 = torch.where(wcam >= 0, torch.zeros_like(wcam), wcam)
        np.testing.assert_array_equal(
            got.numpy(), wtt_matvec.wtt_coupling_rows_idx_plain(xw_t, row0, jc, jp, v_inv).numpy())
        assert (got[:, :, 1:] == 0).all()
    else:
        assert got.shape == (2, 8, 128)
        # Each point's sum of z = jc (jp V^-1 W^T x) over its real slots.
        z = wtt_matvec._w_z(_sym3_matvec(v_inv, wtt_matvec._wt_x(xw_t, wcam, jc, jp)), jc, jp)
        z = z * (wcam >= 0).reshape(1, 2, 3, 128)
        want = z.sum(dim=2).transpose(0, 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(want.abs().max()))
        # Reduced into the window rows, the slots' z give B2's rows.
        np.testing.assert_allclose(
            reduce_rows(z, wcam, 128).transpose(1, 2).numpy(), b2.numpy(), rtol=1e-10,
            atol=1e-12 * float(b2.abs().max()))


def test_term_stack_inputs():
    xw, wcam, jc, jp, v_inv = term_stack.inputs("cpu")
    assert xw.shape == (48, 8, 256) and wcam.shape == (48, 4 * 2560)
    assert jc.shape == (16, 48, 4, 2560) and v_inv.shape == (6, 48, 2560)
    assert wcam.dtype == torch.int16 and jc.dtype == torch.float32
    assert 0.09 < float((wcam < 0).float().mean()) < 0.11


@pytest.mark.parametrize("run", [index_matvec2.run, index_matvec3.run, term_stack.run,
                                 bits_expand.run])
def test_probes_need_a_card(monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
