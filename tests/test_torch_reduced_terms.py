"""The reduced-fidelity modes of the wtt engine, port vs JAX reference.

The TPU kernels split a float32 operand into ``terms`` bfloat16 pieces for
their one-hot dots: B2 (``wtt_coupling_rows_idx``) at ``terms`` 1 and 2 is
``matvec_kernel="index1"`` / ``"index2"``, B1 (``wtt_linearize_fused_idx``)
at ``terms=2`` is ``linearize_kernel="index2"`` (its rhs columns stay at 3,
exact).  The port rounds the same values through the same pieces
(``ops._wtt_common.split_round``); float64 is never split.

- Kernel level, float32, the plain versions against JAX's Pallas kernels
  in interpret mode: within 5e-6 of max|JAX| (the JAX kernels sum each
  split piece over the slots and then fold, the port folds per slot: f32
  re-association).  B2's inputs are ``tests/test_pallas_kernels.py``'s
  coupling inputs, where a single term stays off the exact rows by more
  than 1e-5 relative, JAX's own ladder.
- Solve level: in float64 each mode gives JAX's trajectory (same
  ``iter_num``, ``accepted``, ``cg_iters``; loss rtol 1e-8, parameters rtol
  1e-7); in float32 ``index1`` reaches the bound of
  ``tests/test_ba_wtt.py``'s index1 test.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import SEQ_DISTS, assert_same_solve, np_fields, seq_scene_kwargs, wtt_kernel_inputs
from test_torch_wtt_od import _seq_inputs

from tpu3drecon.dataset import synthetic as j_syn
from tpu3drecon.ops.pallas.wtt_linearize import wtt_linearize_fused_idx as j_lin
from tpu3drecon.ops.pallas.wtt_matvec import wtt_coupling_rows_idx as j_coupling
from tpu3drecon.problems.wtt import wtt_from_flat as j_wtt
from tpu3drecon.solvers.ba_wtt import ba_solve_wtt as j_solve
from tpu3drecon.solvers.bundle_adjust import BAConfig as JConfig

from tpu3drecon_torch.dataset import synthetic as t_syn
from tpu3drecon_torch.ops import wtt_linearize, wtt_matvec
from tpu3drecon_torch.ops._wtt_common import split_round
from tpu3drecon_torch.problems.convert import wtt_problem_from_numpy
from tpu3drecon_torch.problems.wtt import wtt_from_flat as t_wtt
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt as t_solve
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig as TConfig

REL = 5e-6  # of max|JAX|, float32
LAM = 1e-3
LAM_B1 = 0.1  # see test_linearize_terms2_matches_pallas
LIN_OUTS = ("rows", "jc", "jp", "v_inv", "g_pt", "damp_pt")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_split_round_pieces():
    """Round to nearest even through bfloat16: 1 + 2^-8 is a tie (-> 1), one
    more bit rounds up; two pieces keep 16 bits, three are exact; float64
    passes unchanged."""
    x = torch.tensor([1 + 2**-8, 1 + 2**-8 + 2**-16, 1 + 2**-9 + 2**-20, 3.1415927],
                     dtype=torch.float32)
    t1 = split_round(x, 1)
    assert t1[0] == 1.0 and t1[1] == 1 + 2**-7
    t2 = split_round(x, 2)
    assert t2[2] == 1 + 2**-9 and torch.equal(t2[:2], x[:2])
    assert torch.equal(split_round(x, 3), x)
    assert (split_round(x, 2) - x).abs().max() <= 2**-16 * x.abs().max()
    x64 = x.double() + 1e-12
    assert torch.equal(split_round(x64, 1), x64)


@functools.lru_cache(maxsize=None)
def _coupling_inputs():
    """tests/test_pallas_kernels.py's TestStackedSplitDots inputs."""
    g, tb, pc, w, np_cam = 4, 3, 256, 128, 8
    rng = np.random.default_rng(7)
    jc = rng.normal(size=(2 * np_cam, g, tb, pc))
    jp = rng.normal(size=(6, g, tb, pc))
    v_inv = rng.normal(size=(6, g, pc))
    wcam = rng.integers(0, w, size=(g, tb * pc)).astype(np.int32)
    wcam[rng.random(size=wcam.shape) < 0.1] = -1
    xw = rng.normal(size=(g, np_cam, w))
    return dict(jc=jc, jp=jp, v_inv=v_inv, wcam=wcam, xw=xw, dims=(g, tb, pc, w, np_cam))


def _jax_rows(d, dtype, terms):
    g, tb, pc, w, np_cam = d["dims"]
    return np.asarray(j_coupling(
        jnp.asarray(d["xw"], dtype), jnp.asarray(d["wcam"]), jnp.asarray(d["jc"], dtype),
        jnp.asarray(d["jp"], dtype), jnp.asarray(d["v_inv"], dtype), np_cam, tb, pc, w,
        terms=terms, interpret=True,
    ), np.float64)


def _port_rows(d, dtype, terms):
    args = [torch.as_tensor(d[k]).to(dtype) for k in ("xw", "wcam", "jc", "jp", "v_inv")]
    args[1] = args[1].to(torch.int16)
    return wtt_matvec.wtt_coupling_rows_idx(*args, terms=terms)


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_coupling_terms_match_pallas(terms):
    d = _coupling_inputs()
    counter = {1: wtt_matvec.COUPLING1_COUNTS, 2: wtt_matvec.COUPLING2_COUNTS,
               3: wtt_matvec.COUPLING_COUNTS}[terms]
    before = (counter.kernel, counter.plain)
    got = _port_rows(d, torch.float32, terms)
    assert got.dtype == torch.float32
    assert (counter.kernel, counter.plain) == (before[0], before[1] + 1)
    assert _rel(got, _jax_rows(d, jnp.float32, terms)) < REL
    exact = _jax_rows(d, jnp.float64, 3)
    rel_exact = _rel(got, exact)
    if terms == 1:
        assert 1e-5 < rel_exact < 3e-2  # JAX's own ladder
    else:
        assert rel_exact < (1e-4 if terms == 2 else REL)
    # float64 is never split: every terms gives the exact rows.
    np.testing.assert_allclose(_port_rows(d, torch.float64, terms).numpy(), exact,
                               rtol=1e-10, atol=1e-12 * np.abs(exact).max())


def _lin_args(d, dtype, np_cam):
    return [torch.as_tensor(d[k]).to(dtype) if k != "wcam" else torch.as_tensor(d[k])
            for k in ("wcam", "tw", "pts", "uv", "mask")]


# (G, W, Tb, np, want_od, sequential tracks)
LIN_CASES = [(2, 128, 3, 8, False, False), (2, 256, 2, 10, False, False),
             (2, 128, 4, 8, True, True), (1, 256, 3, 10, True, True)]


@pytest.mark.parametrize("g,w,tb,np_cam,want_od,seq", LIN_CASES)
def test_linearize_terms2_matches_pallas(g, w, tb, np_cam, want_od, seq):
    """B1 at terms 2 in float32: every output within 5e-6 of max|JAX| of
    JAX's terms-2 kernel, the rhs columns also of JAX's terms-3 (exact)
    kernel and bit-equal to the port's terms-3 rhs.  The damping is 0.1: at
    1e-3 the f32 V^-1 of a point seen once is conditioned ~1/lam, and the
    two exact (terms-3) kernels already differ by 1.3e-5 of max|rows| on
    these inputs; at 0.1 they agree to 2e-7, so the bound sees the
    rounding."""
    d = (_seq_inputs if seq else wtt_kernel_inputs)(g, w, tb, np_cam, seed=31 * g + w + tb)
    flags = {"optimize_dist": np_cam == 10}
    jargs = [jnp.asarray(d[k], jnp.int32 if k == "wcam" else jnp.float32)
             for k in ("wcam", "tw", "pts", "uv", "mask")]

    def jax_lin(terms):
        return j_lin(*jargs, jnp.asarray(LAM_B1, jnp.float32), jnp.asarray(1 / 1280, jnp.float32),
                     JConfig(**flags), np_cam, tb, 128, w, True, want_od, terms=terms,
                     interpret=True)

    def port_lin(terms):
        return wtt_linearize.wtt_linearize_fused_idx(
            *_lin_args(d, torch.float32, np_cam), torch.tensor(LAM_B1, dtype=torch.float32),
            torch.tensor(1 / 1280, dtype=torch.float32), TConfig(**flags), np_cam, True,
            want_od, terms=terms)

    counter = wtt_linearize.TERMS2_OD_COUNTS if want_od else wtt_linearize.TERMS2_COUNTS
    before = counter.plain
    got, want = port_lin(2), jax_lin(2)
    assert counter.plain == before + 1
    for name, a, b in zip(LIN_OUTS, got, want):
        assert _rel(a, b) < REL, name
    n_sj = wtt_linearize.n_contrib_cols(np_cam, True)
    rhs = slice(n_sj, n_sj + np_cam)
    exact_rows = port_lin(3)[0]
    assert torch.equal(got[0][..., rhs], exact_rows[..., rhs])
    assert _rel(got[0][..., rhs], np.asarray(jax_lin(3)[0])[..., rhs]) < REL
    # The u | g | coupling (and od) columns are really rounded.
    assert not torch.equal(got[0][..., :n_sj], exact_rows[..., :n_sj])


def test_bad_terms_raise():
    d = _coupling_inputs()
    with pytest.raises(ValueError, match="terms"):
        _port_rows(d, torch.float32, 4)
    d = wtt_kernel_inputs(1, 128, 2, 8, seed=3)
    with pytest.raises(ValueError, match="terms"):
        wtt_linearize.wtt_linearize_fused_idx(
            *_lin_args(d, torch.float64, 8), torch.tensor(LAM, dtype=torch.float64),
            torch.tensor(1.0, dtype=torch.float64), TConfig(), 8, True, terms=1)


SOLVE = dict(maxiter=4, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4)
MODES = {
    "index1": dict(matvec_kernel="index1", linearize_kernel="index"),
    "index2": dict(matvec_kernel="index2", linearize_kernel="index"),
    "lin_index2": dict(matvec_kernel="index", linearize_kernel="index2"),
    "index2_index2": dict(matvec_kernel="index2", linearize_kernel="index2"),
}


@functools.lru_cache(maxsize=None)
def _jax_packed():
    scene = j_syn.make_sequential_scene(**seq_scene_kwargs(SEQ_DISTS["radial"]))
    noisy = j_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = j_syn.scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return j_wtt(flat, point_chunk=64, defer_onehot=True)


@pytest.mark.parametrize("mode", list(MODES))
def test_f64_trajectory_matches_jax(mode):
    cfg = dict(SOLVE, **MODES[mode])
    ref = j_solve(_jax_packed(), JConfig(**cfg))
    port = t_solve(wtt_problem_from_numpy(np_fields(_jax_packed()), device="cpu"),
                   TConfig(**cfg))
    assert_same_solve(port, ref, SOLVE["maxiter"])
    assert int(ref[2].accepted) >= 1


def test_f32_index1_converges():
    """tests/test_ba_wtt.py's index1 bound, in float32 (where index1 rounds):
    finite, and no worse than 10x the exact operator's loss (or 1e-6)."""
    scene = t_syn.make_sequential_scene(**seq_scene_kwargs(SEQ_DISTS["pinhole"]))
    noisy = t_syn.perturb_scene(scene, seed=6, point2d_noise=0.0)
    flat, _ = t_syn.scene_to_ba_problem(noisy, observed=scene, dtype=torch.float32,
                                        device="cpu")
    packed = t_wtt(flat, point_chunk=64)
    config = TConfig(maxiter=12, cg_maxiter=12, cg_rtol=1e-8)
    _, _, st_x = t_solve(packed, config)
    before = wtt_matvec.COUPLING1_COUNTS.plain
    _, _, st_k = t_solve(packed, config._replace(matvec_kernel="index1"))
    assert wtt_matvec.COUPLING1_COUNTS.plain > before
    assert np.isfinite(float(st_k.loss))
    assert float(st_k.loss) <= max(10.0 * float(st_x.loss), 1e-6)
