"""The port's BASELINE.md suite (``tpu3drecon_torch.benchmark.suite``)
against JAX's ``tpu3drecon.benchmark.suite`` at the JAX tests' tiny sizes.

Each runner runs in both packages on the same config (the scenes come from
the same seeds).  The port's JSON must carry every key of JAX's, with
``vs_baseline`` null where JAX divides by a figure recorded on its TPU;
``n_obs``, ``matches_per_image`` and ``accepted_steps`` must be equal, and
the solutions must agree to float32 tolerances stated per runner (both
packages solve in f32, in different orders of operations).  ``run_medium``
runs at a small size, and ``run_suite`` / ``main`` hand each runner's
result on in order.
"""

import json

import numpy as np
import pytest
import torch

import _torch_ref  # noqa: F401  (one intra-op thread)

from tpu3drecon.benchmark import suite as j_suite

from tpu3drecon_torch.benchmark import suite as t_suite

CPU = "cpu"
TINY = {
    "pnp": dict(reps=1, n_cameras=2, n_points=300, seed=5),
    "small": dict(reps=2, n_cameras=4, n_points=400, seed=11),
    "tracking": dict(reps=2, n_frames=4, n_obs=120, seed=81),
    "bal": dict(reps=1, lm_iters=2, full_scale=False, ratio_cams=24, ratio_ppc=40),
}
RUNNERS = {"pnp": "run_pnp_parity", "small": "run_small_ba", "tracking": "run_tracking",
           "bal": "run_bal"}
UNITS = {"pnp": "s", "small": "px", "tracking": "ms/frame", "bal": "s/LM-iter"}


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, kw in TINY.items():
        out[name] = (getattr(j_suite, RUNNERS[name])(**kw),
                     getattr(t_suite, RUNNERS[name])(device=CPU, **kw))
    return out


def _check_schema(res, unit):
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert res["unit"] == unit
    for key in ("median_s", "min_s", "max_s", "reps", "compile_s"):
        assert key in res["extra"], key
    assert res["extra"]["min_s"] <= res["extra"]["median_s"] <= res["extra"]["max_s"]


@pytest.mark.parametrize("name", list(TINY))
def test_keys_and_baselines(results, name):
    """JAX's keys, JAX's metric names; no figure recorded on a TPU: where
    JAX divides by one (tracking, BAL) the port writes null."""
    j, t = results[name]
    _check_schema(t, UNITS[name])
    assert t["metric"] == j["metric"]
    assert set(j["extra"]) <= set(t["extra"])
    assert t["extra"]["device"] == "cpu"
    assert "TPU" not in json.dumps(t)
    if name in ("tracking", "bal"):
        assert "TPU" in j["extra"]["baseline_desc"] and t["vs_baseline"] is None
    else:
        assert t["vs_baseline"] > 0


def test_pnp_parity_matches_jax(results):
    j, t = results["pnp"]
    je, te = j["extra"], t["extra"]
    assert te["matches_per_image"] == je["matches_per_image"] == 300
    assert te["n_cameras"] == 2
    # Parity against the in-run scipy oracle at the BASELINE f32 bar, and
    # the two packages' distances from it agree to f32 tolerance.
    assert te["max_rot_geodesic_err_vs_scipy_rad"] < 1e-4
    assert te["max_tvec_err_vs_scipy"] < 2e-3
    assert abs(te["max_tvec_err_vs_scipy"] - je["max_tvec_err_vs_scipy"]) < 1e-5
    assert abs(te["max_rot_geodesic_err_vs_scipy_rad"]
               - je["max_rot_geodesic_err_vs_scipy_rad"]) < 1e-6
    assert te["scipy_oracle_s"] > 0
    assert 0.0 <= te["device_s"] <= te["median_s"]
    assert te["dispatch_overhead_s"] >= 0.0 and te["marginal_s_per_lm_iter"] >= 0.0


def test_small_ba_matches_jax(results):
    """The RMSE sits at the f32 floor of 1000-px coordinates (~6e-4 px):
    both below the 1e-3 px target and within 5e-5 px of each other."""
    j, t = results["small"]
    assert t["extra"]["accepted_steps"] == j["extra"]["accepted_steps"]
    assert t["value"] < 1e-3 and t["vs_baseline"] > 1.0
    assert abs(t["value"] - j["value"]) < 5e-5


def test_tracking_matches_jax(results):
    j, t = results["tracking"]
    assert t["extra"]["median_tvec_err"] < 1e-3
    assert abs(t["extra"]["median_tvec_err"] - j["extra"]["median_tvec_err"]) < 1e-6
    assert t["extra"]["single_executable"] is True
    assert t["extra"]["n_frames"] == 4 and t["extra"]["obs_per_frame"] == 120


def test_bal_ratio_matches_jax(results):
    """The same packing (n_obs), the same accepted steps, and the loss after
    two fixed-work LM iterations to rtol 1e-3 (f32)."""
    j, t = results["bal"]
    je, te = j["extra"], t["extra"]
    assert te["full_scale"] is False and te["split_windows"] is False
    assert te["n_obs"] == je["n_obs"]
    assert te["accepted_steps"] == je["accepted_steps"] >= 1
    assert np.isfinite(te["loss"]) and te["loss"] < te["initial_loss"]
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-3)


def test_run_medium_small():
    res = t_suite.run_medium(reps=2, device=CPU, n_cameras=6, n_points=300,
                             obs_per_camera=120, cg=6)
    _check_schema(res, "s")
    ex = res["extra"]
    assert res["metric"] == "ba_medium_100cam_100kpt_30lm_iters"
    assert res["vs_baseline"] is None and ex["engine"] == "wtt" and ex["backend"] == "cpu"
    assert ex["n_obs"] == 6 * 120 and ex["cg_maxiter"] == 6 and ex["accepted_steps"] >= 1
    assert ex["reproj_rmse_px"] < 1e-2


def test_runners_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("run_pnp_parity", "run_small_ba", "run_medium", "run_tracking", "run_bal"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(t_suite, name)()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_suite.run_suite()


def test_run_suite_and_main_emit_every_config_in_order(monkeypatch, capsys):
    calls = []

    def fake(name):
        def run(**kw):
            calls.append((name, kw))
            return {"metric": name}
        return run

    for name in ("run_pnp_parity", "run_small_ba", "run_medium", "run_tracking", "run_bal"):
        monkeypatch.setattr(t_suite, name, fake(name))
    got = []
    t_suite.run_suite(force_cpu=True, cg=5, emit=got.append)
    assert [r["metric"] for r in got] == ["run_pnp_parity", "run_small_ba", "run_medium",
                                          "run_tracking", "run_bal"]
    kws = dict(calls)
    assert all(kw["device"] == torch.device("cpu") for kw in kws.values())
    assert kws["run_medium"] == {"reps": 2, "cg": 5, "device": torch.device("cpu")}
    assert kws["run_bal"]["full_scale"] is False and kws["run_tracking"]["reps"] == 2
    assert t_suite.main(["--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["metric"] for x in lines] == [r["metric"] for r in got]
