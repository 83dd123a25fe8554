"""The port's command line (``python -m tpu3drecon_torch``), case by case as
tests/test_cli.py holds JAX's, with ``--cpu``: solve-bal on every engine
(each output file holding the solution that JAX's CLI writes for the same
input and flags at ``--f64``: points and tvecs to atol 1e-6), the
preconditioner and kernel-flag validation and the auto rules (read "on
the card" where JAX reads "on the TPU"), the wtt -> grid fallback, the
solve-colmap write-back (against JAX's too), ``info``, and a checkpointed
solve killed with SIGKILL and resumed (a subprocess with a deadline).
Also ``bench --cpu`` (the medium configuration's line, at a small size),
what the port does not take (``--aot``, no card without ``--cpu``), and
the small tools: ``config``, ``utils.timing``,
``utils.checkpoint``.
"""

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_bal import _make_bal_scene

from tpu3drecon.cli import main as jax_main

from tpu3drecon_torch import config as t_config
from tpu3drecon_torch.cli import _config, _split_windows_arg, main
from tpu3drecon_torch.io.bal import ba_problem_from_bal, write_bal
from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse
from tpu3drecon_torch.utils import checkpoint, timing

REPO = Path(__file__).resolve().parents[1]
ENGINES = ["flat", "tt", "wtt", "grid", "pallas"]


@pytest.fixture(scope="module")
def bal_file(tmp_path_factory):
    cam_idx, pt_idx, uv, cam_params, points = _make_bal_scene(seed=131)
    # Noisy init so the solve has work to do.
    rng = np.random.default_rng(2)
    points = points + rng.normal(scale=0.01, size=points.shape)
    path = tmp_path_factory.mktemp("cli") / "p.txt"
    write_bal(str(path), cam_idx, pt_idx, uv, cam_params, points)
    return str(path)


def _load(path):
    return ba_problem_from_bal(str(path), dtype=torch.float64, device="cpu")[0]


def _rmse(path) -> float:
    solved = _load(path)
    return float(reprojection_rmse(solved, solved.cameras, solved.points3d))


def _same_solution(path, ref_path, atol=1e-6):
    got, want = _load(path), _load(ref_path)
    np.testing.assert_allclose(got.points3d.numpy(), want.points3d.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(got.cameras.tvecs.numpy(), want.cameras.tvecs.numpy(), rtol=0,
                               atol=atol)


SOLVE = ["--cpu", "--maxiter", "15", "--no-focal", "--f64"]


def test_solve_bal_writes_output(bal_file, tmp_path):
    out = tmp_path / "solved.txt"
    assert main(["solve-bal", bal_file, "-o", str(out), *SOLVE]) == 0
    assert _rmse(out) < 0.05


@pytest.mark.parametrize("engine", ENGINES)
def test_solve_bal_engines_match_jax_cli(bal_file, tmp_path, engine):
    out, ref = tmp_path / f"solved_{engine}.txt", tmp_path / f"jax_{engine}.txt"
    assert main(["solve-bal", bal_file, "-o", str(out), *SOLVE, "--engine", engine]) == 0
    assert _rmse(out) < 0.05
    assert jax_main(["solve-bal", bal_file, "-o", str(ref), *SOLVE, "--engine", engine]) == 0
    _same_solution(out, ref)


@pytest.mark.parametrize("engine", ["flat", "wtt"])
def test_solve_prints_the_phases_line(bal_file, tmp_path, capsys, engine):
    """After the report line, one line: the packing and kernel-build
    seconds, the timed solve's host ms per LM phase and its sync waits."""
    out = tmp_path / "solved.txt"
    assert main(["solve-bal", bal_file, "-o", str(out), "--cpu", "--maxiter", "3",
                 "--engine", engine]) == 0
    err = capsys.readouterr().err.splitlines()
    report = next(i for i, line in enumerate(err) if "iters accepted, solve" in line)
    line = err[report + 1]
    assert line.startswith("[tpu3drecon_torch] phases: pack ")
    assert "build 0.00s (0 compiles)" in line  # no kernel build on the CPU
    assert "solve host ms over 3 LM iterations: lm.linearize " in line
    for phase in ("lm.rhs", "pcg", "lm.backsub", "lm.apply", "lm.cost", "lm.update"):
        assert f", {phase} " in line, phase
    assert "sync waits: " in line and "cg_converged " in line and "lm_converged 3x " in line
    pack_s = float(line.split("phases: pack ")[1].split("s,")[0])
    assert pack_s > 0.0 if engine == "wtt" else pack_s == 0.0  # flat packs nothing


def test_solve_bal_precond_flag(bal_file, tmp_path):
    """--precond ssor drives the band preconditioner end to end (tt)."""
    out = tmp_path / "solved_ssor.txt"
    assert main(["solve-bal", bal_file, "-o", str(out), *SOLVE, "--engine", "tt",
                 "--precond", "ssor"]) == 0
    assert _rmse(out) < 0.05


def test_precond_engine_validation(bal_file, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["solve-bal", bal_file, "-o", str(tmp_path / "x.txt"), "--cpu", "--engine",
              "flat", "--precond", "ssor"])
    assert exc.value.code == 2
    assert "requires --engine tt or wtt" in capsys.readouterr().err


def _args(engine, precond="auto", matvec="auto", linearize="auto", split_windows="auto",
          cpu=True):
    return argparse.Namespace(
        engine=engine, precond=precond, matvec=matvec, linearize=linearize,
        split_windows=split_windows, maxiter=5, cg_maxiter=8, no_focal=False,
        loss="trivial", cpu=cpu,
    )


def test_precond_auto_selection():
    """auto = ssor for the track-table engines at >= 1000 cameras,
    schur_jacobi otherwise (JAX's rule)."""
    assert _config(_args("wtt"), n_cameras=1712).precond == "ssor"
    assert _config(_args("tt"), n_cameras=1712).precond == "ssor"
    assert _config(_args("wtt"), n_cameras=100).precond == "schur_jacobi"
    assert _config(_args("pallas"), n_cameras=1712).precond == "schur_jacobi"
    assert _config(_args("wtt", "schur_jacobi"), n_cameras=1712).precond == "schur_jacobi"
    assert _config(_args("tt", "tridiag"), n_cameras=10).precond == "tridiag"


def test_kernel_flag_validation():
    for bad in (dict(matvec="index"), dict(linearize="index"), dict(split_windows="on"),
                dict(split_windows=6)):
        with pytest.raises(SystemExit) as exc:
            _config(_args("tt", **bad), n_cameras=100)
        assert exc.value.code == 2
    with pytest.raises(SystemExit):
        _config(_args("grid", split_windows="off"), n_cameras=100)
    assert _split_windows_arg("auto") == "auto"
    assert _split_windows_arg("6") == 6
    for bad in ("0", "-3", "always"):
        with pytest.raises(argparse.ArgumentTypeError):
            _split_windows_arg(bad)
    # auto: the PyTorch products on the CPU, the index kernels on the card.
    cfg = _config(_args("wtt"), n_cameras=100)
    assert cfg.matvec_kernel is False and cfg.linearize_kernel is False
    cfg = _config(_args("wtt", cpu=False), n_cameras=100)
    assert cfg.matvec_kernel == "index" and cfg.linearize_kernel == "index"
    assert _config(_args("tt", cpu=False), n_cameras=100).matvec_kernel is False
    cfg = _config(_args("wtt", precond="schur_jacobi", matvec="index", linearize="index"),
                  n_cameras=100)
    assert cfg.matvec_kernel == "index" and cfg.linearize_kernel == "index"


def test_solve_bal_wtt_infeasible_falls_back_to_grid(bal_file, tmp_path, monkeypatch,
                                                    capsys):
    import tpu3drecon_torch.problems.wtt as wtt_mod

    def infeasible(*a, **k):
        raise ValueError("windowed one-hots would be 99.00 GB (simulated)")

    monkeypatch.setattr(wtt_mod, "wtt_from_flat", infeasible)
    out = tmp_path / "solved_fallback.txt"
    assert main(["solve-bal", bal_file, "-o", str(out), *SOLVE, "--engine", "wtt"]) == 0
    err = capsys.readouterr().err
    assert "falling back to the grid engine" in err
    assert "grid engine on cpu" in err
    assert _rmse(out) < 0.05


def test_solve_colmap_writeback(tmp_path):
    from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene, scene_to_colmap_model
    from tpu3drecon_torch.io import colmap as cio
    from tpu3drecon_torch.problems.packing import ba_problem_from_colmap

    scene = make_scene(n_cameras=5, n_points=200, seed=7)
    noisy = perturb_scene(scene, seed=8, point2d_noise=0.0)
    model = scene_to_colmap_model(dataclasses.replace(noisy, uv=scene.uv))
    src, dst, ref = tmp_path / "sparse", tmp_path / "sparse_opt", tmp_path / "sparse_jax"
    cio.write_model(model, str(src), binary=True)
    flags = ["--binary", "--cpu", "--maxiter", "25", "--f64"]
    assert main(["solve-colmap", str(src), "-o", str(dst), *flags]) == 0
    solved = cio.read_model(str(dst))
    np.testing.assert_array_equal(solved.points.ids, model.points.ids)
    assert not np.allclose(np.asarray(solved.points.xyz), np.asarray(model.points.xyz))
    problem, _ = ba_problem_from_colmap(solved, dtype=torch.float64, device="cpu")
    assert float(reprojection_rmse(problem, problem.cameras, problem.points3d)) < 1e-3
    assert jax_main(["solve-colmap", str(src), "-o", str(ref), *flags]) == 0
    want = cio.read_model(str(ref))
    np.testing.assert_allclose(np.asarray(solved.points.xyz), np.asarray(want.points.xyz),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(solved.images.tvecs), np.asarray(want.images.tvecs),
                               rtol=0, atol=1e-6)


def test_info_runs(capsys):
    assert main(["info"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["native_io"] in (True, False)
    assert "sharded_wtt" in payload["engines"] and payload["torch"] == torch.__version__


def test_what_the_port_does_not_take(bal_file, tmp_path, capsys):
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        main(["solve-bal", bal_file, *SOLVE, "--aot"])
    if not torch.cuda.is_available():  # no card and no --cpu: an error
        for argv in (["solve-bal", bal_file, "--f64"], ["bench"]):
            with pytest.raises(SystemExit) as exc:
                main(argv)
            assert exc.value.code == 2
            assert "no CUDA device" in capsys.readouterr().err


def test_bench_prints_the_medium_line(monkeypatch, capsys):
    """``bench --cpu`` prints ``run_medium``'s JSON line (2 timed solves on
    the CPU), here at a small size: the wtt engine's plain versions bring the
    reprojection RMSE below 1e-2 px (the 1e-3 px target is the full size's,
    held on the card)."""
    import functools

    from tpu3drecon_torch.benchmark import suite

    calls = []

    def small(**kw):
        calls.append(kw)
        return run_medium(n_cameras=6, n_points=300, obs_per_camera=120, **kw)

    run_medium = suite.run_medium
    monkeypatch.setattr(suite, "run_medium", functools.wraps(run_medium)(small))
    assert main(["bench", "--cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [{"reps": 2, "device": torch.device("cpu")}]
    assert line["metric"] == "ba_medium_100cam_100kpt_30lm_iters"
    assert line["extra"]["engine"] == "wtt" and line["extra"]["backend"] == "cpu"
    assert line["extra"]["reps"] == 2 and line["vs_baseline"] is None
    assert line["extra"]["reproj_rmse_px"] < 1e-2


def test_checkpoint_kill_and_resume(bal_file, tmp_path):
    """A killed chunked CLI solve resumes from its checkpoint to the same
    final solution as an uninterrupted chunked run."""

    def cmd(ckdir, out):
        # cg_maxiter 2 = inexact steps: the solve cannot converge inside
        # one chunk, so every run walks all four chunk boundaries.
        return [sys.executable, "-m", "tpu3drecon_torch", "solve-bal", bal_file,
                "-o", str(out), "--cpu", "--f64", "--maxiter", "12", "--cg-maxiter", "2",
                "--checkpoint-every", "3", "--checkpoint-dir", str(ckdir)]

    ref_out = tmp_path / "ref.txt"
    subprocess.run(cmd(tmp_path / "ck_ref", ref_out), check=True, cwd=REPO, timeout=300)

    # Victim: SIGKILL as soon as the first checkpoint lands; the
    # fault-injection delay holds the process after each checkpoint.
    ckdir, out = tmp_path / "ck", tmp_path / "solved.txt"
    env = dict(os.environ, **{checkpoint.DELAY_ENV: "5"})
    proc = subprocess.Popen(cmd(ckdir, out), cwd=REPO, env=env)
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if checkpoint.latest_step(str(ckdir)) is not None:
                break
            if proc.poll() is not None:
                pytest.fail("solve finished before the kill window")
            time.sleep(0.2)
        else:
            pytest.fail("no checkpoint appeared in time")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert not out.exists()  # killed before writing the solution
    assert checkpoint.latest_step(str(ckdir)) == 3

    subprocess.run(cmd(ckdir, out), check=True, cwd=REPO, timeout=300)
    assert checkpoint.latest_step(str(ckdir)) == 12
    _same_solution(out, ref_out, atol=1e-9)


def test_checkpoint_round_trip_and_packed_layouts(tmp_path):
    from tpu3drecon_torch.dataset import synthetic as syn
    from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat
    from tpu3drecon_torch.problems.wtt import wtt_from_flat

    state = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4, dtype=torch.float64)}
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    checkpoint.save_state(state, str(tmp_path), 3)
    checkpoint.save_state({k: v * 2 for k, v in state.items()}, str(tmp_path), 10)
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_3"]  # no temporary left
    assert checkpoint.latest_step(str(tmp_path)) == 10
    back = checkpoint.restore_state(None, str(tmp_path), step=3)
    assert all(torch.equal(back[k], state[k]) for k in state)
    typed = checkpoint.restore_state({"a": torch.zeros(2, 3, dtype=torch.float64),
                                      "b": torch.zeros(4)}, str(tmp_path))
    assert typed["a"].dtype == torch.float64 and torch.equal(typed["b"], torch.full((4,), 2.0))

    scene = syn.make_sequential_scene(n_cameras=24, points_per_camera=25, track_span=3, seed=5)
    flat, _ = syn.scene_to_ba_problem(syn.perturb_scene(scene, seed=6), dtype=torch.float64,
                                      device="cpu")
    cams = dataclasses.replace(flat.cameras, tvecs=flat.cameras.tvecs + 1.0)
    pts = flat.points3d + 2.0
    for packed in (grid_bucketed_from_flat(flat, point_block=64),
                   wtt_from_flat(flat, point_chunk=32, reorder_cameras="always")):
        new = checkpoint.update_problem_solution(packed, cams, pts)
        rows = packed.point_rows.long()
        real = rows >= 0
        assert torch.equal(new.points3d[real], pts[rows[real]])
        assert torch.all(new.points3d[~real] == 0)
        cam_rows = getattr(packed, "cam_rows", None)
        want = cams.tvecs if cam_rows is None else cams.tvecs[cam_rows.long()]
        assert torch.equal(new.cameras.tvecs, want)


def test_config_tree():
    cfg = t_config.RunConfig()
    assert cfg.solver.loss == "cauchy" and cfg.mesh.axis_name == "obs"
    assert cfg.results_root == t_config.BENCHMARK_RESULTS_PATH
    assert Path(t_config.REPO_PATH) == REPO
    assert t_config.BENCHMARK_SINGLE_POSE_RESULTS_PATH.startswith(t_config.BENCHMARK_RESULTS_PATH)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.solver.maxiter = 1


def test_timing_helpers():
    timer = timing.CompileRunTimer()
    out = timer.measure(lambda x: (x * 2, [x + 1]), torch.ones(3), repeats=2)
    assert torch.equal(out[0], torch.full((3,), 2.0))
    assert len(timer.run_times) == 2 and timer.compile_time >= 0.0
    assert timer.best_run == min(timer.run_times)
    timing.device_sync({"cpu": torch.ones(2)})  # nothing to wait for on the CPU
    timing.reset()
    with timing.recording():
        with timing.span("x"):
            pass
    assert timing.tally()["spans"]["x"]["s"] >= 0.0
    timing.reset()
