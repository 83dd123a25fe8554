"""The flat engine with BAL's radial camera optimized (``ba_solve`` with
``optimize_dist``): 10 camera columns ``so3 | t | fx fy | k1 k2``.

Held on the CPU in float64, with no JAX oracle (the JAX package's flat
``ba_solve`` holds k1 and k2 fixed):

- the k1, k2 columns of J_c against central differences of the residual;
- ``linearize_plain``'s sums at 10 columns against sums built by hand from
  those blocks;
- the solve against the port's ``ba_solve_wtt`` at np = 10 on the same
  problem, iteration by iteration;
- the solve judged ``correct`` by the benchmark's plain reference
  (``portbench/reference.py``) under ``final13682_radial.flat``'s limits,
  at a small cut of that cell's configuration;
- the 8-column route's shapes without ``optimize_dist``;
- ``solve-bal --optimize-dist`` moving a BAL file's k1, k2.

The card's kernels at 10 columns are held to this plain route in
``tests/test_torch_flat_kernels.py``.
"""

import copy
import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops import flat_linearize as fl
from tpu3drecon_torch.ops.jacobians import gather_obs_blocks
from tpu3drecon_torch.problems.wtt import wtt_from_flat
from tpu3drecon_torch.solvers import schur
from tpu3drecon_torch.solvers.ba_wtt import ba_solve_wtt
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, ba_solve

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
CELL = "final13682_radial.flat"
# The benchmark's configuration cut to a graph the CPU holds in seconds.
SMALL_GRAPH = dict(n_locals=60, n_hubs=4, points_per_camera=60, hub_obs=300)
TRAJ = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=1e-10,
                optimize_dist=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed: int = 11):
    """A ring scene with radial distortion, observed with 0.5 px noise,
    started from perturbed poses, points and focal lengths and from k1, k2
    moved per camera off the truth (0.02, -0.002)."""
    scene = make_scene(n_cameras=10, n_points=800, obs_per_camera=400, seed=seed,
                       dist=(0.02, -0.002))
    observed = perturb_scene(scene, 0.0, 0.0, 0.0, 0.0, point2d_noise=0.5, seed=seed + 1)
    start = perturb_scene(scene, point2d_noise=0.0, seed=seed + 2)
    problem = scene_to_ba_problem(start, observed=observed, dtype=F64, device="cpu")[0]
    rng = np.random.default_rng(seed + 3)
    c = problem.n_cameras
    shift = np.column_stack([rng.uniform(-0.01, 0.01, c), rng.uniform(-0.002, 0.002, c)])
    cams = dataclasses.replace(problem.cameras,
                               dist=problem.cameras.dist + torch.tensor(shift, dtype=F64))
    return dataclasses.replace(problem, cameras=cams)


def _flat_args(problem):
    """``fl.linearize``'s arguments through ``inv_width``."""
    cams = problem.cameras
    return (cams.rmats, cams.tvecs, cams.fx_fy, cams.cx_cy_skew, cams.dist,
            problem.points3d, problem.cam_idx, problem.pt_idx, problem.uv, problem.mask,
            1.0 / problem.avg_cam_width)


def _residual(args, dist):
    a = list(args)
    a[4] = dist
    return gather_obs_blocks(*a).residual


def test_dist_columns_match_central_differences():
    problem = _problem()
    args = _flat_args(problem)
    blocks = gather_obs_blocks(*args, RobustLoss.TRIVIAL, True)
    plain = gather_obs_blocks(*args)
    assert blocks.j_cam.shape[1:] == (2, 10)
    # The first 8 columns, the residual and J_p are the 8-column blocks' own.
    assert torch.equal(blocks.j_cam[:, :, :8], plain.j_cam)
    assert torch.equal(blocks.residual, plain.residual)
    assert torch.equal(blocks.j_pt, plain.j_pt)
    dist = problem.cameras.dist
    live = problem.mask > 0
    for col, h in ((0, 1e-6), (1, 1e-7)):
        step = torch.zeros_like(dist)
        step[:, col] = h
        fd = (_residual(args, dist + step) - _residual(args, dist - step)) / (2 * h)
        got = blocks.j_cam[:, :, 8 + col]
        scale = got[live].abs().max()
        assert scale > 0
        assert (fd - got)[live].abs().max() <= 1e-6 * scale, col
        assert not got[~live].any()


@pytest.mark.parametrize("loss,focal", [(RobustLoss.TRIVIAL, True),
                                        (RobustLoss.CAUCHY, False)])
def test_plain_sums_at_ten_columns_are_the_hand_sums(loss, focal):
    problem = _problem(seed=21)
    args = _flat_args(problem)
    c, p = problem.n_cameras, problem.n_points
    r, jc, jp = fl.flat_blocks(*args, loss, focal, True, optimize_dist=True)
    assert jc.shape[1:] == (2, 10)
    if not focal:  # the focal columns alone are zeroed; k1, k2 stay
        assert not jc[:, :, 6:8].any() and jc[:, :, 8:].abs().max() > 0
    sums = fl.linearize_plain(*args, c, p, loss=loss, optimize_focal=focal,
                              optimize_dist=True)
    ci, pi = problem.cam_idx.long(), problem.pt_idx.long()

    def seg(per_obs, idx, num):
        return per_obs.new_zeros((num,) + per_obs.shape[1:]).index_add_(0, idx, per_obs)

    want = dict(
        u=seg(torch.einsum("nki,nkj->nij", jc, jc), ci, c),
        v=seg(torch.einsum("nki,nkj->nij", jp, jp), pi, p),
        w=torch.einsum("nki,nkl->nil", jc, jp),
        g_cam=seg(torch.einsum("nki,nk->ni", jc, r), ci, c),
        g_pt=seg(torch.einsum("nki,nk->ni", jp, r), pi, p),
    )
    for name, value in want.items():
        torch.testing.assert_close(getattr(sums, name), value, rtol=1e-12, atol=1e-12,
                                   msg=name)
    v_inv = torch.linalg.inv(want["v"] + torch.eye(3, dtype=F64))
    coupling = seg(torch.einsum("nik,nkl,njl->nij", want["w"], v_inv[pi], want["w"]), ci, c)
    torch.testing.assert_close(sums.coupling(v_inv), coupling, rtol=1e-12, atol=1e-12)
    nb = schur.damp_normal_blocks(sums, torch.tensor(1e-4, dtype=F64))
    assert nb.u_chol.shape == (c, 10, 10) and nb.damp_cam.shape == (c, 10)


def test_eight_column_route_keeps_its_shapes():
    problem = _problem(seed=31)
    args = _flat_args(problem)
    c, p, n = problem.n_cameras, problem.n_points, problem.uv.shape[0]
    r, jc, jp = fl.flat_blocks(*args, RobustLoss.TRIVIAL, True, True)
    assert jc.shape == (n, 2, 8) and jp.shape == (n, 2, 3) and r.shape == (n, 2)
    sums = fl.linearize(*args, c, p)
    assert sums.u.shape == (c, 8, 8) and sums.w.shape == (n, 8, 3)
    assert sums.g_cam.shape == (c, 8) and sums.coupling(
        torch.eye(3, dtype=F64).expand(p, 3, 3)).shape == (c, 8, 8)
    # Without optimize_dist the solve returns k1, k2 as given.
    cams, _, _ = ba_solve(problem, TRAJ._replace(optimize_dist=False, maxiter=2), device="cpu")
    assert torch.equal(cams.dist, problem.cameras.dist)


@pytest.fixture(scope="module")
def trajectories():
    """Per maxiter 1..3, the flat and the wtt solve at 10 columns."""
    torch.set_num_threads(1)
    problem = _problem(seed=41)
    packed = wtt_from_flat(problem)
    out = {}
    for it in (1, 2, 3):
        config = TRAJ._replace(maxiter=it)
        out[it] = (ba_solve(problem, config, device="cpu"),
                   ba_solve_wtt(packed, config, device="cpu"))
    return problem, out


def test_solve_agrees_with_wtt_at_ten_columns(trajectories):
    problem, out = trajectories
    for it, ((cams, pts, state), (w_cams, w_pts, w_state)) in out.items():
        assert int(state.iter_num) == int(w_state.iter_num) == it
        assert int(state.accepted) == int(w_state.accepted) == it
        assert float(state.loss) == pytest.approx(float(w_state.loss), rel=1e-9)
        assert float(state.lam) == pytest.approx(float(w_state.lam), rel=1e-6)
        for name in ("rmats", "tvecs", "fx_fy", "dist"):
            torch.testing.assert_close(getattr(cams, name), getattr(w_cams, name),
                                       rtol=1e-7, atol=1e-9, msg=name)
        torch.testing.assert_close(pts, w_pts, rtol=1e-7, atol=1e-9)
    # k1, k2 moved (the ring scene's small radii leave k2 loosely held, so
    # the steps need not head for the truth).
    moved = (out[3][0][0].dist - problem.cameras.dist).abs().max()
    assert moved > 1e-3, moved


def _cut_cell():
    from portbench import generator, run

    spec = copy.deepcopy(run.load_cell(CELL))
    spec["config"]["generator"].update(SMALL_GRAPH)
    spec["config"]["expected"] = generator.counts(spec["config"]["generator"])
    return run, spec


def test_solve_is_correct_against_the_plain_reference():
    run, spec = _cut_cell()
    assert spec["traffic"]["solver"]["optimize_dist"] is True
    assert spec["traffic"]["solve"].endswith("bundle_adjust.ba_solve")
    res = run.run_cell(spec, 2**31 + 977, 0.3, False, "cpu", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_k_held_fixed_is_beyond_the_cells_param_gap():
    """An answer with k1, k2 held at the start (the plain reference's own
    solve without ``optimize_dist``, as the 8-column engine answered) is
    refused by the cell's ``param_gap`` limit in the ``dist`` group."""
    from portbench import compare, generator
    from portbench.reference import Reference

    _, spec = _cut_cell()
    solver = spec["traffic"]["solver"]
    inputs = generator.make_inputs(spec["config"], 2**31 + 977, "cpu", torch.float32)
    ref = Reference(inputs, solver)
    held = Reference(inputs, dict(solver, optimize_dist=False)).solve()
    gaps = compare.param_gaps(held.params, ref.solve().params, ref.start,
                              compare.GROUPS + ("dist",))
    assert gaps["dist"] > spec["limits"]["param_gap"], gaps


def _bal_file(path, k_true, k_start, seed=5):
    """A BAL file (cameras looking down -z, BAL's radial projection) whose
    observations come from cameras with ``k_true`` and whose cameras start
    from ``k_start``, with the points moved off the truth."""
    from scipy.spatial.transform import Rotation

    from tpu3drecon_torch.io.bal import write_bal

    rng = np.random.default_rng(seed)
    n_cams, n_pts = 5, 200
    points = rng.normal(size=(n_pts, 3)) * np.array([2.0, 2.0, 0.8]) + np.array(
        [0.0, 0.0, -6.0])
    rvecs = rng.normal(size=(n_cams, 3)) * 0.05
    tvecs = rng.normal(size=(n_cams, 3)) * 0.2
    f = 500.0 + rng.uniform(size=n_cams) * 100.0
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = []
    for c in range(n_cams):
        big_p = points @ Rotation.from_rotvec(rvecs[c]).as_matrix().T + tvecs[c]
        q = -big_p[:, :2] / big_p[:, 2:3]
        r2 = np.sum(q * q, axis=1, keepdims=True)
        uv.append(f[c] * (1.0 + k_true[0] * r2 + k_true[1] * r2 * r2) * q)
    uv = np.concatenate(uv) + rng.normal(scale=0.1, size=(n_cams * n_pts, 2))
    k = np.tile(np.asarray(k_start, dtype=float), (n_cams, 1))
    cam_params = np.concatenate([rvecs, tvecs, f[:, None], k], axis=1)
    start_points = points + rng.normal(scale=0.01, size=points.shape)
    write_bal(str(path), cam_idx, pt_idx, uv, cam_params, start_points)


@pytest.mark.parametrize("flag", [False, True])
def test_cli_optimize_dist_moves_a_bal_files_k(tmp_path, flag):
    from tpu3drecon_torch.cli import main
    from tpu3drecon_torch.io.bal import read_bal

    k_true = (-0.08, 0.02)
    src, out = tmp_path / "p.txt", tmp_path / "solved.txt"
    _bal_file(src, k_true, (0.0, 0.0))
    argv = ["solve-bal", str(src), "-o", str(out), "--cpu", "--f64", "--maxiter", "10"]
    assert main(argv + (["--optimize-dist"] if flag else [])) == 0
    k = read_bal(str(out))[3][:, 7:9]
    if flag:
        assert np.abs(k - np.asarray(k_true)).max() < 0.25 * abs(k_true[0]), k
    else:
        assert not k.any()


@pytest.mark.parametrize("engine", ["grid", "pallas"])
def test_cli_refuses_optimize_dist_on_the_grid_engines(tmp_path, capsys, engine):
    """The grid engines' own config check refuses ``optimize_dist``; the
    command line reports it as a usage error."""
    from tpu3drecon_torch.cli import main

    src = tmp_path / "p.txt"
    _bal_file(src, (-0.08, 0.02), (0.0, 0.0))
    with pytest.raises(SystemExit) as exc:
        main(["solve-bal", str(src), "--cpu", "--engine", engine, "--optimize-dist"])
    assert exc.value.code == 2
    assert "optimize_dist" in capsys.readouterr().err


def test_flat_roofline_reader_reads_the_counters_or_nothing():
    """``kernels.flat_roofline`` from a trace summary and the program's
    counters: each kernel's launches times its least time (the launch shape
    from the counters) over its device time; None without a trace, without
    the counters, or for the kernels' names before their width template."""
    import importlib.util

    from tpu3drecon_torch.utils import timing

    from portbench import flat_roofline

    spec = importlib.util.spec_from_file_location(
        "flat_roofline_reader", ROOT / "portbench" / "metrics" / "kernels.flat_roofline.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    n, c, p = 28987932, 13682, 4458314
    kernels = {"void (anonymous namespace)::flat_lin_kernel<float, 10>(x)": [3, 12000.0],
               "void (anonymous namespace)::flat_coupling_kernel<float, 10>(x)": [3, 7500.0],
               "void at::native::indexFuncLargeIndex<float>(x)": [6, 3000.0]}
    ctx = dict(trace=dict(kernels=kernels), lm_iters=3)
    timing.reset()
    assert reader.read(ctx) is None  # no counters
    with timing.recording():
        for _ in range(3):
            for kernel in flat_roofline.KERNELS:
                fl._count_launch(kernel, 10, n, c, p)
    least = 3 * sum(flat_roofline.launch_least_s(k, n, c, p, 10) for k in flat_roofline.KERNELS)
    assert reader.read(ctx) == pytest.approx(100 * least / 19500e-6)
    assert 5 < reader.read(ctx) < 100
    assert reader.read(dict(ctx, trace=None)) is None
    old = {"void (anonymous namespace)::flat_lin_kernel<float>(x)": [3, 12000.0]}
    assert reader.read(dict(ctx, trace=dict(kernels=old))) is None
    timing.reset()
    # At NP = 8 the byte floors are the kernel file's ~3.6 GB and ~0.8 GB.
    assert flat_roofline.launch_bytes("lin_kernel", n, c, p, 8) == pytest.approx(3.58e9, rel=0.01)
    assert flat_roofline.launch_bytes("coupling_kernel", n, c, p, 8) == pytest.approx(0.8e9,
                                                                                    rel=0.01)
