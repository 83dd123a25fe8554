"""The flat engine's linearization (``ops/flat_linearize.py``): its routing
and the plain pieces on the CPU, and on the card the two CUDA kernels
(``csrc/flat_kernels.cu``) against the plain version on the same CUDA
inputs.

The card cases build a small flat problem with what the kernels have to
adapt to: observations sorted by point (BAL), by camera (the COLMAP
packing) or in random order; padding rows (mask 0, camera 0, point 0); a
hub camera with 4,200 observations (131 warps of one camera); a camera and
a point with no observation; nonzero k1, k2 and skew; half the
observations 0.3 px from their projection and half far off, so both
branches of the Huber weight run.  Each case compares the damped
``NormalBlocks`` of the kernel route with those of the plain route, and
the coupling kernel with the plain coupling on the same V^-1.

Tolerances, relative to max|plain| of each tensor (``TOL``): W per element
1e-4 (f32) and 1e-12 (f64), since the plain J comes from cuBLAS's batched
3x3 products, the kernel's from one rounding per operation, and a robust
loss's weight passes the projection's last bits through the residual's
cancellation u - u_obs (at f32 a Cauchy or Huber case measured 2.7e-5 on
the card, the trivial loss 1.5e-6 at Final-13682's size); the sums U, V,
g_c, g_p and the coupling 1e-4 and 1e-10, since the kernel adds each
camera's and point's observations with atomics in an order that changes
from run to run.  V^-1 and the preconditioner's factor take the sums'
differences through an inverse and a Cholesky of U - W V^-1 W^T, which
amplify them by the blocks' condition numbers: 2e-3 and 1e-8.  The
full solve on the card is held to a CPU float64 solve of the same problem:
the same accepted steps (3 in float32, 4 in float64: see the test), and
the final loss to 1e-4 relative in float32 and 1e-9 in float64.  The problem observes its points with 0.5 px of
noise, so its final loss is a floor far above rounding, which the card's
float32 rounding of four LM steps (or, in float64, the atomics' summation
order) moves only in its last digits; a wrong block or gradient moves it
by far more.  Each card case runs at the kernels' two camera widths, 8
and 10 (k1, k2 optimized), and a traced solve at 10 columns counts each
kernel's launches by width, as ``portbench``'s ``kernels.flat_roofline``
reads them.

Card tests need an NVIDIA GPU with nvcc (the kernels build at first use)
and skip where ``torch.cuda.is_available()`` is false; the file imports no
jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flat_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu3drecon_torch.benchmark.medium_config import build_problem
from tpu3drecon_torch.geometry.losses import RobustLoss
from tpu3drecon_torch.ops import flat_linearize as fl
from tpu3drecon_torch.ops.jacobians import gather_obs_blocks
from tpu3drecon_torch.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon_torch.problems.packing import BAProblem
from tpu3drecon_torch.solvers import schur
from tpu3drecon_torch.solvers.bundle_adjust import BAConfig, ba_solve
from tpu3drecon_torch.utils import timing

TOL = {  # (W per element, sums, V^-1 and the factor)
    torch.float32: (1e-4, 1e-4, 2e-3),
    torch.float64: (1e-12, 1e-10, 1e-8),
}
N_CAMS, N_PTS, HUB_OBS, N_PAD = 40, 5000, 4200, 37


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _problem(order: str, dtype, device, seed: int = 0):
    """The arguments of ``fl.linearize`` through ``inv_width`` for a scene
    of ``N_CAMS`` cameras (0 the hub, the last unseen) and ``N_PTS`` points
    (the last unseen), observations in ``order``, then the padding rows."""
    rng = np.random.default_rng(seed)
    c, p = N_CAMS, N_PTS
    ang = rng.normal(scale=0.05, size=(c, 3))
    rmats = np.empty((c, 3, 3))
    for k, (a, b, g) in enumerate(ang):  # small rotations about x, y, z
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(g), -np.sin(g), 0], [np.sin(g), np.cos(g), 0], [0, 0, 1]])
        rmats[k] = rz @ ry @ rx
    tvecs = np.column_stack([rng.normal(scale=0.3, size=(c, 2)), rng.uniform(5.0, 7.0, c)])
    fx_fy = rng.uniform(500.0, 600.0, size=(c, 2))
    cx_cy_skew = np.column_stack([rng.uniform(300, 340, c), rng.uniform(220, 260, c),
                                  rng.uniform(-0.5, 0.5, c)])
    dist = np.column_stack([rng.uniform(-0.05, 0.05, c), rng.uniform(-0.01, 0.01, c)])
    points = rng.uniform(-1.0, 1.0, size=(p, 3))
    cams, pts = [], []
    for q in range(p - 1):  # the last point is unseen
        first = int(rng.integers(1, c - 6))
        for k in range(first, first + int(rng.integers(2, 6))):  # cameras 1 .. c - 2
            cams.append(k)
            pts.append(q)
    hub = rng.choice(p - 1, size=HUB_OBS, replace=False)
    cams += [0] * HUB_OBS
    pts += hub.tolist()
    cams, pts = np.array(cams), np.array(pts)
    if order == "point":
        perm = np.lexsort((cams, pts))
    elif order == "camera":
        perm = np.lexsort((pts, cams))
    else:
        perm = rng.permutation(len(cams))
    cams, pts = cams[perm], pts[perm]
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    cam_rows = tuple(t(a) for a in (rmats, tvecs, fx_fy, cx_cy_skew, dist))
    ci = torch.tensor(cams, dtype=torch.int32, device=device)
    pi = torch.tensor(pts, dtype=torch.int32, device=device)
    proj = gather_obs_blocks(*cam_rows, t(points), ci, pi, t(np.zeros((len(cams), 2))),
                             t(np.ones(len(cams))), 1.0).residual.cpu().numpy()
    near = rng.random(len(cams)) < 0.5
    uv = np.where(near[:, None], proj + rng.normal(scale=0.3, size=proj.shape),
                  proj + rng.uniform(-40.0, 40.0, size=proj.shape))
    n = len(cams) + N_PAD
    cam_idx = np.concatenate([cams, np.zeros(N_PAD, int)])
    pt_idx = np.concatenate([pts, np.zeros(N_PAD, int)])
    uv = np.concatenate([uv, np.zeros((N_PAD, 2))])
    mask = np.concatenate([np.ones(n - N_PAD), np.zeros(N_PAD)])
    return (*cam_rows, t(points), torch.tensor(cam_idx, dtype=torch.int32, device=device),
            torch.tensor(pt_idx, dtype=torch.int32, device=device), t(uv), t(mask),
            t(1.0 / 640.0))


def _close(name, got, want, tol):
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    assert err <= tol * scale, f"{name}: max err {err:.3e} vs {tol:.0e} * {scale:.3e}"


def _blocks(args, route, flags, lam, precond):
    """``NormalBlocks`` of the kernel or the plain route."""
    lin = fl.linearize if route == "kernel" else fl.linearize_plain
    sums = lin(*args, N_CAMS, N_PTS, **flags)
    return sums, schur.damp_normal_blocks(sums, lam, precond=precond)


def _check_case(dev, order, dtype, loss=RobustLoss.TRIVIAL, focal=True, points=True,
                precond="schur_jacobi", dist=False):
    args = _problem(order, dtype, dev)
    flags = dict(loss=loss, optimize_focal=focal, optimize_points=points, optimize_dist=dist)
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    before = fl.COUNTS.kernel, fl.COUPLING_COUNTS.kernel
    sums, nb = _blocks(args, "kernel", flags, lam, precond)
    want_sums, want = _blocks(args, "plain", flags, lam, precond)
    torch.cuda.synchronize()
    assert (fl.COUNTS.kernel, fl.COUPLING_COUNTS.kernel) == (
        before[0] + 1, before[1] + (precond == "schur_jacobi"))
    t_w, t_sum, t_inv = TOL[dtype]
    _close("w", nb.w, want.w, t_w)
    for name in ("u", "v", "g_cam", "g_pt", "damp_cam", "damp_pt"):
        _close(name, getattr(nb, name), getattr(want, name), t_sum)
    _close("v_inv", nb.v_inv, want.v_inv, t_inv)
    _close("u_chol", torch.nan_to_num(nb.u_chol), torch.nan_to_num(want.u_chol), t_inv)
    assert torch.equal(torch.isnan(nb.u_chol), torch.isnan(want.u_chol))
    # The coupling kernel alone, on the plain route's V^-1.
    got = sums.coupling(want.v_inv)
    _close("coupling", got, want_sums.coupling(want.v_inv), t_sum)
    # The unseen camera and point sum to exact zeros on both routes.
    assert not sums.u[-1].any() and not sums.v[-1].any() and not sums.g_pt[-1].any()
    if not points:
        assert not sums.v.any() and not sums.w.any() and not got.any()
    if not focal:
        assert not sums.u[:, 6:8].any() and not sums.g_cam[:, 6:8].any()
    n = 10 if dist else 8
    assert sums.u.shape == (N_CAMS, n, n) and sums.w.shape[1:] == (n, 3)
    if dist:  # the k1, k2 columns carry sums of their own
        assert sums.u[:, 8:, 8:].abs().max() > 0 and sums.g_cam[:, 8:].abs().max() > 0


# ----------------------------------------------------------------- CPU --


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version: ``plain`` grows,
    ``kernel`` stays, and ``flat.lin_kernel`` counts nothing."""
    args = _problem("point", torch.float64, "cpu")
    fl.COUNTS.reset()
    fl.COUPLING_COUNTS.reset()
    timing.reset()
    with timing.recording():
        sums = fl.linearize(*args, N_CAMS, N_PTS)
        sums.coupling(torch.eye(3, dtype=torch.float64).expand(N_PTS, 3, 3))
    assert (fl.COUNTS.kernel, fl.COUNTS.plain) == (0, 1)
    assert (fl.COUPLING_COUNTS.kernel, fl.COUPLING_COUNTS.plain) == (0, 1)
    assert "flat.lin_kernel" not in timing.tally()["counts"]
    timing.reset()


@pytest.mark.parametrize("n", [3, 8, 10])
def test_sym_index_unpacks_the_row_major_upper_triangle(n):
    a = torch.randn(5, n, n, dtype=torch.float64)
    sym = a + a.transpose(1, 2)
    iu = torch.triu_indices(n, n)
    packed = sym[:, iu[0], iu[1]]  # row-major upper triangle
    assert torch.equal(fl._unpack(packed, n), sym)


@pytest.mark.parametrize("precond", ["schur_jacobi", "jacobi_u"])
def test_damped_sums_are_build_normal_blocks(precond):
    """``damp_normal_blocks`` of the plain sums and coupling is
    ``build_normal_blocks`` bit for bit (the CPU route is the first
    port's code path)."""
    args = _problem("random", torch.float64, "cpu", seed=3)
    flags = dict(loss=RobustLoss.CAUCHY, optimize_focal=True, optimize_points=True)
    r, jc, jp = fl.flat_blocks(*args, **flags)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    ci, pi = args[6], args[7]
    want = schur.build_normal_blocks(r, jc, jp, ci, pi, N_CAMS, N_PTS, lam, precond=precond)
    sums = fl.linearize(*args, N_CAMS, N_PTS, **flags)
    got = schur.damp_normal_blocks(sums, lam, precond=precond)
    for name in schur.NormalBlocks._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_plain_coupling_is_the_per_camera_sum():
    args = _problem("camera", torch.float64, "cpu", seed=4)
    sums = fl.linearize(*args, N_CAMS, N_PTS)
    v_inv = torch.randn(N_PTS, 3, 3, dtype=torch.float64)
    per_obs = torch.einsum("nik,nkl,njl->nij", sums.w, v_inv[args[7].long()], sums.w)
    want = torch.zeros(N_CAMS, 8, 8, dtype=torch.float64)
    want.index_add_(0, args[6].long(), per_obs)
    torch.testing.assert_close(fl.coupling_of_w(sums.w, v_inv, args[6], args[7], N_CAMS),
                               want, rtol=1e-12, atol=1e-12)


def test_cpu_solve_counts_no_kernel_linearization():
    problem = build_problem("cpu", torch.float64, n_cameras=6, n_points=200,
                            obs_per_camera=120)
    timing.reset()
    with timing.recording():
        ba_solve(problem, BAConfig(maxiter=3), device="cpu")
    counts = timing.tally()["counts"]
    timing.reset()
    assert counts["lm.iters"] == 3 and "flat.lin_kernel" not in counts


# ---------------------------------------------------------------- card --


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["point", "camera", "random"])
def test_kernels_match_plain_by_order(dev, order, dtype):
    _check_case(dev, order, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loss", [RobustLoss.CAUCHY, RobustLoss.HUBER])
def test_kernels_match_plain_robust_losses(dev, loss, dtype):
    _check_case(dev, "point", dtype, loss=loss)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("focal,points", [(False, True), (True, False), (False, False)])
def test_kernels_match_plain_frozen_blocks(dev, focal, points, dtype):
    _check_case(dev, "camera", dtype, focal=focal, points=points)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_jacobi_u(dev, dtype):
    _check_case(dev, "random", dtype, loss=RobustLoss.HUBER, precond="jacobi_u")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["point", "camera", "random"])
def test_ten_column_kernels_match_plain_by_order(dev, order, dtype):
    _check_case(dev, order, dtype, dist=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loss,focal,points", [(RobustLoss.HUBER, True, True),
                                               (RobustLoss.CAUCHY, False, True),
                                               (RobustLoss.TRIVIAL, True, False)])
def test_ten_column_kernels_match_plain_losses_and_frozen_blocks(dev, loss, focal, points,
                                                                 dtype):
    _check_case(dev, "point", dtype, loss=loss, focal=focal, points=points, dist=True)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(dev):
    args = list(_problem("point", torch.float32, dev))
    for k, bad in ((5, args[5].double()), (6, args[6].long()),
                   (8, args[8].t().contiguous().t())):  # points f64, int64 index, uv strided
        wrong = list(args)
        wrong[k] = bad
        with pytest.raises(ValueError):
            fl.linearize(*wrong, N_CAMS, N_PTS)
    sums = fl.linearize(*args, N_CAMS, N_PTS)
    with pytest.raises(ValueError):
        sums.coupling(torch.zeros(N_PTS, 3, 3, device=dev).double())


@pytest.mark.cuda
def test_coupling_keeps_its_inputs(dev):
    """The sums' ``coupling`` launches on the linearization's inputs after
    the caller has let go of them: the scale given as a float, every other
    input a temporary, and small allocations in between that would take
    their freed memory."""
    args = _problem("random", torch.float64, dev, seed=5)
    want = fl.linearize_plain(*args, N_CAMS, N_PTS)
    v_inv = schur.damp_normal_blocks(want, torch.tensor(1e-3, dtype=torch.float64, device=dev),
                                     precond="jacobi_u").v_inv
    sums = fl.linearize(*(a.clone() for a in args[:10]), 1.0 / 640.0, N_CAMS, N_PTS)
    junk = [torch.full((k,), 7.0, dtype=torch.float64, device=dev) for k in range(1, 200)]
    _close("coupling", sums.coupling(v_inv), want.coupling(v_inv), TOL[torch.float64][1])
    del junk


def _ba_problem(dtype, device) -> BAProblem:
    """A ring scene with radial distortion, observed with 0.5 px noise
    (so the loss has a floor well above rounding) and started from a
    perturbed copy (padding rows included)."""
    scene = make_scene(n_cameras=12, n_points=1500, obs_per_camera=600, seed=11,
                       dist=(0.02, -0.002))
    observed = perturb_scene(scene, 0.0, 0.0, 0.0, 0.0, point2d_noise=0.5, seed=12)
    start = perturb_scene(scene, point2d_noise=0.0, seed=13)
    return scene_to_ba_problem(start, observed=observed, dtype=dtype, device=device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,iters", [(torch.float32, 3), (torch.float64, 4)])
def test_card_solve_agrees_with_cpu_float64(dev, dtype, iters):
    """A flat solve on the card (the kernel route, one ``flat.lin_kernel``
    per LM iteration) against the CPU float64 solve of the same problem.
    Float32 takes 3 iterations: each of them lowers the loss by at least
    9e-5 of it, while the fourth lowers it by 6e-10, below float32's
    resolution of the loss, so whether float32 accepts that step is
    rounding, and it varies with the atomics' order."""
    config = BAConfig(maxiter=iters, gtol=0.0, ftol=0.0, cg_rtol=1e-6)
    _, _, ref = ba_solve(_ba_problem(torch.float64, "cpu"), config, device="cpu")
    timing.reset()
    with timing.recording():
        _, _, got = ba_solve(_ba_problem(dtype, dev), config, device=dev)
    counts = timing.tally()["counts"]
    timing.reset()
    assert counts["flat.lin_kernel"] == counts["lm.iters"] == iters
    assert int(got.accepted) == int(ref.accepted) == iters
    rel = abs(float(got.loss) - float(ref.loss)) / float(ref.loss)
    assert rel < (1e-4 if dtype == torch.float32 else 1e-9), rel


def test_phases_line_shows_the_kernel_counter():
    """The CLI's phases line ends in the ``flat.lin_kernel`` count when the
    timed solve made one (the card's flat engine), and leaves it out
    otherwise (the CPU)."""
    from tpu3drecon_torch.cli import _phases_line

    empty = dict(spans={}, counts={})
    timed = dict(spans={"lm.linearize": dict(calls=3, s=0.003, self_s=0.003, parent=None)},
                 counts={"lm.iters": 3})
    assert "flat.lin_kernel" not in _phases_line(empty, timed)
    timed["counts"]["flat.lin_kernel"] = 3
    line = _phases_line(empty, timed)
    assert line.endswith("; flat.lin_kernel 3") and "lm.linearize 3.0" in line


def _radial_problem(dtype, device) -> BAProblem:
    """``_ba_problem`` started from k1, k2 off the truth (0.02, -0.002) by
    up to 0.01 and 0.002 per camera."""
    problem = _ba_problem(dtype, device)
    rng = np.random.default_rng(14)
    c = problem.n_cameras
    shift = np.column_stack([rng.uniform(-0.01, 0.01, c), rng.uniform(-0.002, 0.002, c)])
    cams = dataclasses.replace(problem.cameras, dist=problem.cameras.dist + torch.tensor(
        shift, dtype=dtype, device=problem.cameras.dist.device))
    return dataclasses.replace(problem, cameras=cams)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_radial_solve_agrees_with_cpu_float64(dev, dtype):
    """``ba_solve`` with k1, k2 optimized on the card (both kernels at 10
    columns) against the CPU float64 solve of the same problem: the same
    accepted steps, the final loss and k1, k2.  The CG runs a fixed 20
    iterations (``cg_rtol`` 0), so that the atomics' summation order cannot
    move where it stops."""
    config = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=20, cg_rtol=0.0,
                      optimize_dist=True)
    start = _radial_problem(torch.float64, "cpu")
    ref_cams, _, ref = ba_solve(start, config, device="cpu")
    cams, _, got = ba_solve(_radial_problem(dtype, dev), config, device=dev)
    assert int(got.accepted) == int(ref.accepted) == 3, (got, ref)
    rel = abs(float(got.loss) - float(ref.loss)) / float(ref.loss)
    assert rel < (1e-4 if dtype == torch.float32 else 1e-9), (rel, got.loss, ref.loss)
    moved = (ref_cams.dist - start.cameras.dist).abs().max()
    err = (cams.dist.double().cpu() - ref_cams.dist).abs().max()
    assert err < (1e-2 if dtype == torch.float32 else 1e-7) * moved, (err, moved)


@pytest.mark.cuda
def test_traced_solve_counts_launches_by_width(dev):
    """In a traced flat solve at 10 columns the counters ``flat.<kernel>.np10``
    equal the launches of ``flat_lin_kernel<float, 10>`` and
    ``flat_coupling_kernel<float, 10>`` in the trace, their ``.obs``,
    ``.cameras`` and ``.points`` the launches times the problem's shape, and
    no 8-column kernel runs."""
    from torch.profiler import ProfilerActivity, profile

    problem = _radial_problem(torch.float32, dev)
    config = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8, optimize_dist=True)
    ba_solve(problem, config, device=dev)  # builds the kernels outside the trace
    torch.cuda.synchronize()
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba_solve(problem, config, device=dev)
        torch.cuda.synchronize()
    counts = timing.tally()["counts"]
    timing.reset()
    launched = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        for kernel in ("lin_kernel", "coupling_kernel"):
            for n in (8, 10):
                if f"flat_{kernel}<float, {n}>" in ev.name:
                    launched[(kernel, n)] = launched.get((kernel, n), 0) + 1
    assert counts["lm.iters"] == 3 and counts["flat.lin_kernel"] == 3
    n_obs = problem.uv.shape[0]
    for kernel in ("lin_kernel", "coupling_kernel"):
        key = f"flat.{kernel}.np10"
        assert counts[key] == launched[(kernel, 10)] == 3, (counts, launched)
        assert counts[key + ".obs"] == 3 * n_obs
        assert counts[key + ".cameras"] == 3 * problem.n_cameras
        assert counts[key + ".points"] == 3 * problem.n_points
        assert f"flat.{kernel}.np8" not in counts and (kernel, 8) not in launched
