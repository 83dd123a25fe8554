"""The profile summary of tpu3drecon_torch.benchmark.profile_solve, checked
on a synthetic Chrome trace, the ``-Xptxas -v`` filter of
tpu3drecon_torch.benchmark.wtt_bucket_times on compiler lines, the
paired summary of tpu3drecon_torch.benchmark.paired_walls, and the
dense-LM cells of tpu3drecon_torch.benchmark.solver_cells at a small size
with the checks of ``chip_smoke.py`` phase 11 (none needs a card)."""

import json

import numpy as np
import pytest
import torch

from tpu3drecon_torch.benchmark.paired_walls import _summary
from tpu3drecon_torch.benchmark.profile_solve import _intervals_union, summarize
from tpu3drecon_torch.benchmark.wtt_bucket_times import ptxas_lines


def test_intervals_union_merges_overlaps():
    assert _intervals_union([]) == 0.0
    assert _intervals_union([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (7.0, 8.0)]) == 6.0


def test_summarize_reads_a_chrome_trace(tmp_path):
    events = [
        {"cat": "kernel", "name": "void (anonymous namespace)::cam_normal_kernel<float>(float)",
         "ts": 0.0, "dur": 10.0, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "void (anonymous namespace)::cam_normal_kernel<float>(float)",
         "ts": 20.0, "dur": 10.0, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "elementwise", "ts": 25.0, "dur": 10.0,
         "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 50.0, "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0, "dur": 3.0,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 1.0, "dur": 3.0,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 9.0, "dur": 1.0},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 4.0},
        # Program spans: lm.iter [0, 60) holding pcg [0, 12) and lm.cost
        # [40, 48); the device is idle in [10, 20), [35, 50) and [55, 60).
        {"cat": "user_annotation", "name": "lm.iter", "ts": 0.0, "dur": 60.0},
        {"cat": "user_annotation", "name": "pcg", "ts": 0.0, "dur": 12.0},
        {"cat": "user_annotation", "name": "lm.cost", "ts": 40.0, "dur": 8.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = summarize(str(path), wall_s=1e-4)
    assert out["busy_s"] == pytest.approx(30e-6)
    assert out["busy_share"] == pytest.approx(0.3)
    assert (out["device_ops"], out["launch_calls"], out["sync_calls"]) == (4, 2, 1)
    cam = dict(kernel="void (anonymous namespace)::cam_normal_kernel<float>(float)",
               launches=2, total_ms=pytest.approx(0.02), mean_us=10.0)
    assert out["top"][0] == cam
    assert out["port"] == [cam]  # the PyTorch kernel is not the port's
    # Every span, its launches and syncs (its children's included) and the
    # device time of the kernels they started (correlations 1 and 2).
    assert set(out["spans"]) == {"lm.iter", "pcg", "lm.cost"}
    pcg = out["spans"]["pcg"]
    assert (pcg["calls"], pcg["launch_calls"], pcg["sync_calls"]) == (1, 2, 1)
    assert pcg["host_s"] == pytest.approx(12e-6) and pcg["host_share"] == pytest.approx(0.12)
    assert pcg["device_ms"] == pytest.approx(0.02)
    assert out["spans"]["lm.iter"]["launch_calls"] == 2
    assert out["spans"]["lm.iter"]["device_ms"] == pytest.approx(0.02)
    assert out["spans"]["lm.cost"]["launch_calls"] == 0
    # Idle time by the innermost span open on the host.
    idle = {k: v * 1e6 for k, v in out["idle_s"].items()}
    assert idle == {"lm.iter": pytest.approx(8 + 5 + 2 + 5), "pcg": pytest.approx(2),
                    "lm.cost": pytest.approx(8)}


_TT = "_ZN46_GLOBAL__N__08e980a5_13_tt_kernels_cu_c6cf0c1e"
_ROUTE = "_ZN53_GLOBAL__N__3aa39220_20_wtt_route_kernels_cu_4050bd3c"
_WTT = "_ZN47_GLOBAL__N__bed1f45f_14_wtt_kernels_cu_d572d8fe"
_GRID = "_ZN48_GLOBAL__N__1192525d_15_grid_kernels_cu_33655f32"


@pytest.mark.parametrize("mangled,kept", [
    (f"{_TT}20tt_cam_normal_kernelIfLi8EEEvPKT_PKiS3_S3_S3_S3_PS1_S6_S6_S6_S6_iii", True),  # B12
    (f"{_TT}18tt_wt_times_kernelIfLi8EEEvPKT_PKiS3_S3_S3_PS1_iiiii", True),  # B14
    (f"{_TT}17tt_w_times_kernelIfLi8ELb1EEEvPKT_PKiS3_S3_S3_PS1_iiiii", True),  # B15
    (f"{_TT}18tt_coupling_kernelIfLi8EEEvPKiPKT_S5_S5_S5_PS3_iiiii", True),  # B13
    (f"{_ROUTE}14contrib_kernelIfLi8ELb1ELb0EEEvPKsPKT_S5_S5_S5_PS3_iiiiii", True),  # B8
    (f"{_TT}14tt_cost_kernelIfEEvPKT_PKiS3_S3_S3_S3_PS1_iiii", True),  # B16
    (f"{_ROUTE}13w_rows_kernelIfLi8EEEvPKT_PKsS3_S3_PS1_iiii", True),  # B5
    (f"{_WTT}16wt_planes_kernelIfLi8ELb0EEEvPKT_PKsS3_S3_PS1_iiiiii", True),  # B3
    (f"{_WTT}11cost_kernelIfLb1EEEvPKsPKT_S5_S5_S5_PS3_iiiiiii", True),  # B4, walking
    (f"{_ROUTE}17cam_planes_kernelIfEEvPKsPKT_PS3_iiii", False),  # B7, one thread per slot
    (f"{_GRID}24point_normal_rows_kernelIfEEvNS_9PnBucketsEPKT_PS3_S5_S5_S3_", True),  # B10
    # B11 and B9 of an older tree (one block per camera row), kept for the
    # registers of a parent tree timed in the same call, and B11 and B9 with
    # their lanes per thread and row source; B11's grid_coupling_kernel not
    # taken for B2's.
    (f"{_GRID}15coupling_kernelIfEEvPKT_S3_S3_PS1_i", True),  # B11, older tree
    (f"{_GRID}17cam_normal_kernelIfEEvPKT_S3_S3_S3_PS1_S4_S4_S4_S4_ii", True),  # B9, older
    (f"{_GRID}20grid_coupling_kernelIfLi1ELb1EEEvPKT_S3_S3_S3_PKiiPS1_ii", True),  # B11
    (f"{_GRID}22grid_cam_normal_kernelIfLi4ELb1EEEvNS_7CamRowsIT_EEPKS2_S5_PKiiS5_S5_PS2_"
     "S8_S8_S8_S8_iii", True),  # B9
    (f"{_TT}20grid_coupling_kernelIfLi1ELb1EEEvPKT_S3_S3_S3_PKiiPS1_ii", False),  # no source
])
def test_ptxas_lines_keep_the_slot_major_kernels(mangled, kept):
    """The registers and spills of the slot-major B3-B5, B8 and B12-B16, of
    B10 (one launch over the track buckets) and of the grid camera kernels
    B9 and B11 (an older tree's too) are kept, B7's (one thread per slot)
    dropped: the names are matched with their length prefix (B4's
    cost_kernel and B16's tt_cost_kernel each by its own, B3's
    wt_planes_kernel not B7's cam_planes_kernel, B2's coupling_kernel not
    B11's grid_coupling_kernel) and their source."""
    out = (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n")
    lines = ptxas_lines(out)
    assert len(lines) == (3 if kept else 0)
    assert not kept or lines[-1].endswith("Used 64 registers, used 1 barriers")


def test_paired_walls_summary():
    """Medians, extremes and the paired differences this - base, pair by
    pair in the order the walls were taken."""
    out = _summary("grid", [1.0, 3.0, 2.0], [1.5, 2.0, 2.5], "card, 700.00 W")
    assert (out["pairs"], out["base_median_s"], out["this_median_s"]) == (3, 2.0, 2.0)
    assert (out["base_min_s"], out["base_max_s"]) == (1.0, 3.0)
    assert (out["this_min_s"], out["this_max_s"]) == (1.5, 2.5)
    assert out["diff_median_s"] == 0.5  # of +0.5, -1.0, +0.5
    assert out["this_slower"] == 2
    assert out["card"] == "card, 700.00 W"


def test_solver_cells_small():
    """The PnP, tracking, intrinsics and calibration cells, cut to a few
    cameras, solved on the CPU and held to phase 11's checks."""
    from tpu3drecon_torch.benchmark import solver_cells as cells
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.solvers.bundle_adjust import reprojection_rmse
    from tpu3drecon_torch.solvers.intrinsics_refine import (
        ba_with_intrinsics_calibration,
        refine_intrinsics,
    )
    from tpu3drecon_torch.solvers.pose_refine import refine_poses

    problem, noisy = cells.pnp_problem(device="cpu", n_cameras=2)
    cams, state = refine_poses(problem, loss=RobustLoss.TRIVIAL, config=cells.PNP_CONFIG,
                               device="cpu")
    oracle = cells.pnp_scipy_oracle(problem, noisy)
    parity = cells.pnp_parity(cams, oracle)
    assert parity["max_rot_geodesic_err_rad"] < 1e-4 and parity["max_tvec_err"] < 2e-3
    assert problem.max_points == 2304 and cams.rmats.dtype == torch.float32

    problem, scene = cells.tracking_problem(device="cpu", n_frames=4, n_obs=200)
    cams, state = refine_poses(problem, config=cells.TRACKING_CONFIG, device="cpu")
    assert np.median(np.abs(cams.tvecs.double().numpy() - scene.tvecs)) < 1e-3

    problem, scene = cells.intrinsics_problem(device="cpu", n_frames=3, n_obs=300)
    cams, _ = refine_intrinsics(problem, config=cells.INTRINSICS_CONFIG, device="cpu")
    np.testing.assert_allclose(cams.fx_fy.numpy(), scene.fx_fy, rtol=1e-6)
    np.testing.assert_allclose(cams.dist.numpy(), scene.dist, atol=1e-6)

    problem = cells.calib_problem(device="cpu")
    cams, pts, _ = ba_with_intrinsics_calibration(problem, rounds=2, device="cpu")
    k1 = cams.dist[:, 0].numpy()
    assert np.all(k1 < -0.01) and np.all(k1 > -0.14), k1
    assert float(reprojection_rmse(problem, cams, pts)) < float(
        reprojection_rmse(problem, problem.cameras, problem.points3d))
