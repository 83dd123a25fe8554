"""The profile summary of tpu3drecon_torch.benchmark.profile_solve, checked
on a synthetic Chrome trace, and the ``-Xptxas -v`` filter of
tpu3drecon_torch.benchmark.wtt_bucket_times on compiler lines (neither
needs a card)."""

import json

import pytest

from tpu3drecon_torch.benchmark.profile_solve import _intervals_union, summarize
from tpu3drecon_torch.benchmark.wtt_bucket_times import ptxas_lines


def test_intervals_union_merges_overlaps():
    assert _intervals_union([]) == 0.0
    assert _intervals_union([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (7.0, 8.0)]) == 6.0


def test_summarize_reads_a_chrome_trace(tmp_path):
    events = [
        {"cat": "kernel", "name": "void (anonymous namespace)::cam_normal_kernel<float>(float)",
         "ts": 0.0, "dur": 10.0},
        {"cat": "kernel", "name": "void (anonymous namespace)::cam_normal_kernel<float>(float)",
         "ts": 20.0, "dur": 10.0},
        {"cat": "kernel", "name": "elementwise", "ts": 25.0, "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 50.0, "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0, "dur": 3.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 1.0, "dur": 3.0},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 9.0, "dur": 1.0},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 4.0},
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


_TT = "_ZN46_GLOBAL__N__08e980a5_13_tt_kernels_cu_c6cf0c1e"
_ROUTE = "_ZN53_GLOBAL__N__3aa39220_20_wtt_route_kernels_cu_4050bd3c"


@pytest.mark.parametrize("mangled,kept", [
    (f"{_TT}20tt_cam_normal_kernelIfLi8EEEvPKT_PKiS3_S3_S3_S3_PS1_S6_S6_S6_S6_iii", True),  # B12
    (f"{_TT}18tt_wt_times_kernelIfLi8EEEvPKT_PKiS3_S3_S3_PS1_iiiii", True),  # B14
    (f"{_TT}17tt_w_times_kernelIfLi8ELb1EEEvPKT_PKiS3_S3_S3_PS1_iiiii", True),  # B15
    (f"{_TT}18tt_coupling_kernelIfLi8EEEvPKiPKT_S5_S5_S5_PS3_iiiii", True),  # B13
    (f"{_ROUTE}14contrib_kernelIfLi8ELb1ELb0EEEvPKsPKT_S5_S5_S5_PS3_iiiiii", True),  # B8
    (f"{_TT}14tt_cost_kernelIfEEvPKT_PKiS3_S3_S3_S3_PS1_iiii", False),  # B16
    (f"{_ROUTE}13w_rows_kernelIfLi8EEEvPKT_PKsS3_S3_PS1_iiii", False),  # B5
])
def test_ptxas_lines_keep_the_slot_major_kernels(mangled, kept):
    """The registers and spills of the slot-major B8 and B12-B15 are kept,
    B5's and B16's (one thread per point) dropped: the names are matched
    with their length prefix."""
    out = (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n")
    lines = ptxas_lines(out)
    assert len(lines) == (3 if kept else 0)
    assert not kept or lines[-1].endswith("Used 64 registers, used 1 barriers")
