"""The profile summary of tpu3drecon_torch.benchmark.profile_solve, checked
on a synthetic Chrome trace (it needs no card)."""

import json

import pytest

from tpu3drecon_torch.benchmark.profile_solve import _intervals_union, summarize


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
