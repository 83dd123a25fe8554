"""Device time of one call on the CUDA card, as ``chip_smoke.py`` and the
probes of ``tpu3drecon_torch.experiments`` measure it."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
SPIN_CYCLES_PER_S = 2e9  # at or above the SM clock: a spin lasts at least its time
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bytes_bound_ms(n_bytes: int) -> float:
    """The least time (ms) the card could take to move ``n_bytes`` (each
    input read once, each output written once) at its memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def device_ms(fn, n: int = 20) -> float:
    """Median device time (ms) of one call of ``fn`` over ``n`` calls.

    Before each call a 128 MB write evicts the L2, so every call reads its
    inputs from HBM, and a spin kernel then holds the stream for twice
    the host time of one call plus 1 ms, so the host has enqueued the whole
    call before its work starts: the CUDA-event pair around the call spans
    its device work back to back, without the host time between launches.
    """
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int((2 * host_s + 1e-3) * SPIN_CYCLES_PER_S)
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    """The card's ``nvidia-smi`` name and power limit, the line every
    measurement is kept beside."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
