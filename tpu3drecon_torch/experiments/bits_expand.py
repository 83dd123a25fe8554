"""E4: bit-plane expansion of a uint8 array, in two layouts.

Counterpart of ``experiments/tpu_bits_expand_probe.py``, which checked which
in-kernel expansions of a bit-packed one-hot Mosaic could lower.  The port
keeps no bit-packed one-hot, so this is the probe's function alone: one
CUDA kernel per layout (``csrc/probe_kernels.cu`` ``probe_bits_expand``)
expands a seeded (100, 128) uint8 array (numpy generator 0, as E4) into
(100, 1024) float32 {0, 1} planes:

- layout A (byte-interleaved): output m is bit m % 8 of byte m // 8;
- layout B (bit plane per tile): output j * 128 + k is bit j of byte k.

Each prints ``correct`` against E4's numpy formulas and its device time
(``benchmark.timing.device_ms``, cold L2).

    python -m tpu3drecon_torch.experiments.bits_expand
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import is_cuda_call

ROWS, NBYTES = 100, 128
LAYOUTS = ("A", "B")
LAYOUT_A_COUNTS = _build.LaunchCounter()
LAYOUT_B_COUNTS = _build.LaunchCounter()


def _counter(layout: str) -> _build.LaunchCounter:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'A' or 'B', not {layout!r}")
    return LAYOUT_A_COUNTS if layout == "A" else LAYOUT_B_COUNTS


def packed_input() -> np.ndarray:
    """E4's (100, 128) uint8 input."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(ROWS, NBYTES), dtype=np.uint8)


def numpy_expand(packed: np.ndarray, layout: str) -> np.ndarray:
    """E4's formulas (``experiments/tpu_bits_expand_probe.py:60-67``)."""
    nb = packed.shape[1] * 8
    if layout == "A":
        return ((packed[:, np.arange(nb) // 8] >> (np.arange(nb) % 8)) & 1).astype(np.float32)
    return np.concatenate([((packed >> j) & 1).astype(np.float32) for j in range(8)], axis=1)


def bits_expand_plain(packed: torch.Tensor, layout: str) -> torch.Tensor:
    """Plain PyTorch version of ``bits_expand``."""
    _counter(layout).plain += 1
    p = packed.to(torch.int32)
    if layout == "A":
        m = torch.arange(p.shape[1] * 8, device=p.device)
        return ((p[:, m // 8] >> (m % 8)) & 1).to(torch.float32)
    return torch.cat([((p >> j) & 1).to(torch.float32) for j in range(8)], dim=1)


def bits_expand(packed: torch.Tensor, layout: str) -> torch.Tensor:
    """(rows, 8 * nbytes) float32 bit planes of a (rows, nbytes) uint8
    array in ``layout`` "A" or "B".  CPU tensors run the plain version,
    CUDA tensors the kernel."""
    counter = _counter(layout)
    if not is_cuda_call(packed):
        return bits_expand_plain(packed, layout)
    if packed.dtype != torch.uint8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("bits_expand: packed must be a contiguous 2-d uint8 tensor")
    rows, nbytes = packed.shape
    out = torch.empty((rows, 8 * nbytes), dtype=torch.float32, device=packed.device)
    lib = _build.library()
    code = lib.probe_bits_expand(LAYOUTS.index(layout), packed.data_ptr(), out.data_ptr(),
                                 rows, nbytes, _build.stream_ptr(packed.device))
    _build.check(lib, f"bits_expand[{layout}]", code)
    counter.kernel += 1
    return out


def run(log=print) -> dict:
    """layout -> {"correct", "ms", "plain_ms", "bytes"}."""
    from tpu3drecon_torch.benchmark.timing import bytes_bound_ms, device_ms
    from tpu3drecon_torch.device import resolve_device

    host = packed_input()
    packed = torch.as_tensor(host, device=resolve_device(None))
    out = {}
    for layout in LAYOUTS:
        got = bits_expand(packed, layout).cpu().numpy()
        correct = bool(np.array_equal(got, numpy_expand(host, layout)))
        ms = device_ms(lambda layout=layout: bits_expand(packed, layout))
        plain_ms = device_ms(lambda layout=layout: bits_expand_plain(packed, layout))
        out[layout] = {"correct": correct, "ms": ms, "plain_ms": plain_ms,
                       "bytes": host.nbytes + got.nbytes}
        log(f"E4 {layout}: correct={correct}, kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"bound {bytes_bound_ms(out[layout]['bytes']):.6f} ms")
        if not correct:
            raise AssertionError(f"E4 layout {layout}: the kernel disagrees with numpy")
    return out


def main() -> int:
    from tpu3drecon_torch.benchmark.timing import card_line

    print(f"nvidia-smi: {card_line()}")
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
