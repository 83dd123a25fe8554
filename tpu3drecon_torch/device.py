"""Where the port's entry points put their tensors.

The port runs on the CUDA card unless the caller asks for another device:
an entry point called without ``device`` targets ``cuda`` and raises where
no CUDA device is present; it never drops to the CPU.  Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to build on the CPU"
        )
    return torch.device("cuda")
