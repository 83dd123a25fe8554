"""E3: kernel B2 against its plain version at terms 3 and 1, on E3's inputs.

Counterpart of ``experiments/tpu_term_stack.py``, which checked on the TPU
that stacking B2's bfloat16 split terms into one MXU dot reproduces the
separate-pass kernel exactly, and timed both.  Hopper has no stacked dot
(B2 reads each slot's window row directly), so this is the exactness half:
the same random inputs (numpy seed 0: G 48, Tb 4, Pc 2560, W 256, np 8,
10 % padded slots, float32) go through B2 and its plain PyTorch version at
terms 3 and at terms 1, and each prints max|A - B|, the scale max|B| and
the device time of both (``benchmark.timing.device_ms``, cold L2).  The
rows are atomic sums, so A and B agree to f32 re-association.

    python -m tpu3drecon_torch.experiments.term_stack
"""

from __future__ import annotations

G, TB, PC, W, NP = 48, 4, 2560, 256, 8
REL = 1e-4  # the atomic row sums of chip_smoke.py's tolerance (f32)


def inputs(device="cuda"):
    """E3's inputs, drawn in its order from numpy's generator 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    jc = rng.normal(size=(2 * NP, G, TB, PC)).astype(np.float32)
    jp = rng.normal(size=(6, G, TB, PC)).astype(np.float32)
    v_inv = rng.normal(size=(6, G, PC)).astype(np.float32)
    wcam = rng.integers(0, W, size=(G, TB * PC)).astype(np.int32)
    wcam[rng.random(size=wcam.shape) < 0.1] = -1
    xw0 = rng.normal(size=(G, NP, W)).astype(np.float32)

    def t(x, dt=None):
        return torch.as_tensor(x, dtype=dt, device=device)

    return t(xw0), t(wcam, torch.int16), t(jc), t(jp), t(v_inv)


def run(log=print) -> dict:
    """terms -> {"max_abs_diff", "scale", "ms", "plain_ms"}, and
    "bound_ms": the bytes of B2's inputs and rows at the card's memory
    rate."""
    import torch

    from tpu3drecon_torch.benchmark.timing import bytes_bound_ms, device_ms, nbytes
    from tpu3drecon_torch.device import resolve_device
    from tpu3drecon_torch.ops.wtt_matvec import (
        wtt_coupling_rows_idx,
        wtt_coupling_rows_idx_plain,
    )

    args = inputs(resolve_device(None))
    n_bytes = 2 * nbytes(args[0]) + nbytes(*args[1:])
    out = {"bound_ms": bytes_bound_ms(n_bytes)}
    log(f"E3 bound: {n_bytes} B of inputs and rows -> {out['bound_ms']:.6f} ms")
    for terms in (3, 1):
        a = wtt_coupling_rows_idx(*args, terms=terms)
        b = wtt_coupling_rows_idx_plain(*args, terms=terms)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(a - b)))
        scale = float(torch.max(torch.abs(b)))
        ms = device_ms(lambda terms=terms: wtt_coupling_rows_idx(*args, terms=terms))
        plain_ms = device_ms(lambda terms=terms: wtt_coupling_rows_idx_plain(*args, terms=terms))
        out[terms] = {"max_abs_diff": err, "scale": scale, "ms": ms, "plain_ms": plain_ms}
        log(f"E3 terms={terms}: max|kernel - plain| = {err:.3e} (scale {scale:.3e}); "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms")
        if not err <= REL * scale:
            raise AssertionError(f"E3 terms={terms}: {err:.3e} > {REL:.0e} * {scale:.3e}")
    return out


def main() -> int:
    from tpu3drecon_torch.benchmark.timing import card_line

    print(f"nvidia-smi: {card_line()}")
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
