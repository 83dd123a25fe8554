"""E1: kernel B2's launch shape and the cost of its gather and atomics, on
the BAL buckets.

Counterpart of ``experiments/tpu_index_matvec2.py``, which timed a copy of
the TPU coupling kernel over block size, MXU precision, one-hot build and
tile reuse to attribute its time.  Here a copy of B2's earlier design,
one thread per point column (``csrc/probe_kernels.cu`` ``probe_coupling``,
float32, np = 8; B2 itself is now slot-major), runs on the
linearized buckets of the 1712-camera BAL sequential problem
(``bal_sequential_wtt()``, unsplit, lam = 1e-3) in five variants:

- ``block128`` / ``block256`` / ``block512``: the copy's work at 128, 256
  (its own) and 512 threads per block;
- ``no_gather``: every live slot reads window row 0 of x and reduces into
  row 0 (E1's "const" one-hot build: no camera-row gather, every warp on
  one row);
- ``no_atomics``: z summed over each point's track in registers and stored
  once per point into a (G, np, Pc) scratch, no row reduction.

The last two are timing-only: their outputs are not B2's (each is checked
against its own plain version).  Each prints its device time per pass over
the buckets (``benchmark.timing.device_ms``, cold L2) beside B2's.

    python -m tpu3drecon_torch.experiments.index_matvec2
"""

from __future__ import annotations

import torch

from tpu3drecon_torch.ops import _build
from tpu3drecon_torch.ops._wtt_common import is_cuda_call

# name -> (threads per block, variant code of the C entry)
VARIANTS = {
    "block128": (128, 0), "block256": (256, 0), "block512": (512, 0),
    "no_gather": (256, 1), "no_atomics": (256, 2),
}
COUNTS = _build.LaunchCounter()
# Against the plain version, f32: atomic row sums as chip_smoke.py's; with
# no_gather each group's ~10^5 slot values all reduce into row 0.
REL = {"no_gather": 1e-3}
REL_ROWS = 1e-4


def probe_coupling_rows_plain(xw_t, wcam, jc, jp, v_inv, variant: str):
    """Plain PyTorch version of ``probe_coupling_rows``."""
    from tpu3drecon_torch.ops.wtt_matvec import _w_z, _wt_x, wtt_coupling_rows_idx_plain
    from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec

    COUNTS.plain += 1
    if variant == "no_gather":
        wcam = torch.where(wcam >= 0, torch.zeros_like(wcam), wcam)
    if variant != "no_atomics":
        return wtt_coupling_rows_idx_plain(xw_t, wcam, jc, jp, v_inv)
    _, g, tb, pc = jp.shape
    z = _w_z(_sym3_matvec(v_inv, _wt_x(xw_t, wcam, jc, jp, ordered=True)), jc, jp)
    z = z * (wcam >= 0).reshape(1, g, tb, pc)
    acc = z[:, :, 0]
    for t in range(1, tb):
        acc = acc + z[:, :, t]
    return acc.transpose(0, 1).contiguous()  # (G, np, Pc)


def probe_coupling_rows(xw_t, wcam, jc, jp, v_inv, variant: str):
    """The rows of ``variant`` (``VARIANTS``) of B2's copy: (G, np, W), or
    (G, np, Pc) per-point sums for ``no_atomics``; float32, np = 8, inputs
    as ``wtt_coupling_rows_idx``.  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    block, variant_code = VARIANTS[variant]
    if not is_cuda_call(xw_t):
        return probe_coupling_rows_plain(xw_t, wcam, jc, jp, v_inv, variant)
    from tpu3drecon_torch.ops.wtt_matvec import _check

    name = f"probe_coupling[{variant}]"
    np_cam, g, tb, pc, window = _check(name, xw_t, wcam, jc, jp, v_inv)
    width = pc if variant == "no_atomics" else window
    out = torch.zeros((g, np_cam, width), dtype=xw_t.dtype, device=xw_t.device)
    lib = _build.library()
    code = lib.probe_coupling(
        np_cam, block, variant_code, xw_t.data_ptr(), wcam.data_ptr(), jc.data_ptr(), jp.data_ptr(),
        v_inv.data_ptr(), out.data_ptr(), g, tb, pc, window, _build.stream_ptr(xw_t.device),
    )
    _build.check(lib, name, code)
    COUNTS.kernel += 1
    return out


def run(problem=None, log=print) -> dict:
    """variant -> {"ms", "plain_ms", "max_rel_diff"} (against its plain version),
    "b2" -> {"ms"}: kernel B2 on the same inputs, and "bound_ms": B2's
    bytes (each input read once, the rows written once) at the card's
    memory rate."""
    from tpu3drecon_torch.benchmark.timing import bytes_bound_ms, device_ms, nbytes
    from tpu3drecon_torch.experiments._bal import bal_normal, random_x
    from tpu3drecon_torch.ops.wtt_matvec import wtt_coupling_rows_idx
    from tpu3drecon_torch.solvers.ba_wtt import _xw_t

    problem, _, nb = bal_normal(problem)
    x = random_x(problem, nb.g_cam.shape[1])
    args = [(_xw_t(x, b), b.wcam, bn.jc, bn.jp, bn.v_inv)
            for bn, b in zip(nb.buckets, problem.buckets)]
    n_bytes = sum(2 * nbytes(a[0]) + nbytes(*a[1:]) for a in args)
    out = {"b2": {"ms": device_ms(lambda: [wtt_coupling_rows_idx(*a) for a in args])},
           "bound_ms": bytes_bound_ms(n_bytes)}
    log(f"E1 B2 (256 threads per block): {out['b2']['ms']:.6f} ms per pass over "
        f"{len(args)} buckets; bound {n_bytes} B -> {out['bound_ms']:.6f} ms")
    for variant in VARIANTS:
        rel = 0.0
        for a in args:
            got = probe_coupling_rows(*a, variant)
            want = probe_coupling_rows_plain(*a, variant)
            torch.cuda.synchronize()
            rel = max(rel, float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want))))
        ms = device_ms(lambda variant=variant: [probe_coupling_rows(*a, variant) for a in args])
        plain_ms = device_ms(
            lambda variant=variant: [probe_coupling_rows_plain(*a, variant) for a in args])
        out[variant] = {"ms": ms, "plain_ms": plain_ms, "max_rel_diff": rel}
        block, _ = VARIANTS[variant]
        log(f"E1 {variant} ({block} threads per block): {ms:.6f} ms per pass, "
            f"{ms / out['b2']['ms']:.3f}x B2, plain {plain_ms:.6f} ms; "
            f"max|diff| / max|plain| {rel:.3e}")
        tol = REL.get(variant, REL_ROWS)
        if not rel <= tol:
            raise AssertionError(f"E1 {variant}: {rel:.3e} > {tol:.0e} of its plain version")
    return out


def main() -> int:
    from tpu3drecon_torch.benchmark.timing import card_line

    print(f"nvidia-smi: {card_line()}")
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
