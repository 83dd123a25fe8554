"""E2: kernel B2 at its three fidelities on the BAL buckets.

Counterpart of ``experiments/tpu_index_matvec3.py``, which ran a copy of
the TPU coupling kernel at hi6 / split3 / split2 / bf16 beside the XLA
product.  Here the same coupling product W V^-1 W^T x of the
1712-camera BAL sequential problem (``bal_sequential_wtt()``, unsplit,
linearized by B1 at lam = 1e-3) runs as

- ``terms3``: B2 exact (JAX's hi6 and split3),
- ``terms2`` / ``terms1``: B2 with x and z rounded through 2 or 1 bfloat16
  split pieces (JAX's split2 and bf16; ``matvec_kernel`` "index2" /
  "index1"),
- ``plane``: the port's PyTorch gather/scatter product (JAX's xla mode),

on one float32 x (numpy seed 0).  Each prints its max|diff| over
max|rows| against float64 rows (the plain version on float64 copies of the
same inputs) and its device time per matvec (window gathers, kernel and
tile scatters of all buckets; ``benchmark.timing.device_ms``, cold L2);
the bound is B2's bytes over all buckets (each input read once, the rows
written once) at the card's memory rate.

    python -m tpu3drecon_torch.experiments.index_matvec3
"""

from __future__ import annotations

MODES = ("terms3", "terms2", "terms1", "plane")


def coupling(nb, problem, x, mode: str):
    """(c_pad, np) coupling rows sum_b W V^-1 W^T x of ``mode``."""
    import torch

    from tpu3drecon_torch.ops.wtt_matvec import wtt_coupling_rows_idx
    from tpu3drecon_torch.solvers.ba_tt import _sym3_matvec
    from tpu3drecon_torch.solvers.ba_wtt import (
        _scatter_rows,
        _w_times_plane,
        _window_idx,
        _wt_times_plane,
        _xw_t,
    )

    coup = torch.zeros_like(x)
    for bn, bucket in zip(nb.buckets, problem.buckets):
        if mode == "plane":
            vw = _sym3_matvec(bn.v_inv, _wt_times_plane(bn, x, bucket))
            coup = coup + _w_times_plane(bn, vw, bucket, problem.c_pad)
            continue
        rows = wtt_coupling_rows_idx(_xw_t(x, bucket), bucket.wcam, bn.jc, bn.jp, bn.v_inv,
                                     int(mode[-1]))
        coup = coup + _scatter_rows(rows.transpose(1, 2), _window_idx(bucket), problem.c_pad)
    return coup


def reference(nb, problem, x):
    """The coupling rows in float64: the plain version on float64 copies."""
    import torch

    from tpu3drecon_torch.ops.wtt_matvec import wtt_coupling_rows_idx_plain
    from tpu3drecon_torch.solvers.ba_wtt import _scatter_rows, _window_idx, _xw_t

    x64 = x.double()
    coup = torch.zeros_like(x64)
    for bn, bucket in zip(nb.buckets, problem.buckets):
        rows = wtt_coupling_rows_idx_plain(_xw_t(x64, bucket), bucket.wcam, bn.jc.double(),
                                           bn.jp.double(), bn.v_inv.double())
        coup = coup + _scatter_rows(rows.transpose(1, 2), _window_idx(bucket), problem.c_pad)
    return coup


def run(problem=None, log=print) -> dict:
    """mode -> {"max_rel_diff", "ms"}, and "bound_ms"; ``problem``
    defaults to ``bal_sequential_wtt()`` on the card."""
    import torch

    from tpu3drecon_torch.benchmark.timing import bytes_bound_ms, device_ms, nbytes
    from tpu3drecon_torch.experiments._bal import bal_normal, random_x
    from tpu3drecon_torch.solvers.ba_wtt import _xw_t

    problem, _, nb = bal_normal(problem)
    x = random_x(problem, nb.g_cam.shape[1])
    ref = reference(nb, problem, x)
    scale = float(torch.max(torch.abs(ref)))
    n_bytes = sum(2 * nbytes(_xw_t(x, b)) + nbytes(b.wcam, bn.jc, bn.jp, bn.v_inv)
                  for bn, b in zip(nb.buckets, problem.buckets))
    log(f"E2 bound: {n_bytes} B of B2 inputs and rows per pass -> "
        f"{bytes_bound_ms(n_bytes):.6f} ms")
    out = {"bound_ms": bytes_bound_ms(n_bytes)}
    for mode in MODES:
        got = coupling(nb, problem, x, mode)
        rel = float(torch.max(torch.abs(got.double() - ref))) / scale
        ms = device_ms(lambda mode=mode: coupling(nb, problem, x, mode))
        out[mode] = {"max_rel_diff": rel, "ms": ms}
        log(f"E2 {mode}: max|diff| / max|rows| vs float64 {rel:.3e}, {ms:.6f} ms/matvec")
    if not out["terms3"]["max_rel_diff"] < out["terms2"]["max_rel_diff"] < \
            out["terms1"]["max_rel_diff"]:
        raise AssertionError(f"E2: the error does not grow as terms fall: {out}")
    return out


def main() -> int:
    from tpu3drecon_torch.benchmark.timing import card_line

    print(f"nvidia-smi: {card_line()}")
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
