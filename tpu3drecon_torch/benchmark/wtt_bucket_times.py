"""Per-bucket device times of kernels B1 (``wtt_linearize_fused_idx``) and
B2 (``wtt_coupling_rows_idx``) on the CUDA card, and the registers,
shared memory and spills that ``nvcc -Xptxas -v`` reports for their
instantiations.

    python -m tpu3drecon_torch.benchmark.wtt_bucket_times

``chip_smoke.py`` sums each kernel over the buckets of a pass; this script
prints every bucket of the medium problem (100 cameras, 100k points), the
BAL sequential problem (1712 cameras) and the BAL hub problem: B1 (and
B1 od on the BAL buckets) and B2 at f32, each ``device_ms`` (median of 20
cold-L2 calls by CUDA events), at the initial parameters and lam = 1e-4,
as ``chip_smoke.py`` forms its kernel inputs.  The last line is one JSON
object with every time and the card's ``nvidia-smi`` line.  Needs a CUDA
card; the kernels build at first use (a cached build prints no ptxas
lines).
"""

from __future__ import annotations

import json
import re
import sys

import torch

from tpu3drecon_torch.benchmark.timing import card_line, device_ms

_PTXAS_KERNELS = ("lin_kernel", "coupling_kernel")
_PTXAS_SOURCES = ("_wtt_kernels_cu", "_wtt_terms_kernels_cu")  # in the mangled names


def ptxas_lines(compiler_out: str) -> list[str]:
    """The ``-Xptxas -v`` lines of B1's and B2's instantiations: each entry
    function's line with the lines that follow it up to the next entry."""
    out, keep = [], False
    for line in compiler_out.splitlines():
        if "entry function" in line:
            name = re.search(r"'([^']*)'", line)
            keep = (bool(name) and any(k in name.group(1) for k in _PTXAS_KERNELS)
                    and any(s in name.group(1) for s in _PTXAS_SOURCES))
        if keep and ("entry function" in line or "registers" in line or "spill" in line
                     or "smem" in line):
            out.append(line.strip())
    return out


def bucket_inputs(problem, lam_value=1e-4, np_cam=8):
    """Per-bucket f32 inputs of B1 and B2 at the initial parameters."""
    from tpu3drecon_torch.solvers.ba_wtt import (
        _inv_w,
        _padded_table,
        _window_idx,
        _window_rows,
    )

    cams = problem.cameras
    dev = problem.points3d.device
    dtype = torch.float32
    params = (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew, None)
    table = _padded_table(params, problem.c_pad).to(dtype)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for bucket, off in zip(problem.buckets, problem.bucket_offsets):
        g, _, tb, pc = bucket.uv.shape
        widx = _window_idx(bucket)
        pts = problem.points3d[off : off + g * pc].reshape(g, pc, 3)
        x = torch.randn(problem.c_pad, np_cam, generator=gen, dtype=torch.float64)
        yield dict(
            wcam=bucket.wcam,
            tw=_window_rows(table, widx).contiguous(),
            pts=pts.permute(2, 0, 1).contiguous().to(dtype),
            uv=bucket.uv.to(dtype),
            mask=bucket.mask.to(dtype),
            lam=torch.tensor(lam_value, dtype=dtype, device=dev),
            inv_w=_inv_w(problem, dtype),
            xw_t=_window_rows(x.to(dev, dtype), widx).transpose(1, 2).contiguous(),
            shape=(g, tb, pc, bucket.window),
        )


def time_buckets(label: str, problem, od: bool) -> list[dict]:
    """B1 (and with ``od`` B1 od) and B2 per bucket of ``problem``."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cfg = BAConfig()
    rows = []
    for bi, d in enumerate(bucket_inputs(problem)):
        g, tb, pc, w = d["shape"]
        args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
                cfg, 8, True)
        _, jc, jp, v_inv, _, _ = lin.wtt_linearize_fused_idx(*args)
        b2 = (d["xw_t"], d["wcam"], jc, jp, v_inv)
        row = {"problem": label, "bucket": bi, "G": g, "Tb": tb, "Pc": pc, "W": w,
               "B1": device_ms(lambda: lin.wtt_linearize_fused_idx(*args)),
               "B2": device_ms(lambda: mv.wtt_coupling_rows_idx(*b2))}
        if od:
            row["B1 od"] = device_ms(lambda: lin.wtt_linearize_fused_idx(*args, True))
        print(f"{label} bucket {bi} (G={g} Tb={tb} Pc={pc} W={w}): "
              + " ".join(f"{k} {v:.6f} ms" for k, v in row.items()
                         if k.startswith("B")), flush=True)
        rows.append(row)
    sums = {k: sum(r[k] for r in rows) for k in rows[0] if k.startswith("B")}
    print(f"{label} per pass: " + " ".join(f"{k} {v:.6f} ms" for k, v in sums.items()),
          flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("wtt_bucket_times: no CUDA device", file=sys.stderr)
        return 2
    from tpu3drecon_torch.benchmark.balscale import bal_hub_wtt, bal_sequential_wtt
    from tpu3drecon_torch.benchmark.medium_config import build_problem
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.problems.wtt import wtt_from_flat

    smi = card_line()
    print(f"nvidia-smi: {smi}", flush=True)
    _, compiler_out = _build.build()
    _build.library()
    for line in ptxas_lines(compiler_out) or ["(cached build: no ptxas lines)"]:
        print("  " + line, flush=True)
    dev = torch.device("cuda", 0)
    rows = time_buckets("medium", wtt_from_flat(build_problem(dev), defer_onehot=True,
                                                device=dev), od=False)
    rows += time_buckets("bal_seq", bal_sequential_wtt(device=dev, verbose=False), od=True)
    rows += time_buckets("bal_hub", bal_hub_wtt(device=dev, verbose=False), od=False)
    print(json.dumps({"card": smi, "buckets": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
