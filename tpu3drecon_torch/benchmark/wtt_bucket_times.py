"""Per-bucket device times of the slot-major kernels on the CUDA card, B1
(``wtt_linearize_fused_idx``), B2 (``wtt_coupling_rows_idx``), B6
(``wtt_coupling_rows_fused``), B8 (``wtt_contrib_rows_idx``), B12
(``tt_cam_normal_fused``), B13 (``tt_coupling_fused``), B14
(``tt_wt_times_fused``) and B15 (``tt_w_times_fused``), and the registers,
shared memory and spills that ``nvcc -Xptxas -v`` reports for their
instantiations.

    python -m tpu3drecon_torch.benchmark.wtt_bucket_times [--tt]

``chip_smoke.py`` sums each kernel over the buckets of a pass; this script
prints every bucket, each time a ``device_ms`` (median of 20 cold-L2 calls
by CUDA events) at f32, at the initial parameters and lam = 1e-4, as
``chip_smoke.py`` forms its kernel inputs: B1, B2 and B8 (without and
with the Schur-Jacobi columns, ``sj=0`` / ``sj=1``, on B1's jc/jp/V^-1 and
random residuals) on the medium problem (100 cameras, 100k points), on the
BAL sequential problem (1712 cameras, with B1 od and B8 od) and on the BAL
hub problem; B6 on the medium problem with its int8 and its float32
one-hot; B12-B15 on the medium problem in track-table layout and on
``tt_seq1024`` (1024 cameras, 256 points each; B13 on random V^-1 planes);
with ``--tt`` only those four.  A wrapper that takes
a private ``_mode`` (a memory mode to force, as B12 and B15 do) is also
timed with each mode forced.  First comes the per-launch floor: the same
cold-L2 ``device_ms`` of one empty kernel launch (``torch.cuda._sleep(0)``).
The last line is one JSON object with every time and the card's
``nvidia-smi`` line.  Needs a CUDA card; the kernels build at first use (a cached build
prints no ptxas lines).  To time another tree's kernels with this script,
run it from there: ``PYTHONPATH=<tree> python <this file>``.
"""

from __future__ import annotations

import inspect
import json
import re
import sys

import torch

from tpu3drecon_torch.benchmark.timing import card_line, device_ms

# B1, B2 and B6 (coupling_kernel in wtt_route_kernels.cu; an older tree's
# onehot_coupling_kernel), B8, B12, B13, B14 and B15; matched with their
# length prefix in the mangled names, so that "coupling_kernel" (B2, B6)
# does not also match tt_coupling_kernel (B13).
_PTXAS_KERNELS = ("lin_kernel", "coupling_kernel", "onehot_coupling_kernel", "contrib_kernel",
                  "tt_cam_normal_kernel", "tt_coupling_kernel", "tt_wt_times_kernel",
                  "tt_w_times_kernel")
_PTXAS_SOURCES = ("_wtt_kernels_cu", "_wtt_terms_kernels_cu", "_wtt_route_kernels_cu",
                  "_tt_kernels_cu")


def ptxas_lines(compiler_out: str) -> list[str]:
    """The ``-Xptxas -v`` lines of B1's, B2's, B6's, B8's and B12-B15's
    instantiations: each entry function's line with the lines that follow
    it up to the next entry."""
    out, keep = [], False
    for line in compiler_out.splitlines():
        if "entry function" in line:
            name = re.search(r"'([^']*)'", line)
            keep = (bool(name) and any(f"{len(k)}{k}" in name.group(1) for k in _PTXAS_KERNELS)
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


def _modes(fn) -> list:
    """[None] for a wrapper in one memory mode; with a private ``_mode``
    also each mode forced."""
    if "_mode" not in inspect.signature(fn).parameters:
        return [None]
    from tpu3drecon_torch.ops import _build

    return [None, _build.SHARED, _build.GLOBAL]


def _time_modes(row: dict, key: str, fn, call) -> None:
    """row[key] (and row[f"{key} {mode}"] per forced mode) = device ms of
    ``call(**kw)``."""
    for mode in _modes(fn):
        kw = {} if mode is None else {"_mode": mode}
        row[key if mode is None else f"{key} {mode}"] = device_ms(lambda: call(**kw))


def _print_rows(label: str, rows: list[dict]) -> None:
    for r in rows:
        print(f"{label} bucket {r['bucket']} ({r['shape']}): "
              + " ".join(f"{k} {v:.6f} ms" for k, v in r.items() if k.startswith("B")),
              flush=True)
    sums = {k: sum(r[k] for r in rows) for k in rows[0] if k.startswith("B")}
    print(f"{label} per pass: " + " ".join(f"{k} {v:.6f} ms" for k, v in sums.items()),
          flush=True)


def time_buckets(label: str, problem, od: bool) -> list[dict]:
    """B1, B2 and B8 (``sj`` 0 and 1; with ``od`` also B1 od and B8 od) per
    bucket of ``problem``."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cfg = BAConfig()
    gen = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for bi, d in enumerate(bucket_inputs(problem)):
        g, tb, pc, w = d["shape"]
        args = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
                cfg, 8, True)
        _, jc, jp, v_inv, _, _ = lin.wtt_linearize_fused_idx(*args)
        r = torch.randn(2, g, tb, pc, generator=gen).to(jc.device)
        b2 = (d["xw_t"], d["wcam"], jc, jp, v_inv)
        b8 = (d["wcam"], jc, jp, r, v_inv, 8, w)
        row = {"problem": label, "bucket": bi, "shape": f"G={g} Tb={tb} Pc={pc} W={w}",
               "B1": device_ms(lambda: lin.wtt_linearize_fused_idx(*args)),
               "B2": device_ms(lambda: mv.wtt_coupling_rows_idx(*b2)),
               "B8 sj=0": device_ms(lambda: lin.wtt_contrib_rows_idx(*b8, False)),
               "B8 sj=1": device_ms(lambda: lin.wtt_contrib_rows_idx(*b8, True))}
        if od:
            row["B1 od"] = device_ms(lambda: lin.wtt_linearize_fused_idx(*args, True))
            row["B8 od"] = device_ms(lambda: lin.wtt_contrib_rows_idx(*b8, True, True))
        rows.append(row)
    _print_rows(label, rows)
    return rows


def time_onehot_buckets(label: str, problem) -> list[dict]:
    """B6 per bucket of ``problem`` (packed with its int8 one-hot), with
    the int8 one-hot and the same one-hot in float32."""
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    rows = []
    for bi, (d, bucket) in enumerate(zip(bucket_inputs(problem), problem.buckets)):
        g, tb, pc, w = d["shape"]
        _, jc, jp, v_inv, _, _ = lin.wtt_linearize_fused_idx(
            d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
            BAConfig(), 8, True)
        row = {"problem": label, "bucket": bi, "shape": f"G={g} Tb={tb} Pc={pc} W={w}"}
        for oh in (bucket.onehot, bucket.onehot.to(torch.float32)):
            _time_modes(row, f"B6 {str(oh.dtype).split('.')[-1]}", mv.wtt_coupling_rows_fused,
                        lambda oh=oh, **kw: mv.wtt_coupling_rows_fused(d["xw_t"], oh, jc, jp,
                                                                      v_inv, **kw))
        rows.append(row)
    _print_rows(label, rows)
    return rows


def time_tt_buckets(label: str, problem) -> list[dict]:
    """B12-B15 per bucket of a track-table ``problem``: B12 at the initial
    parameters, B13, B14 and B15 on its jc/jp, V^-1, x and y random."""
    from tpu3drecon_torch.ops import tt_linearize as tt
    from tpu3drecon_torch.solvers.ba_tt import _cam_table, _inv_w
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    cams = problem.cameras
    table = _cam_table(cams.rmats, cams.tvecs, cams.fx_fy, cams.cx_cy_skew,
                       cams.dist).to(torch.float32).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for bi, (bucket, off) in enumerate(zip(problem.buckets, problem.bucket_offsets)):
        tb, pb = bucket.mask.shape
        mask = bucket.mask.to(torch.float32)
        pts = problem.points3d[off : off + pb].T.contiguous().to(torch.float32)
        jc, jp = tt.tt_cam_normal_fused(table, bucket.cam_ids, pts,
                                        bucket.uv.to(torch.float32), mask,
                                        _inv_w(problem, torch.float32), BAConfig(), 8)[:2]
        y = torch.randn(3, pb, generator=gen).to(mask.device)
        x = torch.randn(problem.n_cameras, 8, generator=gen).to(mask.device)
        v_inv = torch.randn(6, pb, generator=gen).to(mask.device)
        b12 = (table, bucket.cam_ids, pts, bucket.uv.to(torch.float32), mask,
               _inv_w(problem, torch.float32), BAConfig(), 8)
        row = {"problem": label, "bucket": bi, "shape": f"C={problem.n_cameras} Tb={tb} Pb={pb}"}
        _time_modes(row, "B12", tt.tt_cam_normal_fused,
                    lambda **kw: tt.tt_cam_normal_fused(*b12, **kw))
        _time_modes(row, "B13", tt.tt_coupling_fused,
                    lambda **kw: tt.tt_coupling_fused(bucket.cam_ids, mask, jc, jp, v_inv,
                                                      problem.n_cameras, **kw))
        _time_modes(row, "B14", tt.tt_wt_times_fused,
                    lambda **kw: tt.tt_wt_times_fused(x, bucket.cam_ids, mask, jc, jp, **kw))
        _time_modes(row, "B15", tt.tt_w_times_fused,
                    lambda **kw: tt.tt_w_times_fused(y, bucket.cam_ids, mask, jc, jp,
                                                     problem.n_cameras, **kw))
        rows.append(row)
    _print_rows(label, rows)
    return rows


def tt_seq1024(dev):
    """``chip_smoke.py``'s tt_seq1024 track table (f32)."""
    from tpu3drecon_torch.dataset.synthetic import (
        make_sequential_scene,
        perturb_scene,
        scene_to_ba_problem,
    )
    from tpu3drecon_torch.problems.tt import tt_from_flat

    scene = make_sequential_scene(n_cameras=1024, points_per_camera=256, track_span=4,
                                  seed=7)
    flat, _ = scene_to_ba_problem(perturb_scene(scene, seed=8, point2d_noise=0.5),
                                  observed=scene, dtype=torch.float32, device=dev)
    return tt_from_flat(flat, device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("wtt_bucket_times: no CUDA device", file=sys.stderr)
        return 2
    from tpu3drecon_torch.benchmark.balscale import bal_hub_wtt, bal_sequential_wtt
    from tpu3drecon_torch.benchmark.medium_config import build_problem, build_tt_problem
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.problems.wtt import wtt_from_flat

    smi = card_line()
    print(f"nvidia-smi: {smi}", flush=True)
    _, compiler_out = _build.build()
    _build.library()
    for line in ptxas_lines(compiler_out) or ["(cached build: no ptxas lines)"]:
        print("  " + line, flush=True)
    floor = device_ms(lambda: torch.cuda._sleep(0))
    print(f"per-launch floor (one empty kernel, cold-L2 device_ms): {floor:.6f} ms", flush=True)
    dev = torch.device("cuda", 0)
    rows = time_tt_buckets("medium tt", build_tt_problem(dev))
    rows += time_tt_buckets("tt_seq1024", tt_seq1024(dev))
    if "--tt" not in sys.argv[1:]:
        flat = build_problem(dev)
        rows += time_onehot_buckets("medium one-hot", wtt_from_flat(flat, defer_onehot=False,
                                                                    device=dev))
        rows += time_buckets("medium", wtt_from_flat(flat, defer_onehot=True, device=dev),
                             od=False)
        rows += time_buckets("bal_seq", bal_sequential_wtt(device=dev, verbose=False),
                             od=True)
        rows += time_buckets("bal_hub", bal_hub_wtt(device=dev, verbose=False), od=False)
    print(json.dumps({"card": smi, "floor_ms": floor, "buckets": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
