"""Per-bucket device times of the redesigned kernels on the CUDA card, B1
(``wtt_linearize_fused_idx``), B2 (``wtt_coupling_rows_idx``), B3
(``wtt_wt_planes_idx``), B4 (``wtt_cost_cols_idx``), B5
(``wtt_w_rows_idx``), B6 (``wtt_coupling_rows_fused``), B7
(``wtt_cam_planes_idx``), B8 (``wtt_contrib_rows_idx``), B9 and B11
(``cam_normal_idx`` and ``coupling_idx`` per grid pass, with their plane
forms, kernels alone and a sweep over the lanes per thread), B10
(``point_normal_fused`` per grid track bucket, ``point_normal_buckets``
per pass), B12 (``tt_cam_normal_fused``), B13 (``tt_coupling_fused``), B14
(``tt_wt_times_fused``), B15 (``tt_w_times_fused``) and B16
(``tt_cost_fused``), and the registers, shared memory and spills that
``nvcc -Xptxas -v`` reports for their instantiations.

    python -m tpu3drecon_torch.benchmark.wtt_bucket_times [--tt | --grid | --w-rows-sweep]

``chip_smoke.py`` sums each kernel over the buckets of a pass; this script
prints every bucket, each time a ``device_ms`` (median of 20 cold-L2 calls
by CUDA events) at f32, at the initial parameters and lam = 1e-4, as
``chip_smoke.py`` forms its kernel inputs: B1, B2, B3, B4, B5, B7 and B8
(B8 without and with the Schur-Jacobi columns, ``sj=0`` / ``sj=1``; B2, B3,
B5 and B8 on B1's jc/jp/V^-1, random residuals and random y) on the medium
problem (100 cameras, 100k points), on the BAL sequential problem (1712
cameras, with B1 od and B8 od), on its split-window packing (windows of 128 and 256
rows over many groups) and on the BAL hub problem; B6 on the medium
problem with its int8 and its float32 one-hot; B12-B16 on the medium problem in
track-table layout and on ``tt_seq1024`` (1024 cameras, 256 points each;
B13 on random V^-1 planes), B16 also as its kernel alone (``B16 kernel``:
the profiler's mean time of its kernel, without the wrapper's sum and
product); with ``--tt`` only those five; B10 on the medium problem's five
grid track buckets (B9's r/jp planes gathered as the grid solve gathers
them), each alone and as one pass, the grouped ``point_normal_buckets``;
B9 and B11 on the medium grid and on the grid packing of tt_seq1024's
scene (``time_grid_cameras``), with ``--grid`` only B9-B11, first the
launches of one grid linearization (``linearize_launches``).
A wrapper that takes a private
``_mode`` (a memory mode to force, as B5 and B15 do) is also timed with
each mode forced.  ``--w-rows-sweep`` times only B5's two memory modes, on
single-group slices of the medium, BAL sequential and BAL hub buckets at
4 to 128 slots per output entry (``w_rows_sweep``), the numbers that place
``wtt_matvec.w_rows_memory_mode``.  First comes the per-launch floor: the
same cold-L2 ``device_ms`` of one empty kernel launch
(``torch.cuda._sleep(0)``).  The last line is
one JSON object with every time and the card's ``nvidia-smi`` line.  Needs
a CUDA card; the kernels build at first use (a cached build prints no
ptxas lines).  To time another tree's kernels with this script,
run it from there: ``PYTHONPATH=<tree> python <this file>``.
"""

from __future__ import annotations

import inspect
import json
import re
import sys

import torch

from tpu3drecon_torch.benchmark.timing import L2_FLUSH_BYTES, card_line, device_ms

# B1, B2 and B6 (coupling_kernel in wtt_route_kernels.cu; an older tree's
# onehot_coupling_kernel), B3, B4, B5, B8, B9, B10, B11, B12, B13, B14, B15
# and B16, each with the sources it is compiled in; matched with their
# length prefix in the mangled names, so that "coupling_kernel" (B2, B6)
# does not also match tt_coupling_kernel (B13) or grid_coupling_kernel
# (B11), nor "cost_kernel" (B4) tt_cost_kernel (B16).  B9 and B11 are
# grid_cam_normal_kernel and grid_coupling_kernel; an older tree's were
# cam_normal_kernel and coupling_kernel in grid_kernels.cu.
_WTT_SOURCES = ("_wtt_kernels_cu", "_wtt_terms_kernels_cu", "_wtt_route_kernels_cu")
_PTXAS_KERNELS = {
    **dict.fromkeys(("lin_kernel", "onehot_coupling_kernel", "wt_planes_kernel",
                     "cost_kernel", "contrib_kernel", "w_rows_kernel"), _WTT_SOURCES),
    "coupling_kernel": _WTT_SOURCES + ("_grid_kernels_cu",),
    **dict.fromkeys(("tt_cam_normal_kernel", "tt_coupling_kernel", "tt_wt_times_kernel",
                     "tt_w_times_kernel", "tt_cost_kernel"), ("_tt_kernels_cu",)),
    **dict.fromkeys(("point_normal_rows_kernel", "grid_cam_normal_kernel",
                     "grid_coupling_kernel", "cam_normal_kernel"), ("_grid_kernels_cu",)),
}


def ptxas_lines(compiler_out: str) -> list[str]:
    """The ``-Xptxas -v`` lines of B1-B6's, B8-B11's and B12-B16's
    instantiations: each entry function's line with the lines that follow
    it up to the next entry."""
    out, keep = [], False
    for line in compiler_out.splitlines():
        if "entry function" in line:
            name = re.search(r"'([^']*)'", line)
            keep = bool(name) and any(
                f"{len(k)}{k}" in name.group(1) and any(s in name.group(1) for s in sources)
                for k, sources in _PTXAS_KERNELS.items())
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
    """B1, B2, B3, B4, B5, B7 and B8 (``sj`` 0 and 1; with ``od`` also B1 od
    and B8 od) per bucket of ``problem``."""
    from tpu3drecon_torch.geometry.losses import RobustLoss
    from tpu3drecon_torch.ops import wtt_cost
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
        y = torch.randn(3, g, pc, generator=gen).to(jc.device)
        b2 = (d["xw_t"], d["wcam"], jc, jp, v_inv)
        b8 = (d["wcam"], jc, jp, r, v_inv, 8, w)
        b4 = (d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], RobustLoss.TRIVIAL)
        row = {"problem": label, "bucket": bi, "shape": f"G={g} Tb={tb} Pc={pc} W={w}",
               "B1": device_ms(lambda: lin.wtt_linearize_fused_idx(*args)),
               "B2": device_ms(lambda: mv.wtt_coupling_rows_idx(*b2)),
               "B3": device_ms(lambda: mv.wtt_wt_planes_idx(*b2[:4])),
               "B4": device_ms(lambda: wtt_cost.wtt_cost_cols_idx(*b4)),
               "B8 sj=0": device_ms(lambda: lin.wtt_contrib_rows_idx(*b8, False)),
               "B8 sj=1": device_ms(lambda: lin.wtt_contrib_rows_idx(*b8, True))}
        _time_modes(row, "B5", mv.wtt_w_rows_idx,
                    lambda **kw: mv.wtt_w_rows_idx(y, d["wcam"], jc, jp, w, **kw))
        row["B7"] = device_ms(lambda: lin.wtt_cam_planes_idx(d["wcam"], d["tw"], tb))
        if od:
            row["B1 od"] = device_ms(lambda: lin.wtt_linearize_fused_idx(*args, True))
            row["B8 od"] = device_ms(lambda: lin.wtt_contrib_rows_idx(*b8, True, True))
        rows.append(row)
    _print_rows(label, rows)
    return rows


CAM_FIELDS = ("rmats", "tvecs", "fx_fy", "cx_cy_skew", "dist")


def time_grid_buckets(label: str, grid, lam_value=1e-4) -> list[dict]:
    """B10 on the track buckets of a grid ``problem`` (f32, initial
    parameters): ``point_normal_fused`` per bucket, and one pass over all
    of them, the grouped ``point_normal_buckets`` (the last row, bucket
    "pass")."""
    from tpu3drecon_torch.ops import cam_normal, point_normal
    from tpu3drecon_torch.solvers.ba_pallas import (
        _grid_planes,
        _inv_w,
        _track_gather,
        _uv_planes,
    )

    dtype = torch.float32
    cams = grid.cameras
    r, jp, _, _, _ = cam_normal.cam_normal_fused(
        *(getattr(cams, f).to(dtype) for f in CAM_FIELDS),
        _grid_planes(grid.points3d.to(dtype), grid.pt_idx), _uv_planes(grid).to(dtype),
        grid.mask.to(dtype), _inv_w(grid, dtype))
    gathered = _track_gather(jp, r, grid)
    lam = torch.tensor(lam_value, dtype=dtype, device=jp.device)
    rows = []
    for bi, (jp_g, r_g) in enumerate(gathered):
        rows.append({"problem": label, "bucket": bi,
                     "shape": f"P={jp_g.shape[0]} T2={jp_g.shape[1]}",
                     "B10": device_ms(lambda: point_normal.point_normal_fused(jp_g, r_g, lam))})
    _print_rows(label, rows)
    jp_gs, r_gs = [x for x, _ in gathered], [y for _, y in gathered]
    ms = device_ms(lambda: point_normal.point_normal_buckets(jp_gs, r_gs, lam))
    print(f"{label} B10 pass (one grouped call): {ms:.6f} ms", flush=True)
    rows.append({"problem": label, "bucket": "pass", "shape": "one grouped call", "B10": ms})
    return rows


def linearize_launches(label: str, grid) -> dict:
    """Host kernel launches (``cudaLaunchKernel*`` calls) and device
    operations of one grid linearization, ``ba_pallas._linearize`` at the
    initial parameters with lam = 1e-4 and the medium config, any tree's
    alike: ``torch.profiler`` over one call after a warm-up, its trace read
    by ``profile_solve.summarize``.  A solve's own count moves with its
    CG iterations, which its f32 sums may change."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3drecon_torch.benchmark.medium_config import BENCH_CONFIG
    from tpu3drecon_torch.benchmark.profile_solve import summarize
    from tpu3drecon_torch.ops._build import BUILD_DIR
    from tpu3drecon_torch.solvers.ba_pallas import _linearize

    cams = grid.cameras
    params = (cams.rmats, cams.tvecs, cams.fx_fy, grid.points3d)
    lam = torch.tensor(1e-4, dtype=grid.points3d.dtype, device=grid.points3d.device)
    _linearize(params, lam, grid, BENCH_CONFIG)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _linearize(params, lam, grid, BENCH_CONFIG)
        torch.cuda.synchronize()
    path = BUILD_DIR / "profile" / "linearize.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    out = summarize(str(path), 1.0, top=0)
    row = {"problem": label, "bucket": "linearize", "launch_calls": out["launch_calls"],
           "device_ops": out["device_ops"]}
    print(f"{label} one linearization: {row['launch_calls']} launch calls, "
          f"{row['device_ops']} device operations", flush=True)
    return row


def time_grid_cameras(label: str, grid, sweep: bool) -> list[dict]:
    """B9 and B11 on a grid ``problem`` (f32, initial parameters, V^-1 of
    B10 at lam = 1e-4), one pass each: the plane forms (``B9``, ``B11``:
    ``cam_normal_fused`` on the x_w planes, ``coupling_fused`` on the
    gathered V^-1 planes), their kernels alone (``B9 kernel``, ``B11
    kernel``: the profiler's mean, by the kernel's name in this tree), and
    what the grid solve calls (``B9 solve``, ``B11 solve``: the indexed
    forms, or in a tree without them the gathers and the plane forms).
    With ``sweep``, the indexed and plane forms at each LPT the C entries
    take (rows of bucket "sweep")."""
    from tpu3drecon_torch.ops import cam_normal, coupling, point_normal
    from tpu3drecon_torch.solvers.ba_pallas import (
        _grid_planes,
        _inv_w,
        _track_gather,
        _uv_planes,
        _vinv6,
    )

    dtype = torch.float32
    cam = tuple(getattr(grid.cameras, f).to(dtype) for f in CAM_FIELDS)
    pts, pt_idx = grid.points3d.to(dtype), grid.pt_idx
    tail = (_uv_planes(grid).to(dtype), grid.mask.to(dtype), _inv_w(grid, dtype))
    planes = (*cam, _grid_planes(pts, pt_idx), *tail)
    _, jp, jc, _, _ = out = cam_normal.cam_normal_fused(*planes)
    gathered = _track_gather(jp, out[0], grid)
    lam = torch.tensor(1e-4, dtype=dtype, device=jp.device)
    v_inv = point_normal.point_normal_buckets([x for x, _ in gathered],
                                              [y for _, y in gathered], lam)[0]
    v_inv = v_inv[:pts.shape[0]]
    vinv6_g = _grid_planes(_vinv6(v_inv), pt_idx)
    new = hasattr(cam_normal, "cam_normal_idx")
    names = ("grid_cam_normal_kernel", "grid_coupling_kernel") if new else (
        "cam_normal_kernel", "coupling_kernel")
    if new:
        idx = (*cam, pts, pt_idx, *tail)

        def b9_solve(**kw):
            return cam_normal.cam_normal_idx(*idx, **kw)

        def b11_solve(**kw):
            return coupling.coupling_idx(jc, jp, v_inv, pt_idx, **kw)
    else:
        def b9_solve():
            return cam_normal.cam_normal_fused(*cam, _grid_planes(pts, pt_idx), *tail)

        def b11_solve():
            return coupling.coupling_fused(jc, jp, _grid_planes(_vinv6(v_inv), pt_idx))

    c, k = pt_idx.shape
    row = {"problem": label, "bucket": "pass", "shape": f"C={c} K={k}",
           "B9": device_ms(lambda: cam_normal.cam_normal_fused(*planes)),
           "B9 kernel": kernel_alone_ms(lambda: cam_normal.cam_normal_fused(*planes),
                                        names[0]),
           "B9 solve": device_ms(b9_solve),
           "B11": device_ms(lambda: coupling.coupling_fused(jc, jp, vinv6_g)),
           "B11 kernel": kernel_alone_ms(lambda: coupling.coupling_fused(jc, jp, vinv6_g),
                                         names[1]),
           "B11 solve": device_ms(b11_solve)}
    if new:
        row["LPT"] = cam_normal.grid_lanes(k, 4)
    print(f"{label} B9/B11 pass ({row['shape']}"
          + (f", LPT={row['LPT']}" if new else "") + "): "
          + " ".join(f"{key} {v:.6f} ms" for key, v in row.items() if key.startswith("B")),
          flush=True)
    rows = [row]
    if not (sweep and new):
        return rows
    for lanes in cam_normal.LANES:
        kw = dict(_lanes=lanes)
        sw = {"problem": label, "bucket": "sweep", "LPT": lanes,
              "B9": device_ms(lambda: cam_normal.cam_normal_fused(*planes, **kw)),
              "B9 kernel": kernel_alone_ms(
                  lambda: cam_normal.cam_normal_fused(*planes, **kw), names[0]),
              "B9 idx": device_ms(lambda: b9_solve(**kw)),
              "B11": device_ms(lambda: coupling.coupling_fused(jc, jp, vinv6_g, **kw)),
              "B11 kernel": kernel_alone_ms(
                  lambda: coupling.coupling_fused(jc, jp, vinv6_g, **kw), names[1]),
              "B11 idx": device_ms(lambda: b11_solve(**kw))}
        print(f"{label} sweep LPT={lanes}: "
              + " ".join(f"{key} {v:.6f} ms" for key, v in sw.items() if key.startswith("B")),
              flush=True)
        rows.append(sw)
    return rows


# Slots per (np, W) output entry of the single-group slices that
# ``w_rows_sweep`` times B5's two memory modes on.
SWEEP_SLOTS_PER_ENTRY = (4, 6, 8, 12, 16, 24, 36, 64, 128)


def w_rows_sweep(label: str, problem, np_cam: int = 8) -> list[dict]:
    """B5 with each memory mode forced on single-group slices of
    ``problem``: for each window width, group 0 of the bucket of that width
    with the most slots per group, cut to about each of
    ``SWEEP_SLOTS_PER_ENTRY`` slots per output entry by keeping every k-th
    block of 32 point columns (so that each warp keeps its points' rows and
    the slice spans the window); y random."""
    from tpu3drecon_torch.ops import _build
    from tpu3drecon_torch.ops import wtt_linearize as lin
    from tpu3drecon_torch.ops import wtt_matvec as mv
    from tpu3drecon_torch.solvers.bundle_adjust import BAConfig

    widest = {}
    for bi, d in enumerate(bucket_inputs(problem)):
        _, tb, pc, w = d["shape"]
        if tb * pc > widest.get(w, (0, -1, None))[0]:
            widest[w] = (tb * pc, bi, d)
    gen = torch.Generator(device="cpu").manual_seed(2)
    rows = []
    for w, (_, bi, d) in sorted(widest.items()):
        _, tb, pc, _ = d["shape"]
        _, jc, jp, _, _, _ = lin.wtt_linearize_fused_idx(
            d["wcam"], d["tw"], d["pts"], d["uv"], d["mask"], d["lam"], d["inv_w"],
            BAConfig(), np_cam, True)
        jc, jp = jc[:, :1], jp[:, :1]
        blocks = pc // 32
        for spe in SWEEP_SLOTS_PER_ENTRY:
            keep = -(-spe * np_cam * w // (tb * 32))
            if keep > blocks:
                break
            step = blocks // keep
            cols = ((torch.arange(keep) * step)[:, None] * 32 + torch.arange(32)).flatten()
            cols = cols.to(jc.device)
            n = cols.numel()
            wcam = d["wcam"][:1].reshape(1, tb, pc)[..., cols].reshape(1, tb * n).contiguous()
            jc_s, jp_s = (x[..., cols].contiguous() for x in (jc, jp))
            y = torch.randn(3, 1, n, generator=gen).to(jc.device)
            row = {"problem": label, "bucket": bi, "W": w, "Tb": tb, "Pc": n,
                   "slots_per_entry": tb * n / (np_cam * w)}
            for mode in (_build.SHARED, _build.GLOBAL):
                row[mode] = device_ms(lambda: mv.wtt_w_rows_idx(y, wcam, jc_s, jp_s, w,
                                                                _mode=mode))
            print(f"{label} B5 sweep bucket {bi} (G=1 Tb={tb} Pc={n} W={w}, "
                  f"{row['slots_per_entry']:.2f} slots per entry): "
                  + " ".join(f"{m} {row[m]:.6f} ms" for m in (_build.SHARED, _build.GLOBAL)),
                  flush=True)
            rows.append(row)
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


def kernel_alone_ms(fn, kernel: str, n: int = 20, attempts: int = 5) -> float:
    """Mean device time (ms) of the port's kernel ``kernel`` in one call of
    ``fn``: ``torch.profiler`` over ``n`` calls, each after a 128 MB write
    that evicts the L2, its trace read as ``profile_solve`` reads it.  The
    kernel alone, without the other launches of ``fn`` or the gaps between
    them, and by its name, so that any tree's kernel is timed the same way.
    The profiler now and then drops some of a trace's kernel events (an H100
    under PyTorch 2.11): a trace without all ``n`` launches is taken again,
    up to ``attempts`` times, and if none has them all, the mean is that of
    the fullest trace's launches, provided it holds at least half of them.
    A trace with more than ``n`` means ``fn`` launches the kernel more than
    once, and raises."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3drecon_torch.benchmark.profile_solve import summarize
    from tpu3drecon_torch.ops._build import BUILD_DIR

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    path = BUILD_DIR / "profile" / "kernel_alone.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    seen, best = [], None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        rows = [r for r in summarize(str(path), 1.0, top=0)["port"]
                if f"::{kernel}<" in r["kernel"]]
        launches = [r["launches"] for r in rows]
        seen.append(launches)
        if len(rows) > 1 or sum(launches) > n:
            raise RuntimeError(f"{kernel}: {launches} launches in {n} calls")
        if launches == [n]:
            return rows[0]["mean_us"] * 1e-3
        if rows and (best is None or rows[0]["launches"] > best["launches"]):
            best = rows[0]
    if best is not None and 2 * best["launches"] >= n:
        print(f"{kernel}: the profiler kept {seen} of {n} launches in {attempts} traces; "
              f"the mean of the {best['launches']} of the fullest", flush=True)
        return best["mean_us"] * 1e-3
    raise RuntimeError(f"{kernel}: {seen} launches in {n} calls, {attempts} traces")


def time_tt_buckets(label: str, problem) -> list[dict]:
    """B12-B16 per bucket of a track-table ``problem``: B12 and B16 at the
    initial parameters (B16 also as its kernel alone), B13, B14 and B15 on
    B12's jc/jp, V^-1, x and y random."""
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
        b16 = b12[:7]
        _time_modes(row, "B16", tt.tt_cost_fused, lambda **kw: tt.tt_cost_fused(*b16, **kw))
        row["B16 kernel"] = kernel_alone_ms(lambda: tt.tt_cost_fused(*b16), "tt_cost_kernel")
        rows.append(row)
    _print_rows(label, rows)
    return rows


def seq1024_flat(dev):
    """``chip_smoke.py``'s 1024-camera sequential scene (f32), flat."""
    from tpu3drecon_torch.dataset.synthetic import (
        make_sequential_scene,
        perturb_scene,
        scene_to_ba_problem,
    )

    scene = make_sequential_scene(n_cameras=1024, points_per_camera=256, track_span=4,
                                  seed=7)
    flat, _ = scene_to_ba_problem(perturb_scene(scene, seed=8, point2d_noise=0.5),
                                  observed=scene, dtype=torch.float32, device=dev)
    return flat


def tt_seq1024(dev):
    """``chip_smoke.py``'s tt_seq1024 track table (f32)."""
    from tpu3drecon_torch.problems.tt import tt_from_flat

    return tt_from_flat(seq1024_flat(dev), device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("wtt_bucket_times: no CUDA device", file=sys.stderr)
        return 2
    from tpu3drecon_torch.benchmark.balscale import bal_hub_wtt, bal_sequential_wtt
    from tpu3drecon_torch.benchmark.medium_config import (
        build_grid_problem,
        build_problem,
        build_tt_problem,
    )
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
    if "--w-rows-sweep" in sys.argv[1:]:
        sweep = w_rows_sweep("medium", wtt_from_flat(build_problem(dev), defer_onehot=True,
                                                     device=dev))
        sweep += w_rows_sweep("bal_seq", bal_sequential_wtt(device=dev, verbose=False))
        sweep += w_rows_sweep("bal_hub", bal_hub_wtt(device=dev, verbose=False))
        print(json.dumps({"card": smi, "floor_ms": floor, "w_rows_sweep": sweep}))
        return 0
    if "--grid" in sys.argv[1:]:
        from tpu3drecon_torch.problems.grid import grid_bucketed_from_flat

        grid = build_grid_problem(dev, torch.float32)
        rows = [linearize_launches("medium grid", grid)]
        rows += time_grid_buckets("medium grid", grid)
        rows += time_grid_cameras("medium grid", grid, sweep=True)
        rows += time_grid_cameras("grid_seq1024", grid_bucketed_from_flat(seq1024_flat(dev)),
                                  sweep=True)
        print(json.dumps({"card": smi, "floor_ms": floor, "buckets": rows}))
        return 0
    rows = time_tt_buckets("medium tt", build_tt_problem(dev))
    rows += time_tt_buckets("tt_seq1024", tt_seq1024(dev))
    if "--tt" not in sys.argv[1:]:
        grid = build_grid_problem(dev, torch.float32)
        rows += time_grid_buckets("medium grid", grid)
        rows += time_grid_cameras("medium grid", grid, sweep=False)
        flat = build_problem(dev)
        rows += time_onehot_buckets("medium one-hot", wtt_from_flat(flat, defer_onehot=False,
                                                                    device=dev))
        rows += time_buckets("medium", wtt_from_flat(flat, defer_onehot=True, device=dev),
                             od=False)
        rows += time_buckets("bal_seq", bal_sequential_wtt(device=dev, verbose=False),
                             od=True)
        rows += time_buckets("bal_seq_split", bal_sequential_wtt(split_windows=True, device=dev,
                                                                 verbose=False), od=False)
        rows += time_buckets("bal_hub", bal_hub_wtt(device=dev, verbose=False), od=False)
    print(json.dumps({"card": smi, "floor_ms": floor, "buckets": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
