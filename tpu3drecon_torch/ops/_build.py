"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file, all
of them at once in parallel, and the objects link into one shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds.  The library lands in ``tpu3drecon_torch/_build/``
under a name keyed by a hash of the sources and flags, so a stale build is
never loaded.  Nothing here runs at import time: ``library()`` builds at
first use.

Every C entry returns ``cudaGetLastError()`` after its launch (or a
negative code for arguments the kernels do not take); ``check`` raises on
anything but 0, with the message of ``kernel_error_string``
(``csrc/common.cu``).

Memory modes (``csrc/slot.cuh``): the kernels read camera rows and x from
device memory and reduce straight into the output rows (``GLOBAL``), so no
window width or camera count is refused.  B15 and B5 also keep a
``SHARED`` mode, a block-shared tile of their output rows that measured
faster at small camera counts and narrow windows
(``ops/tt_linearize.py memory_mode``, ``ops/wtt_matvec.py
w_rows_memory_mode``); their C entries take the tile's bytes (0 for
``GLOBAL``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tpu3drecon_torch.utils.timing import count, span

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# --fmad=false: every product and sum is rounded on its own, as PyTorch's
# elementwise ops round them, so a kernel and its plain version agree to
# the last bits outside their reductions.  That matters for the closed-form
# V^-1 of a point seen once: V = J^T J + lam diag is ill-conditioned
# (~1/lam), and a fused multiply-add in its cofactors moves the inverse by
# ~eps/lam relative.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# argtypes of every C entry of csrc/*.cu (pointers and the stream as
# c_void_p: a plain int would be cut to 32 bits).
_SIGNATURES = {
    # dtype, np, terms, wcam, tw, pts, uv, mask, lam, inv_w, rows, jc, jp,
    # vinv, gpt, damp, G, Tb, Pc, W, use_sj, want_od, loss, focal, points,
    # dist, pp, tc, ng, smem, stream
    "wtt_linearize": [_I, _I, _I] + [_P] * 13 + [_I] * 14 + [_P],
    # dtype, np, terms, xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, tc, ng,
    # smem, stream
    "wtt_coupling": [_I, _I, _I] + [_P] * 6 + [_I] * 7 + [_P],
    # dtype, np, xw_t, wcam, jc, jp, out, G, Tb, Pc, W, tc, ng, smem, stream
    "wtt_wt_planes": [_I, _I] + [_P] * 5 + [_I] * 7 + [_P],
    # dtype, wcam, tw, pts, uv, mask, out, G, Tb, Pc, W, loss, tc, ng, smem,
    # stream
    "wtt_cost": [_I] + [_P] * 6 + [_I] * 8 + [_P],
    # dtype, indexed, rmats, tvecs, fx_fy, cx_cy_skew, dist, inv_w, x_w, points,
    # pt_idx, uv, mask, r, jp, jc, u, g, C, K, P, loss, lanes, stream
    "grid_cam_normal": [_I, _I] + [_P] * 16 + [_I] * 5 + [_P],
    # dtype, n, jp_g, r_g, P, T2, ppb (host arrays of n), lam, v_inv, g, damp,
    # diag_floor, stream
    "grid_point_normal": [_I, _I] + [_P] * 9 + [_D, _P],
    # dtype, indexed, jc, jp, vinv6, v_inv, pt_idx, out, C, K, P, lanes, stream
    "grid_coupling": [_I, _I] + [_P] * 6 + [_I] * 4 + [_P],
    # dtype, np, table, cam_ids, pts, uv, mask, inv_w, jc, jp, v6, gpt, ug,
    # C, Tb, Pb, loss, focal, points, dist, pp, tc, ng, smem, stream
    "tt_cam_normal": [_I, _I] + [_P] * 11 + [_I] * 11 + [_P],
    # dtype, np, cam_ids, mask, jc, jp, vinv, out, C, Tb, Pb, tc, ng, smem,
    # stream
    "tt_coupling": [_I, _I] + [_P] * 6 + [_I] * 6 + [_P],
    # dtype, np, x, cam_ids, mask, jc, jp, out, C, Tb, Pb, tc, ng, smem,
    # stream
    "tt_wt_times": [_I, _I] + [_P] * 6 + [_I] * 6 + [_P],
    # dtype, np, y, cam_ids, mask, jc, jp, out, C, Tb, Pb, tc, ng, smem, tile,
    # stream
    "tt_w_times": [_I, _I] + [_P] * 6 + [_I] * 7 + [_P],
    # dtype, table, cam_ids, pts, uv, mask, inv_w, lane, C, Tb, Pb, loss, tc,
    # ng, smem, stream
    "tt_cost": [_I] + [_P] * 7 + [_I] * 7 + [_P],
    # dtype, wcam, tw, out, G, N, W, stream
    "wtt_cam_planes": [_I] + [_P] * 3 + [_I] * 3 + [_P],
    # dtype, np, wcam, jc, jp, r, vinv, rows, G, Tb, Pc, W, use_sj, want_od,
    # tc, ng, smem, stream
    "wtt_contrib": [_I, _I] + [_P] * 6 + [_I] * 9 + [_P],
    # dtype, np, y, wcam, jc, jp, out, G, Tb, Pc, W, tc, ng, smem, tile, stream
    "wtt_w_rows": [_I, _I] + [_P] * 5 + [_I] * 8 + [_P],
    # dtype, np, onehot_float, xw_t, onehot, jc, jp, vinv, out, G, Tb, Pc, W,
    # tc, ng, smem, vec, stream
    "wtt_coupling_onehot": [_I, _I, _I] + [_P] * 6 + [_I] * 8 + [_P],
    # dtype, rmats, tvecs, fx_fy, cx_cy_skew, dist, points, cam_idx, pt_idx,
    # uv, mask, inv_w, w, u, g_cam, v, g_pt, N, C, P, loss, focal, points_on,
    # stream
    "flat_linearize": [_I] + [_P] * 16 + [_I] * 6 + [_P],
    # dtype, rmats, tvecs, fx_fy, cx_cy_skew, dist, points, cam_idx, pt_idx,
    # uv, mask, inv_w, v_inv, out, N, C, P, loss, focal, points_on, stream
    "flat_coupling": [_I] + [_P] * 13 + [_I] * 6 + [_P],
    # np, block, variant, xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, stream
    "probe_coupling": [_I] * 3 + [_P] * 6 + [_I] * 4 + [_P],
    # layout, packed, out, rows, nbytes, stream
    "probe_bits_expand": [_I] + [_P] * 2 + [_I] * 2 + [_P],
}

_LIB = []  # the loaded library, once per process (sources do not change under it)


SHARED, GLOBAL = "shared", "global"  # memory modes (csrc/slot.cuh)


class LaunchCounter:
    """Launch counts of one kernel wrapper: ``kernel`` grows where the
    wrapper launches its CUDA kernel, ``plain`` where the plain PyTorch
    version runs; ``modes`` splits the launches of a kernel that reduces
    into rows by memory mode."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.kernel = 0
        self.plain = 0
        self.modes = {}

    def launched(self, mode: str) -> None:
        """One launch of the kernel in memory mode ``mode``."""
        self.kernel += 1
        self.modes[mode] = self.modes.get(mode, 0) + 1


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _compile(nv: str, src: Path, obj: Path) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    proc = subprocess.run([nv, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                          capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless a library with the current digest
    exists: one nvcc per source, all started together, then one link,
    inside the span ``build.nvcc`` with one count of ``build.compiles``.
    Returns (library path, compiler output, each source's headed by
    ``nvcc <source>: <seconds> s``; empty when cached)."""
    digest = source_digest()
    out = BUILD_DIR / f"kernels_{digest}.so"
    if out.exists():
        return out, ""
    with span("build.nvcc"):
        count("build.compiles")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nv = nvcc()
        srcs = [p for p in _sources() if p.suffix == ".cu"]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
            with ThreadPoolExecutor(len(srcs)) as pool:
                done = list(pool.map(_compile, [nv] * len(srcs), srcs, objs))
            log = "".join(f"nvcc {src.name}: {secs:.1f} s\n{proc.stdout}{proc.stderr}"
                          for src, (proc, secs) in zip(srcs, done))
            if any(proc.returncode for proc, _ in done):
                raise RuntimeError(f"nvcc failed:\n{log}")
            so = Path(tmp) / "kernels.so"
            link = subprocess.run([nv, "-shared", "-o", str(so), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                                   f"{link.stdout}{link.stderr}")
            os.replace(so, out)  # atomic: a concurrent build never sees half a file
        return out, log + link.stdout + link.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use, then cached: every
    launch goes through here, so the cached path must cost nothing)."""
    if _LIB:
        return _LIB[0]
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise ValueError(f"the CUDA kernels take float32 or float64, not {dtype}")
