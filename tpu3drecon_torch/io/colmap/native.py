"""ctypes bridge to the C++ COLMAP parser and BAL tokenizer
(``tpu3drecon_torch/native/colmap_io.cpp``).

Counterpart of ``tpu3drecon/io/colmap/native.py``.  The shared library is
compiled from the port's own copy of the source with ``g++`` (the flags of
the JAX package's Makefile) into ``tpu3drecon_torch/_build/``, under a name
keyed by a hash of the source, the flags and the host (``-march=native``
code is not moved between machines); the build writes a temporary file and
renames it into place, so concurrent builds never load half a file.
Nothing builds at import time.

Every entry point returns the same packed CSR records as the numpy reader
in ``binary.py``, its correctness oracle.  Where the toolchain or the
build is unavailable ``load_library`` returns None and callers use the
numpy path, as in JAX; ``COUNTS`` records which reader parsed each file,
so a caller can tell that the native reader ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from tpu3drecon_torch.io.colmap.records import ColmapImages, ColmapPoints

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "native" / "colmap_io.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_u64p = ctypes.POINTER(ctypes.c_uint64)


class ReaderCounts:
    """Files parsed per reader: ``native[kind]`` and ``numpy[kind]``, kind
    one of ``images``, ``points3d``, ``bal``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.native = {}
        self.numpy = {}

    def count(self, reader: str, kind: str) -> None:
        counts = getattr(self, reader)
        counts[kind] = counts.get(kind, 0) + 1


COUNTS = ReaderCounts()


def library_path() -> Path:
    """Where the library for the current source, flags and host lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    uname = os.uname()
    h.update(f"{uname.machine} {uname.nodename}".encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcolmap_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser unless the library for this source exists;
    raises ``RuntimeError`` when ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native parser; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _load_failed = True
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)

        lib.colmap_scan_points3d.argtypes = [u8p, ctypes.c_uint64, _u64p, _u64p]
        lib.colmap_scan_points3d.restype = ctypes.c_int
        lib.colmap_parse_points3d.argtypes = [
            u8p, ctypes.c_uint64, i64p, f64p, u8p, f64p, i64p, i32p, i32p,
        ]
        lib.colmap_parse_points3d.restype = ctypes.c_int
        lib.colmap_scan_images.argtypes = [u8p, ctypes.c_uint64, _u64p, _u64p, _u64p]
        lib.colmap_scan_images.restype = ctypes.c_int
        lib.colmap_parse_images.argtypes = [
            u8p, ctypes.c_uint64, i32p, f64p, f64p, i32p, u8p, i64p, i64p, f64p, i64p,
        ]
        lib.colmap_parse_images.restype = ctypes.c_int
        lib.bal_parse_doubles.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, f64p, ctypes.c_uint64, _u64p,
        ]
        lib.bal_parse_doubles.restype = ctypes.c_int
        _lib = lib
        return _lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_points3d_bin_native(path: str) -> Optional[ColmapPoints]:
    lib = load_library()
    if lib is None:
        return None
    buf = np.fromfile(path, dtype=np.uint8)
    n = ctypes.c_uint64()
    total_track = ctypes.c_uint64()
    if lib.colmap_scan_points3d(_as_u8p(buf), buf.size, ctypes.byref(n), ctypes.byref(total_track)):
        raise ValueError(f"corrupt points3D.bin: {path}")
    num, tt = n.value, total_track.value
    ids = np.empty(num, np.int64)
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    error = np.empty(num, np.float64)
    track_offsets = np.empty(num + 1, np.int64)
    track_image_ids = np.empty(tt, np.int32)
    track_p2d_idxs = np.empty(tt, np.int32)
    rc = lib.colmap_parse_points3d(
        _as_u8p(buf), buf.size,
        _ptr(ids, ctypes.c_int64), _ptr(xyz, ctypes.c_double),
        _as_u8p(rgb), _ptr(error, ctypes.c_double),
        _ptr(track_offsets, ctypes.c_int64),
        _ptr(track_image_ids, ctypes.c_int32),
        _ptr(track_p2d_idxs, ctypes.c_int32),
    )
    if rc:
        raise ValueError(f"corrupt points3D.bin (code {rc}): {path}")
    COUNTS.count("native", "points3d")
    return ColmapPoints(
        ids=ids, xyz=xyz, rgb=rgb, error=error,
        track_offsets=track_offsets,
        track_image_ids=track_image_ids,
        track_p2d_idxs=track_p2d_idxs,
    )


def read_images_bin_native(path: str) -> Optional[ColmapImages]:
    lib = load_library()
    if lib is None:
        return None
    buf = np.fromfile(path, dtype=np.uint8)
    n = ctypes.c_uint64()
    total_p2d = ctypes.c_uint64()
    total_names = ctypes.c_uint64()
    if lib.colmap_scan_images(
        _as_u8p(buf), buf.size, ctypes.byref(n), ctypes.byref(total_p2d), ctypes.byref(total_names)
    ):
        raise ValueError(f"corrupt images.bin: {path}")
    num, tp, tn = n.value, total_p2d.value, total_names.value
    image_ids = np.empty(num, np.int32)
    qvecs = np.empty((num, 4), np.float64)
    tvecs = np.empty((num, 3), np.float64)
    camera_ids = np.empty(num, np.int32)
    name_bytes = np.empty(tn, np.uint8)
    name_offsets = np.empty(num + 1, np.int64)
    p2d_offsets = np.empty(num + 1, np.int64)
    p2d_xy = np.empty((tp, 2), np.float64)
    p2d_ids = np.empty(tp, np.int64)
    rc = lib.colmap_parse_images(
        _as_u8p(buf), buf.size,
        _ptr(image_ids, ctypes.c_int32), _ptr(qvecs, ctypes.c_double),
        _ptr(tvecs, ctypes.c_double), _ptr(camera_ids, ctypes.c_int32),
        _as_u8p(name_bytes), _ptr(name_offsets, ctypes.c_int64),
        _ptr(p2d_offsets, ctypes.c_int64), _ptr(p2d_xy, ctypes.c_double),
        _ptr(p2d_ids, ctypes.c_int64),
    )
    if rc:
        raise ValueError(f"corrupt images.bin (code {rc}): {path}")
    raw = name_bytes.tobytes()
    names = [
        raw[name_offsets[i]:name_offsets[i + 1]].decode("utf-8")
        for i in range(num)
    ]
    COUNTS.count("native", "images")
    return ColmapImages(
        image_ids=image_ids, qvecs=qvecs, tvecs=tvecs, camera_ids=camera_ids,
        names=names, p2d_offsets=p2d_offsets, p2d_xy=p2d_xy,
        p2d_point3d_ids=p2d_ids,
    )


def parse_bal_tokens(data: bytes, n_expected: int) -> Optional[np.ndarray]:
    """Parse whitespace-delimited doubles with the C++ tokenizer.

    Returns None when the native library is unavailable (callers fall back
    to Python tokenization); raises ValueError on truncated/garbage input.
    """
    lib = load_library()
    if lib is None:
        return None
    out = np.empty(n_expected, np.float64)
    n_parsed = ctypes.c_uint64(0)
    rc = lib.bal_parse_doubles(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_expected, ctypes.byref(n_parsed),
    )
    if rc == 3:
        raise ValueError(
            f"corrupt BAL file: bad token after {int(n_parsed.value)} values"
        )
    if rc != 0:
        raise ValueError(
            f"corrupt BAL file: expected {n_expected} values, found {int(n_parsed.value)}"
        )
    COUNTS.count("native", "bal")
    return out
