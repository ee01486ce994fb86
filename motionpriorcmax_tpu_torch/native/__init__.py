"""ctypes bindings of the port's native host event ops (`event_ops.cc`,
the port's own copy of the JAX package's; JAX: native/__init__.py).

The library is built on first use with the host C++ compiler ($CXX, else
g++):

    g++ -O3 -march=native -shared -fPIC -o <lib> event_ops.cc

into `motionpriorcmax_tpu_torch/_build/` (listed in .gitignore), named by a
hash of the source, the flags and the host CPU's feature flags (the build is
for this CPU), so an edited source or another host is rebuilt.  Nothing is
built at import.  Without a compiler `available()` is False and the
callers in `data/` run their NumPy twins; `build_error()` says why.

`calls` counts the calls of each native function, so a caller can tell
that the native path ran; `numpy_only()` turns the native path off, in
every thread, for its `with` block (the tests and `chip_smoke.py` time and
compare both).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("event_ops.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

calls: Counter = Counter()
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_numpy_only = False


def _cpu_flags() -> str:
    """The host CPU's feature flags (-march=native builds for them)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def build() -> Path:
    """Compile event_ops.cc (if not built yet) -> the library's path."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler: set CXX or install g++")
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _cpu_flags().encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libevent_ops-{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A temporary name, then a rename: a concurrent build of the same
    # source never loads a half-written library.
    fd, tmp = tempfile.mkstemp(prefix=".libevent_ops-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(_SRC), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    c_i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.lower_bound_i64.restype = c_i64
    lib.lower_bound_i64.argtypes = [i64p, c_i64, c_i64]
    lib.voxelize_trilinear.restype = None
    lib.voxelize_trilinear.argtypes = [f32p, f32p, f32p, f32p, c_i64, c_i64,
                                       c_i64, c_i64, f32p]
    lib.voxelize_temporal.restype = None
    lib.voxelize_temporal.argtypes = [i32p, i32p, f32p, f32p, c_i64, c_i64,
                                      c_i64, c_i64, f32p]
    lib.pack_dsec_events.restype = c_i64
    lib.pack_dsec_events.argtypes = [u16p, u16p, i64p, u8p, c_i64, f32p,
                                     c_i64, c_i64, c_i64, f32p]
    lib.lut_cell_sort_segment.restype = None
    lib.lut_cell_sort_segment.argtypes = [f32p, c_i64, c_i64, c_i64, c_i64,
                                          ctypes.c_float, f32p, i32p, i32p,
                                          i32p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                _error = str(exc)
    return _lib


def available() -> bool:
    """True when the library is built and loaded and not turned off by
    `numpy_only()`."""
    return not _numpy_only and _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    _load()
    return _error


@contextlib.contextmanager
def numpy_only():
    """The callers in data/ take their NumPy twins inside the block."""
    global _numpy_only
    prev, _numpy_only = _numpy_only, True
    try:
        yield
    finally:
        _numpy_only = prev


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native event ops unavailable: {_error}")
    return lib


def lower_bound(t: np.ndarray, value: int) -> int:
    """First index i with t[i] >= value (np.searchsorted side='left')."""
    lib = _lib_or_raise()
    t = np.ascontiguousarray(t, np.int64)
    calls["lower_bound"] += 1
    return int(lib.lower_bound_i64(t, len(t), int(value)))


def voxelize_trilinear(x, y, t_norm, p, num_bins: int, height: int,
                       width: int) -> np.ndarray:
    """Fractional-coordinate 8-corner vote, f32 sums -> [num_bins, H, W]."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    t_norm = np.ascontiguousarray(t_norm, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    grid = np.zeros(num_bins * height * width, np.float32)
    calls["voxelize_trilinear"] += 1
    lib.voxelize_trilinear(x, y, t_norm, p, len(x), num_bins, height, width,
                           grid)
    return grid.reshape(num_bins, height, width)


def voxelize_temporal(x, y, t_norm, p, num_bins: int, height: int,
                      width: int) -> np.ndarray:
    """Integer-coordinate two-tap time vote, f32 sums -> [num_bins, H, W]."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.int32)
    y = np.ascontiguousarray(y, np.int32)
    t_norm = np.ascontiguousarray(t_norm, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    grid = np.zeros(num_bins * height * width, np.float32)
    calls["voxelize_temporal"] += 1
    lib.voxelize_temporal(x, y, t_norm, p, len(x), num_bins, height, width,
                          grid)
    return grid.reshape(num_bins, height, width)


def lut_cell_sort_segment(events: np.ndarray, hq: int, wq: int,
                          num_bins: int, superpixel: float):
    """Stable counting sort of [m, 6] event rows by y-major LUT cell ->
    (sorted events [m, 6] f32, run ends [hq * num_bins * wq] int32)."""
    lib = _lib_or_raise()
    events = np.ascontiguousarray(events, np.float32)
    m = len(events)
    cells = hq * num_bins * wq
    out = np.empty_like(events)
    ends = np.empty(cells, np.int32)
    counts = np.zeros(cells, np.int32)
    keys = np.empty(max(m, 1), np.int32)
    calls["lut_cell_sort_segment"] += 1
    lib.lut_cell_sort_segment(events.reshape(-1), m, hq, wq, num_bins,
                              float(superpixel), out.reshape(-1), ends,
                              counts, keys)
    return out, ends


def pack_dsec_events(x, y, t, p, rectify_map: np.ndarray, height: int,
                     width: int, num_bins: int) -> np.ndarray:
    """Rectify, normalize t to [0, 1], bin, drop out-of-image events and
    pack (y, x, t, p, bin) rows -> [M, 5] f32 (times sorted)."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.uint16)
    y = np.ascontiguousarray(y, np.uint16)
    t = np.ascontiguousarray(t, np.int64)
    p = np.ascontiguousarray(p, np.uint8)
    rect = np.ascontiguousarray(rectify_map, np.float32)
    out = np.empty((len(x), 5), np.float32)
    calls["pack_dsec_events"] += 1
    m = lib.pack_dsec_events(x, y, t, p, len(x), rect.reshape(-1), height,
                             width, num_bins, out.reshape(-1))
    return out[:m]
