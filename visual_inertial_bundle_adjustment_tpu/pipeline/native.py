"""ctypes bindings for the native C++ CSV parsers (native/fastcsv.cpp).

Compiled on first use with g++ -O3 (cached in native/build/); every entry
point falls back to numpy parsing if the toolchain or library is
unavailable, so the framework stays pure-Python-capable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "fastcsv.cpp"
_BUILD = _REPO / "native" / "build"
_LIB = _BUILD / "libfastcsv.so"

_lib = None
_tried = False


def _get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _BUILD.mkdir(parents=True, exist_ok=True)
            # build under a private name and rename into place: concurrent
            # first uses (test workers) never load a half-written library
            tmp = _BUILD / f"libfastcsv.{os.getpid()}.so"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(str(_LIB))
        lib.imu_csv_count.restype = ctypes.c_long
        lib.imu_csv_count.argtypes = [ctypes.c_char_p]
        lib.imu_csv_parse.restype = ctypes.c_int
        lib.imu_csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.obs_csv_count.restype = ctypes.c_long
        lib.obs_csv_count.argtypes = [ctypes.c_char_p]
        lib.obs_csv_parse.restype = ctypes.c_int
        lib.obs_csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.num_csv_count.restype = ctypes.c_long
        lib.num_csv_count.argtypes = [ctypes.c_char_p]
        lib.num_csv_parse.restype = ctypes.c_int
        lib.num_csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    except Exception:  # noqa: BLE001 — toolchain missing: numpy fallback
        _lib = None
    return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def parse_imu_csv(path):
    """(times_ns int64 (N,), gyro (N,3), accel (N,3)) or None on fallback."""
    lib = _get_lib()
    if lib is None:
        return None
    b = str(path).encode()
    n = lib.imu_csv_count(b)
    if n < 0:
        return None
    t = np.empty(n, np.int64)
    g = np.empty((n, 3), np.float64)
    a = np.empty((n, 3), np.float64)
    if lib.imu_csv_parse(b, n, _ptr(t, ctypes.c_longlong), _ptr(g, ctypes.c_double),
                         _ptr(a, ctypes.c_double)) != 0:
        return None
    return t, g, a


def parse_obs_csv(path):
    """(point_id, ts_ns, cam, uv (N,2), sqrt_h (N,2,2)) or None on fallback."""
    lib = _get_lib()
    if lib is None:
        return None
    b = str(path).encode()
    n = lib.obs_csv_count(b)
    if n < 0:
        return None
    pid = np.empty(n, np.int64)
    ts = np.empty(n, np.int64)
    cam = np.empty(n, np.int32)
    uv = np.empty((n, 2), np.float64)
    sh = np.empty((n, 4), np.float64)
    if lib.obs_csv_parse(b, n, _ptr(pid, ctypes.c_longlong), _ptr(ts, ctypes.c_longlong),
                         _ptr(cam, ctypes.c_int), _ptr(uv, ctypes.c_double),
                         _ptr(sh, ctypes.c_double)) != 0:
        return None
    return pid, ts, cam, uv, sh.reshape(-1, 2, 2)


def parse_numeric_csv(path, n_cols):
    """Row-major float matrix of the first n_cols columns, or None."""
    lib = _get_lib()
    if lib is None:
        return None
    b = str(path).encode()
    n = lib.num_csv_count(b)
    if n < 0:
        return None
    out = np.empty((n, n_cols), np.float64)
    if lib.num_csv_parse(b, n, n_cols, _ptr(out, ctypes.c_double)) != 0:
        return None
    return out
