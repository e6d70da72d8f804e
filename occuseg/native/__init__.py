"""ctypes bindings for the C++ host runtime (csrc/native.cpp).

Builds lazily via make on first use. Every entry point returns None when
the library cannot be built (the caller then takes its NumPy or in-jit
path); the failure is reported once as a warning with the compiler's
output. Entry points that must not run without it (`bench.py`,
`chip_smoke.py`) check `have_native()` and stop.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_LIB_PATH = os.path.abspath(os.path.join(_CSRC, "libocc_native.so"))
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        # make is a no-op when the .so is newer than native.cpp; running it
        # unconditionally picks up source changes (a stale .so missing a
        # newly added symbol would otherwise disable the whole native path)
        subprocess.run(["make", "-s"], cwd=os.path.abspath(_CSRC),
                       check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.segment_supervoxels.restype = ctypes.c_int32
        lib.segment_supervoxels.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.voxelize_points.restype = ctypes.c_int32
        lib.voxelize_points.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.plan_voxelize.restype = ctypes.c_int32
        lib.plan_voxelize.argtypes = [i32p, ctypes.c_int32, ctypes.c_int32,
                                      i64p, i32p, i32p]
        lib.plan_neighbor_map.restype = None
        lib.plan_neighbor_map.argtypes = [i64p, i32p, ctypes.c_int32,
                                          ctypes.c_int32, i32p,
                                          ctypes.c_int32, i32p]
        lib.plan_neighbor_map_derived.restype = ctypes.c_int32
        lib.plan_neighbor_map_derived.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
            i32p, i32p, i32p, ctypes.c_int32, i32p]
        lib.plan_downsample.restype = ctypes.c_int32
        lib.plan_downsample.argtypes = [i64p, i32p, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32,
                                        i64p, i32p, i32p, i32p]
        lib.gather_rows.restype = None
        lib.gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_char_p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(f"C++ host library unavailable ({e}): "
                      f"{detail.decode(errors='replace')[-2000:]}")
        _lib = None
    return _lib


def have_native() -> bool:
    return _load() is not None


def segment_supervoxels_native(points: np.ndarray, feat: np.ndarray,
                               cell: float, k_thresh: float,
                               min_size: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    ft = np.ascontiguousarray(feat, np.float32)
    n = pts.shape[0]
    out = np.empty(n, np.int32)
    lib.segment_supervoxels(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ft.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ft.shape[1], cell, k_thresh, min_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def voxelize_points_native(coords: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(coords, np.int32)
    out = np.empty(c.shape[0], np.int32)
    lib.voxelize_points(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), c.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def gather_rows_native(src: np.ndarray, perm: np.ndarray,
                       fill) -> Optional[np.ndarray]:
    """out[i] = src[perm[i]] (fill where perm[i] < 0) via the prefetched
    C++ row gather (csrc/native.cpp::gather_rows) — the loader's
    apply_point_layout hot path. Returns None when the library is
    unavailable (caller uses NumPy fancy indexing)."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    perm = np.ascontiguousarray(perm, np.int64)
    n = perm.shape[0]
    out = np.empty((n,) + src.shape[1:], src.dtype)
    row_bytes = src.dtype.itemsize
    for d in src.shape[1:]:
        row_bytes *= d
    fill_row = np.full(src.shape[1:], fill, src.dtype).tobytes()
    lib.gather_rows(src.ctypes.data_as(ctypes.c_void_p),
                    out.ctypes.data_as(ctypes.c_void_p),
                    perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    n, row_bytes, fill_row)
    return out


_malloc_retained = False


def retain_malloc() -> None:
    """Keep large freed blocks on the process heap (glibc mallopt).

    The planner allocates ~150 MB of plan arrays per batch; glibc
    serves blocks >128 KB with mmap and returns them to the OS on free, so
    every batch re-pays first-touch page faults for the same memory
    (~60 ms/batch measured on the bench scene). Raising M_MMAP_THRESHOLD
    and M_TRIM_THRESHOLD keeps the pages resident across batches. Call
    once from long-lived loader/trainer processes (the prefetchers do);
    no-op if glibc is unavailable."""
    global _malloc_retained
    if _malloc_retained:
        return
    _malloc_retained = True
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass
