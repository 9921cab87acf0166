"""ctypes binding to the native quad-proposal library (native/quadfind.cpp).

Port of orb_slam2_aruco_tpu/ops/aruco/native.py: a host-side contour quad
proposer beside the detector's device path, which stays the default. At
first use it loads the committed `native/libquadfind.so`; when that file is
missing it builds `native/quadfind.cpp` with native/build.sh's compiler
line into the port's build directory (kernels/build.py's
build_host_library; never into `native/`) and loads that. When the build
fails `available()` is False and `find_quads_native` raises with the
compiler's error.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from orb_slam2_aruco_tpu_torch.kernels import build

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libquadfind.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "quadfind.cpp")
_BUILD_DIR = build.BUILD_DIR


@lru_cache(maxsize=1)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library, or None and why: the compiler's or the loader's
    error)."""
    path = _LIB_PATH
    try:
        if not os.path.exists(path):
            path = build.build_host_library(_SRC_PATH, _BUILD_DIR)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError) as e:
        return None, str(e)
    lib.quadfind.restype = ctypes.c_int
    lib.quadfind.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.adaptive_threshold_u8.restype = None
    lib.adaptive_threshold_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def find_quads_native(
    img: np.ndarray,
    adaptive_win: int = 15,
    adaptive_c: float = 7.0,
    min_perimeter: int = 40,
    max_perimeter: int = 4000,
    approx_eps_frac: float = 0.05,
    min_area: float = 100.0,
    max_quads: int = 64,
) -> np.ndarray:
    """[H, W] float32 grayscale -> [K, 4, 2] float32 quad corners
    (K <= max_quads)."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native quadfind library unavailable: {why}")
    img = np.ascontiguousarray(img, dtype=np.float32)
    h, w = img.shape
    binary = np.empty((h, w), dtype=np.uint8)
    lib.adaptive_threshold_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h,
        adaptive_win, adaptive_c,
        binary.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    out = np.zeros((max_quads, 8), dtype=np.float32)
    n = lib.quadfind(
        binary.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        min_perimeter, max_perimeter, approx_eps_frac, min_area,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_quads)
    return out[:n].reshape(n, 4, 2)
