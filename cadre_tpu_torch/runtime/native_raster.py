"""ctypes binding of the native route-ribbon rasterizer (runtime/raster.cpp).

The library is built with g++ into `build/host/` at first use
(runtime/native.py). It gives numpy's `route_fig.rasterize_polyline_numpy`
bit for bit; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes

import numpy as np

from cadre_tpu_torch.runtime import native


def _lib() -> ctypes.CDLL:
    lib = native.load("raster")
    lib.raster_polyline.restype = None
    lib.raster_polyline.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def rasterize_polyline_native(points_px: np.ndarray, height: int,
                              width: int, line_width: float) -> np.ndarray:
    """uint8 {0, 255} [height, width]: every pixel of the disks of
    `line_width` stamped along the polyline `points_px` ([N, 2] x, y)."""
    pts = np.ascontiguousarray(points_px, np.float64).reshape(-1, 2)
    out = np.empty(height * width, np.uint8)
    _lib().raster_polyline(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts),
        height, width, float(line_width),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape(height, width)
