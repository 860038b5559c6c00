"""Shape-table painter: the device env's rasterizer, batched over envs.

A shape table [N, S, 8] f32 holds rows `(kind, a, b, c, d, r, g, b)` that
are painted onto a canvas [N, H, W, C] in row order, the last writer
winning:

  kind 0 (rect): hit = (a <= x < b) & (c <= y < d)
  kind 1 (disk): hit = (x - a)^2 + (y - b)^2 <= c

Masked rows are geometry that never hits (an empty rect, a negative squared
radius). `paint_shapes` sends CUDA tensors to the hand-written kernel
(`csrc/paint.cu`, which culls the table per tile before any pixel walks
it) and CPU tensors to `paint_shapes_ref`, the plain version with the same
per-pixel arithmetic; both give bit-identical canvases.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import Tuple

import torch

from cadre_tpu_torch.ops import _build

# The kernel stages an env's whole table (32 B a row) in dynamic shared
# memory beside 32 B of static counters, within the 48 KB a block may use
# without opting in to more.
MAX_ROWS = (48 * 1024 - 32) // 32

launches = 0                       # kernel launches made by `paint_shapes`


def rect_rows(u0, u1, v0, v1, colors, valid) -> torch.Tensor:
    """[..., 8] rect rows; invalid rows become empty rects (u1 = u0)."""
    colors = torch.broadcast_to(colors, u0.shape + (3,))
    u1 = torch.where(valid, u1, u0)
    return torch.stack([torch.zeros_like(u0), u0, u1, v0, v1,
                        colors[..., 0], colors[..., 1], colors[..., 2]],
                       dim=-1)


def disk_rows(cx, cy, r2, colors, valid) -> torch.Tensor:
    """[..., 8] disk rows; invalid rows get a negative squared radius."""
    colors = torch.broadcast_to(colors, cx.shape + (3,))
    r2 = torch.where(valid, r2, torch.full_like(r2, -1.0))
    return torch.stack([torch.ones_like(cx), cx, cy, r2, torch.zeros_like(cx),
                        colors[..., 0], colors[..., 1], colors[..., 2]],
                       dim=-1)


def paint_shapes_ref(base: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
    """Plain version: base [N, H, W, C], shapes [N, S, 8] -> [N, H, W, C]."""
    n, h, w, c = base.shape
    xx = torch.arange(w, dtype=torch.float32, device=base.device)[None, None]
    yy = torch.arange(h, dtype=torch.float32, device=base.device)[None, :, None]
    img = base
    for s in range(shapes.shape[1]):
        row = shapes[:, s, :, None, None]                 # [N, 8, 1, 1]
        rect = (xx >= row[:, 1]) & (xx < row[:, 2]) & \
            (yy >= row[:, 3]) & (yy < row[:, 4])
        disk = (xx - row[:, 1]) ** 2 + (yy - row[:, 2]) ** 2 <= row[:, 3]
        hit = torch.where(row[:, 0] < 0.5, rect, disk)    # [N, H, W]
        col = shapes[:, s, 5:5 + c][:, None, None, :]     # [N, 1, 1, C]
        img = torch.where(hit[..., None], col, img)
    return img


@functools.lru_cache(maxsize=None)
def kernel_tile() -> Tuple[int, int]:
    """(width, height) in pixels of the tile one block of `csrc/paint.cu`
    paints, read from its `kTileW` / `kTileH`."""
    text = (_build.CSRC / "paint.cu").read_text()
    sizes = [re.search(rf"constexpr int {name} = (\d+);", text)
             for name in ("kTileW", "kTileH")]
    if not all(sizes):
        raise RuntimeError("paint.cu: kTileW / kTileH not found")
    return int(sizes[0].group(1)), int(sizes[1].group(1))


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry, loaded and typed once."""
    fn = _build.load("paint").paint_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _paint_cuda(base: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
    global launches
    n, h, w, c = base.shape
    if base.dtype != torch.float32 or shapes.dtype != torch.float32:
        raise TypeError("paint: base and shapes must be float32")
    if shapes.device != base.device:
        raise ValueError("paint: base and shapes on different devices")
    if shapes.dim() != 3 or shapes.shape[0] != n or shapes.shape[2] != 8:
        raise ValueError(f"paint: shapes {tuple(shapes.shape)} for base "
                         f"{tuple(base.shape)}; want [N, S, 8]")
    if not 1 <= c <= 3 or shapes.shape[1] > MAX_ROWS:
        raise ValueError(f"paint: needs 1..3 channels and <= {MAX_ROWS} rows")
    if not (base.is_contiguous() and shapes.is_contiguous()):
        raise ValueError("paint: inputs must be contiguous")
    if shapes.data_ptr() % 16:
        raise ValueError("paint: shapes must be 16-byte aligned")
    out = torch.empty_like(base)
    if n == 0 or shapes.shape[1] == 0:
        out.copy_(base)
        return out
    stream = _build.cuda_stream(base)
    _build.check(_entry()(base.data_ptr(), shapes.data_ptr(), out.data_ptr(),
                          n, h, w, c, shapes.shape[1], stream), "paint")
    launches += 1
    return out


def paint_shapes(base: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
    """Paint `shapes` [N, S, 8] onto `base` [N, H, W, C] in row order:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if base.is_cuda:
        return _paint_cuda(base, shapes)
    return paint_shapes_ref(base, shapes)
