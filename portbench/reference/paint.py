"""The device env's rasterizer (K1) as its stated semantics: a shape table
[N, S, 8] of rows (kind, a, b, c, d, r, g, b) painted onto a canvas
[N, H, W, C] in row order, the last row that covers a pixel giving its
colour. Pixel (x, y) is column x, row y, as float32 numbers.

  kind 0: covered where a <= x < b and c <= y < d
  kind 1: covered where (x - a)^2 + (y - b)^2 <= c, in float32

Rows are walked from the last: a pixel keeps the first colour found, so
each pixel is written once."""
from __future__ import annotations

import torch


def paint(base: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    n, h, w, c = base.shape
    x = torch.arange(w, device=base.device, dtype=torch.float32).view(1, 1, w)
    y = torch.arange(h, device=base.device, dtype=torch.float32).view(1, h, 1)
    out = base.clone()
    free = torch.ones((n, h, w), dtype=torch.bool, device=base.device)
    for s in reversed(range(table.shape[1])):
        kind, a, b, cc, d = (table[:, s, i].view(n, 1, 1) for i in range(5))
        dx, dy = x - a, y - b
        covered = torch.where(
            kind == 0,
            (x >= a) & (x < b) & (y >= cc) & (y < d),
            dx * dx + dy * dy <= cc)
        write = covered & free
        out = torch.where(write[..., None],
                          table[:, s, 5:5 + c].view(n, 1, 1, c), out)
        free &= ~covered
    return out
