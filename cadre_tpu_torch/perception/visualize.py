"""Reconstruction and segmentation grids of the perception trainer's eval
pass (the counterpart of cadre_tpu.perception.visualize): per sample the
strip [input rgb | seg prediction | seg target | route prediction],
written as `<out_dir>/recon_epoch<N>/sample_<i>.png`.

The PNGs are 8-bit RGB, every row with filter 0, one zlib stream, written
and read with the standard library's zlib and struct alone (`write_png`,
`read_png`), so nothing beyond numpy is needed to dump or check them.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

import numpy as np

# CARLA 0.9.10's reduced 8 classes: unlabeled, road, car, person,
# building/wall, fence/pole/sign, vegetation/terrain, road line
SEG_PALETTE = np.array([
    [0, 0, 0],
    [128, 64, 128],
    [0, 0, 142],
    [220, 20, 60],
    [70, 70, 70],
    [153, 153, 153],
    [107, 142, 35],
    [157, 234, 50],
], dtype=np.uint8)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def colorize_seg(seg: np.ndarray) -> np.ndarray:
    """[H, W] class map -> [H, W, 3] uint8."""
    return SEG_PALETTE[np.clip(seg, 0, len(SEG_PALETTE) - 1)]


def visualization_grid(batch: Dict[str, np.ndarray],
                       outputs: Dict[str, np.ndarray],
                       index: int = 0) -> np.ndarray:
    """One sample's strip [H, W * panels, 3] uint8 from numpy arrays: the
    batch's `x` (NHWC, rgb in [0, 1] first) and `camera_seg`, the model's
    `camera` logits (argmax) and `route` map where they exist."""
    rgb = (np.asarray(batch["x"])[index, :, :, :3] * 255).astype(np.uint8)
    panels = [rgb]
    if "camera" in outputs:
        pred = np.argmax(np.asarray(outputs["camera"])[index], axis=-1)
        panels.append(colorize_seg(pred))
    if "camera_seg" in batch:
        panels.append(colorize_seg(np.asarray(batch["camera_seg"])[index]))
    if "route" in outputs:
        route = np.asarray(outputs["route"])[index, :, :, 0] * 255
        panels.append(np.repeat(route.astype(np.uint8)[..., None], 3, -1))
    return np.concatenate(panels, axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, not {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The [H, W, 3] uint8 image of a PNG that `write_png` wrote (8-bit
    RGB, filter 0 on every row); raises on any other PNG."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG ({header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def dump_visualizations(batch, outputs, out_dir: str, epoch: int,
                        max_samples: int = 4,
                        prefix: str = "recon") -> str:
    """Write `<prefix>_epoch<N>/sample_<i>.png` for the first samples of
    a batch of numpy arrays; returns the directory."""
    d = os.path.join(out_dir, f"{prefix}_epoch{epoch}")
    os.makedirs(d, exist_ok=True)
    n = min(max_samples, np.asarray(batch["x"]).shape[0])
    for i in range(n):
        write_png(os.path.join(d, f"sample_{i}.png"),
                  visualization_grid(batch, outputs, i))
    return d
