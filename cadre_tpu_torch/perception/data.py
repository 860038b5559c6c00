"""Perception data: recording expert frames into .npz shards
(`collect_dataset`), class-weight statistics and epoch-shuffled batching
(the port's copy of cadre_tpu.perception.data).

Shard fields (FIELDS): camera_rgb [N, 144, 256, 3] u8, camera_seg
[N, 144, 256] class ids 0-7, route_fig [N, 256, 144] raster {0, 255},
and per frame speed, target_speed, steer, throttle, command, light_state,
light_dist, dis, theta.

The loader draws from `np.random.RandomState(seed)` exactly as the JAX
package's does (shard order, frame order, balanced repeats, host
augmentation), so the same seed gives equal batches. `unpack_batch` and
`blank_route_plane` work on tensors, on the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

FIELDS = ("camera_rgb", "camera_seg", "route_fig", "speed", "target_speed",
          "steer", "throttle", "command", "light_state", "light_dist",
          "dis", "theta")
# the planes of the loader's model input x: rgb and the route raster
LOADER_PLANES = 4


def collect_dataset(env, expert, n_frames: int, out_dir: str,
                    shard_size: int = 512,
                    max_stuck_record: int = 25,
                    max_stuck_reset: int = 100) -> List[str]:
    """Drive `expert` in `env` (a SimDrivingEnv) and record `n_frames`
    frames into `shard_<k>.npz` files of `shard_size` frames (FIELDS, in
    order) under `out_dir`; returns their paths.

    Stuck guard: once the car has stood (speed < 0.3) for more than
    `max_stuck_record` ticks, frames are no longer recorded, unless it
    waits at a red or yellow light under 25 m ahead (the rarest light
    classes, bounded by the light cycle); after `max_stuck_reset` ticks
    the env is reset. It draws nothing itself: the env's own generator,
    seeded where the env is made, drives every random choice."""
    os.makedirs(out_dir, exist_ok=True)
    buf: Dict[str, List[Any]] = {k: [] for k in FIELDS}
    shards: List[str] = []
    tick = env.reset()
    frames = 0
    stuck = 0
    while frames < n_frames:
        control = expert.act(env, tick)
        at_light = int(tick.get("light_state", 0)) in (2, 3) \
            and 0.0 < float(tick.get("light_dist", -1.0)) < 25.0
        if float(tick.get("speed", 0.0)) < 0.3:
            stuck += 1
            if stuck >= max_stuck_reset:
                stuck = 0
                tick = env.reset()
                continue
            if stuck > max_stuck_record and not at_light:
                tick, _, done, _ = env.step(control)
                if done:
                    stuck = 0
                    tick = env.reset()
                continue
        else:
            stuck = 0
        rgb, seg = env._render_rgb(with_seg=True)
        buf["camera_rgb"].append(rgb)
        buf["camera_seg"].append(seg)
        # the tick's histories are ring views: copy what outlives the step
        buf["route_fig"].append(np.array(
            tick["route_fig"][-1] if "route_fig" in tick
            else tick["last_route_fig"]))
        buf["speed"].append(tick.get("speed", 0.0))
        buf["target_speed"].append(7.0)
        buf["steer"].append(control[0])
        buf["throttle"].append(control[1])
        buf["command"].append(tick.get("command", 3))
        buf["light_state"].append(tick.get("light_state", 0))
        buf["light_dist"].append(tick.get("light_dist", -1.0))
        # the route geometry of the measurements [speed, dis, theta]
        meas = (tick["last_measurements"] if "last_measurements" in tick
                else tick["measurements"][-1] if "measurements" in tick
                else (0.0, 0.0, 0.0))
        buf["dis"].append(float(meas[1]))
        buf["theta"].append(float(meas[2]))
        frames += 1

        tick, _, done, _ = env.step(control)
        if done:
            tick = env.reset()
        if len(buf["camera_rgb"]) >= shard_size or frames == n_frames:
            path = os.path.join(out_dir, f"shard_{len(shards):05d}.npz")
            np.savez_compressed(
                path, **{k: np.asarray(v) for k, v in buf.items()})
            shards.append(path)
            buf = {k: [] for k in FIELDS}
    return shards


@dataclasses.dataclass
class DatasetStats:
    """Inverse-frequency class weights, each scaled to a maximum of 1."""

    seg_class_weight: np.ndarray
    light_class_weight: np.ndarray
    command_class_weight: np.ndarray
    num_frames: int


def compute_stats(shards: Sequence[str], num_seg_classes: int = 8,
                  num_light_classes: int = 4, num_commands: int = 4
                  ) -> DatasetStats:
    seg_counts = np.zeros(num_seg_classes)
    light_counts = np.zeros(num_light_classes)
    cmd_counts = np.zeros(num_commands)
    n = 0
    for path in shards:
        with np.load(path) as z:
            seg_counts += np.bincount(z["camera_seg"].ravel(),
                                      minlength=num_seg_classes)
            light_counts += np.bincount(z["light_state"].astype(np.int64),
                                        minlength=num_light_classes)
            cmd_counts += np.bincount(z["command"].astype(np.int64),
                                      minlength=num_commands)
            n += len(z["speed"])

    def inv_freq(c):
        total = c.sum()
        w = np.where(c > 0, total / np.maximum(c, 1), 0.0)
        return (w / max(w.max(), 1e-9)).astype(np.float32)

    return DatasetStats(inv_freq(seg_counts), inv_freq(light_counts),
                        inv_freq(cmd_counts), n)


def _augment(rgb: np.ndarray, rng: np.random.RandomState,
             noise_std: float = 4.0, dropout_p: float = 0.05) -> np.ndarray:
    """Gaussian noise and coarse pixel dropout on uint8 frames."""
    out = rgb.astype(np.float32)
    out = out + rng.randn(*out.shape).astype(np.float32) * noise_std
    mask = rng.rand(*out.shape[:3], 1) > dropout_p
    out = out * mask
    return np.clip(out, 0, 255).astype(np.uint8)


def unpack_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Expand a packed batch (rgb_u8 [B, H, W, 3], route_u8 [B, W, H],
    camera_seg u8) on its device: camera_rgb = rgb / 255, route_fig the
    raster divided by its per-frame max, transposed to [B, H, W, 1], and
    x = camera_rgb ++ route_fig. An unpacked batch is returned as it is."""
    if "rgb_u8" not in batch:
        return batch
    rgb = batch["rgb_u8"].float() / 255.0
    route_raw = batch["route_u8"].float()
    m = route_raw.amax(dim=(1, 2), keepdim=True)
    route = torch.where(m > 0, route_raw / torch.clamp(m, min=1e-6),
                        route_raw)
    route = route.transpose(1, 2)[..., None]
    out = {k: v for k, v in batch.items() if k not in ("rgb_u8", "route_u8")}
    out["camera_rgb"] = rgb
    out["route_fig"] = route
    out["x"] = torch.cat([rgb, route], dim=-1)
    out["camera_seg"] = batch["camera_seg"].long()
    return out


def blank_route_plane(x: torch.Tensor) -> torch.Tensor:
    """Zero every input plane after the leading rgb 3 (the route raster),
    keeping the channel: the camera-route protocol, where route geometry
    reaches the encoder only through the camera."""
    return torch.cat([x[..., :3], torch.zeros_like(x[..., 3:])], dim=-1)


class PerceptionDataLoader:
    """Epoch-shuffled host batching over .npz shards -> numpy dicts.

    Yields x [B, H, W, 4] f32 (rgb / 255 ++ the max-normalised route
    raster), camera_rgb, camera_seg [B, H, W] i32, route_fig
    [B, H, W, 1], speed [B, 1], steer / throttle / target_speed /
    light_dist / dis / theta [B] f32, command / light_state [B] i32.
    `packed=True` yields the uint8 wire format instead (rgb_u8, route_u8,
    camera_seg u8 and the f32 / i32 labels) for `unpack_batch` on the
    device. `root_dir` is a shard directory or a list of shard paths.
    """

    def __init__(self, root_dir, batch_size: int = 48, seed: int = 0,
                 augment: bool = False, drop_last: bool = True,
                 cache_in_memory: bool = False, packed: bool = False,
                 balance: bool = False):
        if isinstance(root_dir, (list, tuple)):
            self.paths = list(root_dir)
        else:
            self.paths = sorted(glob.glob(os.path.join(root_dir, "*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no .npz shards under {root_dir}")
        self.batch_size = batch_size
        self.augment = augment
        self.drop_last = drop_last
        self.packed = packed
        self.balance = balance
        self._cache: Optional[Dict[str, Dict[str, np.ndarray]]] = (
            {} if cache_in_memory else None)
        self._rng = np.random.RandomState(seed)
        self._sizes = []
        for p in self.paths:
            with np.load(p) as z:
                self._sizes.append(len(z["speed"]))
        self.num_frames = int(sum(self._sizes))

    def __len__(self) -> int:
        return self.num_frames // self.batch_size

    @staticmethod
    def _geom(z, idx) -> Dict[str, np.ndarray]:
        """dis / theta labels; zeros for shards recorded without them."""
        return {k: (z[k][idx].astype(np.float32) if k in z
                    else np.zeros(len(idx), np.float32))
                for k in ("dis", "theta")}

    def _labels(self, z, idx) -> Dict[str, np.ndarray]:
        return {
            **self._geom(z, idx),
            "speed": z["speed"][idx].astype(np.float32)[:, None],
            "target_speed": z["target_speed"][idx].astype(np.float32),
            "steer": z["steer"][idx].astype(np.float32),
            "throttle": z["throttle"][idx].astype(np.float32),
            "command": z["command"][idx].astype(np.int32),
            "light_state": z["light_state"][idx].astype(np.int32),
            "light_dist": z["light_dist"][idx].astype(np.float32),
        }

    def _frame_batch(self, z, idx) -> Dict[str, np.ndarray]:
        rgb = z["camera_rgb"][idx]
        if self.augment:
            rgb = _augment(rgb, self._rng)
        if self.packed:
            return {"rgb_u8": np.clip(rgb, 0, 255).astype(np.uint8),
                    "route_u8": z["route_fig"][idx].astype(np.uint8),
                    "camera_seg": z["camera_seg"][idx].astype(np.uint8),
                    **self._labels(z, idx)}
        route_raw = z["route_fig"][idx].astype(np.float32)   # [B, 256, 144]
        m = route_raw.max(axis=(1, 2), keepdims=True)
        route = np.where(m > 0, route_raw / np.maximum(m, 1e-6), route_raw)
        route = np.swapaxes(route, 1, 2)[..., None]          # [B, 144, 256, 1]
        x = np.concatenate([rgb.astype(np.float32) / 255.0, route], axis=-1)
        return {"x": x, "camera_rgb": rgb.astype(np.float32) / 255.0,
                "camera_seg": z["camera_seg"][idx].astype(np.int32),
                "route_fig": route.astype(np.float32),
                **self._labels(z, idx)}

    def _balanced_order(self, z, n: int) -> np.ndarray:
        """Epoch order with rare light classes and walker-visible frames
        repeated (sqrt-tempered factors, capped at 8x)."""
        ls = z["light_state"][:n].astype(np.int64)
        counts = np.bincount(ls, minlength=4).astype(np.float64)
        tgt = counts.max()
        factor = np.minimum(
            np.ceil(np.sqrt(tgt / np.maximum(counts, 1.0))), 8.0)
        rep = factor[ls]
        has_walker = (np.asarray(z["camera_seg"][:n]) == 3).any(axis=(1, 2))
        wfrac = float(has_walker.mean())
        if 0.0 < wfrac < 0.25:
            wf = min(math.ceil(0.25 / wfrac), 8)
            rep = np.maximum(rep, np.where(has_walker, float(wf), 1.0))
        idx = np.repeat(np.arange(n), rep.astype(np.int64))
        return self._rng.permutation(idx)

    @contextlib.contextmanager
    def _shard(self, path: str):
        if self._cache is None:
            with np.load(path) as z:
                yield z
            return
        if path not in self._cache:
            with np.load(path) as z:
                self._cache[path] = {k: z[k] for k in z.files}
        yield self._cache[path]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        shard_order = self._rng.permutation(len(self.paths))
        leftover: Optional[Dict[str, np.ndarray]] = None
        for si in shard_order:
            with self._shard(self.paths[si]) as z:
                n = self._sizes[si]
                order = self._balanced_order(z, n) if self.balance \
                    else self._rng.permutation(n)
                start = 0
                while start < len(order):     # balanced orders exceed n
                    take = self.batch_size if leftover is None else \
                        self.batch_size - len(leftover["speed"])
                    idx = np.sort(order[start:start + take])
                    start += take
                    batch = self._frame_batch(z, idx)
                    if leftover is not None:
                        batch = {k: np.concatenate([leftover[k], batch[k]])
                                 for k in batch}
                        leftover = None
                    if len(batch["speed"]) == self.batch_size:
                        yield batch
                    else:
                        leftover = batch
        if leftover is not None and not self.drop_last:
            yield leftover
