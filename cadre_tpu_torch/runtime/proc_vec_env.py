"""Process-pool vectorized env over shared-memory rings.

The port's copy of the JAX package's ProcVecDrivingEnv. N env worker
processes each own one driving env (the reference's
one-process-per-CARLA-server topology, main.py:63-70) and exchange
fixed-size frames with the trainer through the native shm ring
(runtime/ringbuf.cpp): an action mailbox per worker (trainer -> worker)
and an observation ring of two slots per worker (worker -> trainer). All
workers step at once; the trainer's gather is a memcpy per worker, not
pickling.

Workers come from the `spawn` context, so a trainer that has CUDA up
forks nothing of it; each rebuilds its env from the pickled env factory
(which must hold no tensor) and imports only the numpy env modules.
Interface-compatible with envs.vec_env.VecDrivingEnv, except that the
stacked tick carries no 'speed' and its measurements and rewards are
float32. The controls travel as float64 (the JAX package's mailbox rounds
them to float32), so the envs step exactly as they would in-process.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import struct
import time
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from cadre_tpu_torch.envs.synthetic import SIZE_X, SIZE_Y
from cadre_tpu_torch.runtime.shm_ring import ShmRing, ring_bytes
from cadre_tpu_torch.utils.logger import logger

_OP_RESET = 0.0
_OP_STEP = 1.0
_OP_CLOSE = 2.0
# an action frame: op, steer, throttle, brake as float64, so that a worker
# steps its env on the very controls an in-process env would get
_ACT_FMT = "<4d"
_ACT_BYTES = struct.calcsize(_ACT_FMT)
# a worker silent this long is terminated and respawned, at most
# _MAX_RESPAWNS times per slot before the trainer gives up
_TIMEOUT_S = 120.0
_MAX_RESPAWNS = 3


class _TickCodec:
    """Fixed-layout tick_data <-> bytes: rgb [seq, h, w, 3] u8, route
    figure [seq, w, h] u8, measurements [seq, 3] f32, then command i32,
    rewards 2 x f32, done u8, action_done 2 x u8, completion f32, pad u8.
    h x w is the envs' fixed camera frame (envs/synthetic.py's SIZE_X x
    SIZE_Y); a tick of another shape is refused, not cut to fit."""

    def __init__(self, seq: int):
        self.seq, self.h, self.w = seq, SIZE_X, SIZE_Y
        self.rgb_n = seq * SIZE_X * SIZE_Y * 3
        self.route_n = seq * SIZE_Y * SIZE_X
        self.meas_n = seq * 3 * 4
        self.tail_n = 4 + 8 + 1 + 2 + 4 + 1
        self.frame_bytes = (self.rgb_n + self.route_n + self.meas_n
                            + self.tail_n)

    def encode(self, tick: Dict[str, Any], rewards, done, action_done,
               completion: float) -> bytes:
        parts = [
            np.ascontiguousarray(tick["rgb"], np.uint8).tobytes(),
            np.ascontiguousarray(tick["route_fig"], np.uint8).tobytes(),
            np.ascontiguousarray(tick["measurements"],
                                 np.float32).tobytes(),
            struct.pack("<i2fB2BfB", int(tick["command"]),
                        float(rewards[0]), float(rewards[1]), int(done),
                        int(action_done[0]), int(action_done[1]),
                        float(completion), 0),
        ]
        frame = b"".join(parts)
        if len(frame) != self.frame_bytes:
            raise ValueError(
                f"a tick of {len(frame)} bytes (rgb {np.shape(tick['rgb'])}, "
                f"route_fig {np.shape(tick['route_fig'])}) does not fit the "
                f"{self.frame_bytes}-byte frame of seq={self.seq}, "
                f"{self.h}x{self.w}")
        return frame

    def decode(self, buf: bytes):
        o = 0
        rgb = np.frombuffer(buf, np.uint8, self.rgb_n, o).reshape(
            self.seq, self.h, self.w, 3)
        o += self.rgb_n
        route = np.frombuffer(buf, np.uint8, self.route_n, o).reshape(
            self.seq, self.w, self.h)
        o += self.route_n
        meas = np.frombuffer(buf, np.float32, self.seq * 3, o).reshape(
            self.seq, 3)
        o += self.meas_n
        command, r0, r1, done, ad0, ad1, completion, _ = struct.unpack_from(
            "<i2fB2BfB", buf, o)
        return ({"rgb": rgb, "route_fig": route, "measurements": meas,
                 "command": command},
                np.array([r0, r1], np.float32), bool(done), (ad0, ad1),
                completion)


def _worker_main(env_fn_bytes: bytes, obs_name: str, act_name: str,
                 seq: int, parent: int) -> None:
    """A worker's loop: build the env, then answer each action frame with
    an observation frame until told to close, or until the trainer that
    spawned it (pid `parent`) is gone."""
    env = pickle.loads(env_fn_bytes)()
    codec = _TickCodec(seq)
    obs_ring = ShmRing(obs_name)
    act_ring = ShmRing(act_name)
    completion = 0.0
    while True:
        frame = act_ring.read(timeout_ms=60_000)
        if frame is None:
            if os.getppid() != parent:
                break
            continue
        op, steer, throttle, brake = struct.unpack_from(_ACT_FMT, frame)
        if op == _OP_CLOSE:
            break
        if op == _OP_RESET:
            tick = env.reset()
            obs_ring.write(codec.encode(tick, (0.0, 0.0), False, (0, 0),
                                        0.0))
            continue
        tick, rewards, done, info = env.step([steer, throttle, brake])
        if done:
            completion = getattr(env, "completion_ratio", 0.0)
            tick = env.reset()
        obs_ring.write(codec.encode(tick, rewards, done,
                                    info["action_done"], completion))
    obs_ring.close()
    act_ring.close()


class ProcVecDrivingEnv:
    """N envs, each in a worker process of its own.

    Elastic recovery: a worker that dies or stays silent for _TIMEOUT_S is
    terminated and respawned with fresh rings (at most _MAX_RESPAWNS times
    per slot), and its slot reports done=True ("worker restarted") so the
    trainer treats the lost episode as a boundary. The reference has no
    equivalent: a dead worker hangs its chief barrier forever."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]],
                 seq_length: int = 8):
        self.num_envs = len(env_fns)
        self._codec = _TickCodec(seq_length)
        self._env_fn_bytes = [pickle.dumps(fn) for fn in env_fns]
        self._respawns = [0] * self.num_envs
        self.episode_stats: List[Dict[str, Any]] = []
        self._episode_returns = np.zeros((self.num_envs, 2))

        self._base = (f"/cadre_{os.getpid()}_"
                      f"{int(time.time() * 1000) % 100_000}")
        self._ctx = mp.get_context("spawn")
        self._gen = [0] * self.num_envs   # ring-name generation per worker
        self._obs_rings: List[ShmRing] = [None] * self.num_envs
        self._act_rings: List[ShmRing] = [None] * self.num_envs
        self._procs: List[mp.Process] = [None] * self.num_envs
        shm = self.num_envs * (ring_bytes(2, self._codec.frame_bytes)
                               + ring_bytes(2, _ACT_BYTES))
        logger.log(f"process envs: {self.num_envs} workers, "
                   f"{shm / 2**20:.1f} MiB of /dev/shm in rings "
                   f"(2 frames of {self._codec.frame_bytes} bytes each)")
        try:
            for i in range(self.num_envs):
                self._spawn(i)
        except BaseException:
            self.close()
            raise

    def _spawn(self, i: int) -> None:
        obs_name = f"{self._base}_obs{i}g{self._gen[i]}"
        act_name = f"{self._base}_act{i}g{self._gen[i]}"
        self._obs_rings[i] = ShmRing(
            obs_name, n_slots=2, frame_bytes=self._codec.frame_bytes,
            create=True)
        self._act_rings[i] = ShmRing(
            act_name, n_slots=2, frame_bytes=_ACT_BYTES, create=True)
        p = self._ctx.Process(
            target=_worker_main,
            args=(self._env_fn_bytes[i], obs_name, act_name,
                  self._codec.seq, os.getpid()),
            daemon=True)
        p.start()
        self._procs[i] = p

    def _respawn(self, i: int):
        """Kill worker i, bring up a replacement, and return its reset tick
        (or None if the replacement also fails)."""
        self._respawns[i] += 1
        p = self._procs[i]
        if p is not None and p.is_alive():
            p.terminate()
            p.join(timeout=5)
        for ring in (self._obs_rings[i], self._act_rings[i]):
            ring.close()
        self._gen[i] += 1
        self._spawn(i)
        self._act_rings[i].write(struct.pack(_ACT_FMT, _OP_RESET, 0, 0, 0))
        return self._read_obs(i)

    def _read_obs(self, i: int):
        """Ring read in 1 s slices, checking worker liveness between them:
        a dead worker is detected in about 1 s instead of the full hang
        timeout."""
        deadline = time.time() + _TIMEOUT_S
        while True:
            remaining_ms = int((deadline - time.time()) * 1000)
            if remaining_ms <= 0:
                return None
            buf = self._obs_rings[i].read(
                timeout_ms=min(1000, remaining_ms))
            if buf is not None:
                return buf
            if not self._procs[i].is_alive():
                return None

    def _gather(self):
        ticks, rewards, dones, infos = [], [], [], []
        for i in range(self.num_envs):
            buf = self._read_obs(i)
            restarted = False
            while buf is None and self._respawns[i] < _MAX_RESPAWNS:
                restarted = True
                buf = self._respawn(i)
            if buf is None:
                raise TimeoutError(
                    f"env worker {i} did not respond "
                    f"(after {self._respawns[i]} respawns)")
            tick, r, done, action_done, completion = self._codec.decode(buf)
            if restarted:
                # the in-flight episode is lost; surface a boundary
                done, r, action_done = True, np.zeros(2, np.float32), (1, 1)
            self._episode_returns[i] += r
            err = "worker restarted" if restarted else ""
            if done:
                self.episode_stats.append({
                    "env": i,
                    "steer_return": float(self._episode_returns[i][0]),
                    "throttle_return": float(self._episode_returns[i][1]),
                    "completion": completion,
                    "error_message": err,
                })
                self._episode_returns[i] = 0.0
            ticks.append(tick)
            rewards.append(r)
            dones.append(done)
            infos.append({"action_done": action_done, "error_message": err})
        stacked = {
            "rgb": np.stack([t["rgb"] for t in ticks]),
            "route_fig": np.stack([t["route_fig"] for t in ticks]),
            "measurements": np.stack([t["measurements"] for t in ticks]),
            "command": np.asarray([t["command"] for t in ticks], np.int32),
        }
        return stacked, np.stack(rewards), np.asarray(dones, bool), infos

    def reset(self):
        for ring in self._act_rings:
            ring.write(struct.pack(_ACT_FMT, _OP_RESET, 0, 0, 0))
        stacked, *_ = self._gather()
        return stacked

    def step(self, controls: Sequence[Sequence[float]]):
        """controls: [N][steer, throttle, brake]. Workers auto-reset done
        envs; returns (stacked tick, rewards [N,2], dones [N], infos)."""
        for ring, c in zip(self._act_rings, controls):
            ring.write(struct.pack(_ACT_FMT, _OP_STEP, float(c[0]),
                                   float(c[1]), float(c[2])))
        return self._gather()

    def pop_episode_stats(self) -> List[Dict[str, Any]]:
        out = self.episode_stats
        self.episode_stats = []
        return out

    def close(self) -> None:
        """Tell every worker to close, join it (terminating one that does
        not exit within 5 s) and unlink the rings."""
        for ring in self._act_rings:
            if ring is not None:
                ring.write(struct.pack(_ACT_FMT, _OP_CLOSE, 0, 0, 0))
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for ring in self._obs_rings + self._act_rings:
            if ring is not None:
                ring.close()
