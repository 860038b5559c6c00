"""Vectorized environment: N host envs behind one batched step/reset.

numpy copy of the JAX package's VecDrivingEnv: the envs step one after
another in this process and reset themselves on done, so one batched act
serves all N of them per tick. `_stack_ticks` copies each env's history
views into fresh arrays, so a stacked tick stays valid after the envs
step again.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np


def _stack_ticks(ticks: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {
        "rgb": np.stack([t["rgb"] for t in ticks]),
        "route_fig": np.stack([t["route_fig"] for t in ticks]),
        "measurements": np.stack([t["measurements"] for t in ticks]),
        "command": np.asarray([t["command"] for t in ticks], np.int32),
        "speed": np.asarray([t.get("speed", 0.0) for t in ticks],
                            np.float32),
    }


class VecDrivingEnv:
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self._episode_returns = np.zeros((self.num_envs, 2))
        self.episode_stats: List[Dict[str, Any]] = []

    def reset(self) -> Dict[str, np.ndarray]:
        return _stack_ticks([e.reset() for e in self.envs])

    def step(self, controls: Sequence[Sequence[float]]):
        """controls: [N][steer, throttle, brake]. Auto-resets done envs.

        Returns (stacked tick, rewards [N,2], dones [N], infos list).
        The tick returned for a done env is its post-reset observation.
        """
        ticks, rewards, dones, infos = [], [], [], []
        for i, (env, control) in enumerate(zip(self.envs, controls)):
            tick, reward, done, info = env.step(list(control))
            self._episode_returns[i] += np.asarray(reward)
            if done:
                self.episode_stats.append({
                    "env": i,
                    "steer_return": float(self._episode_returns[i][0]),
                    "throttle_return": float(self._episode_returns[i][1]),
                    "completion": getattr(env, "completion_ratio", 0.0),
                    "error_message": info.get("error_message", ""),
                })
                self._episode_returns[i] = 0.0
                tick = env.reset()
            ticks.append(tick)
            rewards.append(np.asarray(reward))
            dones.append(done)
            infos.append(info)
        return (_stack_ticks(ticks), np.stack(rewards),
                np.asarray(dones, bool), infos)

    def pop_episode_stats(self) -> List[Dict[str, Any]]:
        out = self.episode_stats
        self.episode_stats = []
        return out
