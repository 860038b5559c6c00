"""Replay/synthetic fake env: the test seam for the agent, rollouts and the
update.

numpy copy of the JAX package's FakeDrivingEnv: it replays recorded tick
dicts (or draws deterministic synthetic ones from its seed) and makes up
rewards from a simple progress model, behind the host-env step/reset
contract.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def synthetic_tick(rng: np.random.RandomState, seq_length: int = 8,
                   height: int = 144, width: int = 256) -> Dict[str, Any]:
    return {
        "rgb": rng.randint(0, 255, (seq_length, height, width, 3),
                           dtype=np.uint8),
        "route_fig": (rng.rand(seq_length, width, height) > 0.9).astype(
            np.uint8) * 255,
        "measurements": rng.rand(seq_length, 3).astype(np.float32),
        "command": int(rng.randint(0, 4)),
        "speed": float(rng.rand() * 9),
    }


class FakeDrivingEnv:
    """Replays a log of tick_data dicts (or synthesizes them)."""

    def __init__(self, log: Optional[List[Dict[str, Any]]] = None,
                 episode_length: int = 50, seq_length: int = 8,
                 seed: int = 0, height: int = 144, width: int = 256):
        self._log = log
        self._rng = np.random.RandomState(seed)
        self.episode_length = episode_length
        self.seq_length = seq_length
        self._h, self._w = height, width
        self._t = 0
        self.work_dir = None
        self.completion_ratio = 0.0

    def _tick(self) -> Dict[str, Any]:
        if self._log is not None:
            return self._log[self._t % len(self._log)]
        return synthetic_tick(self._rng, self.seq_length, self._h, self._w)

    def reset(self) -> Dict[str, Any]:
        self._t = 0
        return self._tick()

    def step(self, action: Sequence[float]):
        self._t += 1
        tick = self._tick()
        # fabricated decomposed reward: progress ~ throttle, centering ~ steer
        steer_r = 1.0 - abs(float(action[0]))
        throttle_r = float(action[1]) - float(action[2])
        done = self._t >= self.episode_length
        if done:
            self.completion_ratio = 100.0 * min(1.0, self._t
                                                / self.episode_length)
        rewards = np.array([steer_r, throttle_r], np.float32)
        return tick, rewards, done, {"action_done": (int(done), int(done)),
                                     "error_message": ""}
