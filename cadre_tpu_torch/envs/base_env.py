"""Host-env base: the reset/step/tick contract over an abstract world.

numpy copy of the JAX package's host env base (env_wrapper.py contract):
  - reset() -> tick; step([steer, throttle, brake]) -> (tick, rewards,
    done, info) with info['action_done'] the per-signal done pair
    (:857-918).
  - The tick carries the seq_length-frame histories: rgb [T,H,W,3],
    measurements [T,3] = [speed/max_speed, dis/3, |theta_deg|/90],
    route_fig [T,256,144], plus 'command' (near RoadOption - 1) and the
    last_* single-frame entries (:670-689, :887-914). measurements is
    float64 and command a Python int, as the JAX package gives them; the
    agent casts them where it takes them.
  - reset pre-fills the history by stepping no-op actions seq_length-1
    times (:687-689).
  - Each episode's completion ratio is appended to a CSV (:135-152,
    :563-578).

Subclasses implement the world: `_world_reset`, `_world_step`,
`_world_tick`, `_planner_step`.
"""
from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.criteria import Criterion
from cadre_tpu_torch.envs.events import TrafficEvent
from cadre_tpu_torch.envs.reward import (
    RewardConfig,
    RewardState,
    compute_reward,
)
from cadre_tpu_torch.envs.road_option import RoadOption, command_index
from cadre_tpu_torch.envs.route_fig import TurnState, draw_route


class BaseDrivingEnv:
    """Shared reset/step plumbing over an abstract world."""

    def __init__(self, seq_length: int = 8, frame_rate: int = 10,
                 training: bool = True, vehicle_block_time: int = 400,
                 reward_cfg: Optional[RewardConfig] = None,
                 work_dir: Optional[str] = None, rank: int = 0):
        self.seq_length = seq_length
        self.dt = 1.0 / frame_rate
        self.training = training
        self.vehicle_block_time = vehicle_block_time
        self.reward_cfg = reward_cfg or RewardConfig(training=training)
        self.rank = rank
        self.work_dir = work_dir
        self._step_count = 0
        self._history: Dict[str, Any] = {}
        self._hist_index = 0
        self._turn_state = TurnState()
        self._reward_state = RewardState()
        self._criteria: List[Criterion] = []
        self._event_num = np.zeros(16)
        self.near_command = RoadOption.LANEFOLLOW
        self.error_message = ""
        self.completion_ratio = 0.0
        self.route_name: Any = 0
        if work_dir is not None:
            os.makedirs(work_dir, exist_ok=True)
            suffix = "eval_completion_ratio.csv" if not training else \
                "completion_ratio.csv"
            self._completion_csv = os.path.join(work_dir, suffix)
        else:
            self._completion_csv = None

    # -------------- world interface (subclass) --------------

    def _world_reset(self) -> None:
        """Build a new episode: route, planner, criteria, vehicle."""
        raise NotImplementedError

    def _world_step(self, control: Sequence[float]) -> None:
        """Advance the world one tick with [steer, throttle, brake]."""
        raise NotImplementedError

    def _world_tick(self) -> Dict[str, Any]:
        """Sensors -> dict with keys: rgb [H,W,3] uint8, gps [2], speed,
        compass, forward [2] (ego unit heading in route space), obstacle
        (distance or -1)."""
        raise NotImplementedError

    def _planner_step(self, gps) -> Tuple[np.ndarray, RoadOption, list]:
        raise NotImplementedError

    # -------------- shared machinery --------------

    def _new_events(self) -> List[TrafficEvent]:
        """Diff per-criterion event counters (env_wrapper.py:923-933)."""
        out = []
        for i, crit in enumerate(self._criteria):
            events = crit.list_traffic_events
            for j in range(int(self._event_num[i]), len(events)):
                out.append(events[j])
            self._event_num[i] = len(events)
        return out

    def _assemble_tick(self) -> Dict[str, Any]:
        raw = self._world_tick()
        raw["new_event_list"] = self._new_events()
        gps = np.asarray(raw["gps"], np.float64)
        near_node, near_command, route_list = self._planner_step(gps)
        self.near_command = near_command
        raw["command"] = command_index(near_command)

        fig, dis, theta, self._turn_state = draw_route(
            route_list, gps, raw["compass"], raw["forward"],
            self._turn_state)
        raw["last_route_fig"] = fig
        raw["last_rgb"] = raw.pop("rgb")
        raw["last_measurements"] = [
            raw["speed"] / self.reward_cfg.max_speed,
            dis / 3.0,
            abs(180.0 * theta / np.pi) / 90.0,
        ]
        raw["_dis"] = dis
        raw["_theta"] = theta
        return raw

    def _push_history(self, tick: Dict[str, Any]) -> Dict[str, Any]:
        """Keep the seq_length-frame histories in a double-length ring: each
        frame is written at i and i+seq, so the ordered window is always a
        contiguous view.

        tick['rgb'/'measurements'/'route_fig'] are VIEWS, valid for the
        current step only: they are overwritten seq_length steps later.
        Whoever keeps them across steps must copy them.
        """
        s = self.seq_length
        i = self._hist_index % s
        for key, src in [("rgb", "last_rgb"),
                         ("measurements", "last_measurements"),
                         ("route_fig", "last_route_fig")]:
            frame = np.asarray(tick[src])
            ring = self._history.get(key)
            if ring is None or ring.shape[1:] != frame.shape:
                ring = np.zeros((2 * s,) + frame.shape, frame.dtype)
                # pre-fill so short histories replicate the first frame
                ring[:] = frame
                self._history[key] = ring
            ring[i] = frame
            ring[i + s] = frame
            tick[key] = ring[i + 1: i + 1 + s]
        self._hist_index += 1
        return tick

    def reset(self) -> Dict[str, Any]:
        self._step_count = 0
        self._turn_state = TurnState()
        self._reward_state = RewardState()
        self._event_num = np.zeros(16)
        self._history = {}
        self._hist_index = 0
        self.error_message = ""
        self._world_reset()
        tick = self._assemble_tick()
        tick = self._push_history(tick)
        for _ in range(self.seq_length - 1):
            tick, *_ = self.step([0.0, 0.0, 0.0])
        return tick

    def step(self, action: Sequence[float]):
        self._step_count += 1
        self._reward_state.step = self._step_count
        self._world_step(action)
        tick = self._assemble_tick()

        max_block = self.vehicle_block_time if self.training else 800
        result = compute_reward(
            self._reward_state, self.reward_cfg, tick["speed"], tick["_dis"],
            tick["_theta"], tick["new_event_list"], tick.get("obstacle", -1),
            self._turn_state.in_turn, self.near_command,
            max_block_time=max_block)
        if result.done:
            self.error_message = result.error_message

        tick = self._push_history(tick)
        info = {"action_done": result.action_done,
                "error_message": result.error_message}
        if result.done:
            self._cleanup_episode()
        return tick, result.rewards, result.done, info

    def _cleanup_episode(self) -> None:
        """Record the completion ratio (env_wrapper.py:563-578)."""
        for crit in self._criteria:
            crit.terminate()
            if crit.name == "RouteCompletionTest":
                self.completion_ratio = crit.actual_value
                if self._completion_csv:
                    with open(self._completion_csv, "a", newline="") as f:
                        csv.writer(f).writerow(
                            [self.route_name, self.completion_ratio])
