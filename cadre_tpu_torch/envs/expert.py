"""Rule-based expert driver of the host env.

numpy copy of the JAX package's OracleExpert (the role of the reference's
statics/vae_agent.py autopilot, pid_controller.py:9): pure pursuit on the
env's planner route, a PI speed controller, braking for obstacles and for
red or yellow lights ahead.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np


class PIDController:
    """Windowed PID (leaderboard/team_code/pid_controller.py:9-35)."""

    def __init__(self, k_p: float = 1.0, k_i: float = 0.0, k_d: float = 0.0,
                 n: int = 20):
        self._k_p, self._k_i, self._k_d = k_p, k_i, k_d
        self._window: deque = deque(maxlen=n)

    def step(self, error: float) -> float:
        self._window.append(error)
        if len(self._window) >= 2:
            integral = float(np.mean(self._window))
            derivative = self._window[-1] - self._window[-2]
        else:
            integral = derivative = 0.0
        return (self._k_p * error + self._k_i * integral
                + self._k_d * derivative)


@dataclasses.dataclass
class ExpertConfig:
    target_speed: float = 7.0
    brake_distance: float = 6.0
    slow_distance: float = 11.0
    lookahead: int = 3


class OracleExpert:
    """Pure-pursuit steering + PID throttle against the env's planner."""

    def __init__(self, cfg: Optional[ExpertConfig] = None):
        self.cfg = cfg or ExpertConfig()
        self._speed_pid = PIDController(k_p=0.5, k_i=0.05, k_d=0.1)

    def act(self, env, tick: Dict[str, Any]) -> List[float]:
        planner = env._planner
        pos = np.asarray(tick.get("gps", env._pos), np.float64)
        route = [p for p, _ in planner.route]
        target = route[min(self.cfg.lookahead, len(route) - 1)]
        rel = np.asarray(target) - pos
        yaw = math.radians(env._yaw)
        heading = np.array([math.cos(yaw), math.sin(yaw)])
        cross = heading[0] * rel[1] - heading[1] * rel[0]
        dot = float(rel @ heading)
        steer = float(np.clip(
            math.atan2(cross, max(dot, 1e-3)) * 4.0 / math.pi, -1, 1))

        speed = float(tick.get("speed", 0.0))
        obstacle = float(tick.get("obstacle", -1.0))
        target_speed = self.cfg.target_speed
        brake = 0.0
        if 0 < obstacle < self.cfg.brake_distance:
            return [steer, 0.0, 1.0]
        # red/yellow light ahead: brake at the stop line (the reference
        # expert's _should_brake light check, statics/vae_agent.py:639+) —
        # this also makes the recorded light_state labels causally coupled
        # to the recorded controls
        light_state = int(tick.get("light_state", 0))
        light_dist = float(tick.get("light_dist", -1.0))
        if light_state in (2, 3) and 0 < light_dist < 12.0:
            return [steer, 0.0, 1.0]
        if 0 < obstacle < self.cfg.slow_distance:
            target_speed = max(0.0, obstacle - 5.0)
        accel = self._speed_pid.step(target_speed - speed)
        throttle = float(np.clip(accel, 0.0, 0.75))
        if accel < -0.5:
            brake = 1.0
            throttle = 0.0
        return [steer, throttle, brake]
