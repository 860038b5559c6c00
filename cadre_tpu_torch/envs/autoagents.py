"""The srunner autoagents family over the AutonomousAgent contract (the
port's copy of the JAX package's host `envs/autoagents.py`).

The reference ships example ego agents under `srunner/autoagents/`:
`npc_agent.py` (BasicAgent route follower), `dummy_agent.py` (prints its
sensor feed, full stop), and `human_agent.py` (pygame keyboard teleop).
These are their synthetic-world counterparts over
`envs/autonomous_agent.py`'s sensor-spec/run_step interface:

- `DummyAgent` — the reference's sensor suite, zero control
  (dummy_agent.py:28-83).
- `NpcAgent` — follows the downsampled global plan via pure pursuit on
  gnss/imu/speedometer readings (npc_agent.py:19-107; the BasicAgent's
  local-planner role collapsed onto the kinematic contract).
- `HumanAgent` — keyboard teleop; reads pygame when available, else an
  injected `input_source` callable returning the currently-pressed key
  names (human_agent.py:151-214's KeyboardControl mapping: arrows/WASD,
  space = hand brake).

(`ros_agent.py` has no counterpart.)
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from cadre_tpu_torch.envs.autonomous_agent import AutonomousAgent


def _payload(input_data: Dict[str, Any], tag: str, default=None):
    item = input_data.get(tag)
    if item is None:
        return default
    # SensorInterface delivers (frame, payload)
    return item[1] if isinstance(item, tuple) else item


class DummyAgent(AutonomousAgent):
    """Full-stop agent with the reference's example sensor suite
    (dummy_agent.py:28-83). `verbose=True` prints each feed's shape like
    the reference's run_step."""

    def setup(self, path_to_conf_file: Optional[str]) -> None:
        self.verbose = False

    def sensors(self) -> List[Dict[str, Any]]:
        return [
            {"type": "sensor.camera.rgb", "x": 0.7, "y": -0.4, "z": 1.60,
             "width": 300, "height": 200, "fov": 100, "id": "Left"},
            {"type": "sensor.camera.rgb", "x": 0.7, "y": 0.4, "z": 1.60,
             "width": 300, "height": 200, "fov": 100, "id": "Right"},
            {"type": "sensor.lidar.ray_cast", "x": 0.7, "y": 0.0,
             "z": 1.60, "id": "LIDAR"},
            {"type": "sensor.other.gnss", "x": 0.7, "y": -0.4, "z": 1.60,
             "id": "GPS"},
            {"type": "sensor.speedometer", "id": "speed"},
        ]

    def run_step(self, input_data: Dict[str, Any], timestamp: float
                 ) -> List[float]:
        if self.verbose:
            print("=====================>")
            for key, item in input_data.items():
                payload = item[1] if isinstance(item, tuple) else item
                shape = getattr(payload, "shape", None)
                print(f"[{key}] shape {shape}" if shape is not None
                      else f"[{key}] {type(payload).__name__}")
            print("<=====================")
        return [0.0, 0.0, 0.0]


class NpcAgent(AutonomousAgent):
    """Route follower: pure pursuit over the downsampled global plan
    (npc_agent.py's BasicAgent role). Needs gnss ('GPS'), imu compass
    ('IMU', optional) and speedometer ('speed') feeds."""

    TARGET_SPEED = 6.0          # m/s, the BasicAgent default ~20 km/h
    LOOKAHEAD = 6.0             # m, pure-pursuit arc distance
    GOAL_REACHED = 4.0          # m

    def setup(self, path_to_conf_file: Optional[str]) -> None:
        self._plan_xy: Optional[np.ndarray] = None
        self._index = 0

    def sensors(self) -> List[Dict[str, Any]]:
        return [
            {"type": "sensor.camera.rgb", "x": 0.7, "y": -0.4, "z": 1.60,
             "width": 300, "height": 200, "fov": 100, "id": "Left"},
            {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 1.60,
             "id": "GPS"},
            {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 1.60,
             "id": "IMU"},
            {"type": "sensor.speedometer", "id": "speed"},
        ]

    def _ensure_plan(self) -> bool:
        if self._plan_xy is not None:
            return True
        # prefer the pre-downsample plan — the synthetic-world analog of
        # BasicAgent's map re-trace between the 50 m-sparse points (the
        # sparse plan's straight legs cut route corners clean out of the
        # lane envelope)
        plan = getattr(self, "_raw_plan_world_coord", None) \
            or self._global_plan_world_coord
        if not plan:
            return False
        pts = np.asarray(
            [(p[0].location.x, p[0].location.y)
             if hasattr(p[0], "location") else tuple(p[0])[:2]
             for p in plan], float)
        # densify to ~1 m so the pure-pursuit target rides the polyline
        # (the BasicAgent's LocalPlanner tracks dense map waypoints, not
        # the sparse downsampled plan — sparse chasing cuts corners
        # through the lane envelope)
        dense = [pts[0]]
        for a, b in zip(pts[:-1], pts[1:]):
            seg = float(np.hypot(*(b - a)))
            for k in range(1, max(int(seg), 1) + 1):
                dense.append(a + (b - a) * k / max(int(seg), 1))
        self._plan_xy = np.asarray(dense)
        self._index = 0
        return True

    def run_step(self, input_data: Dict[str, Any], timestamp: float
                 ) -> List[float]:
        if not self._ensure_plan():
            return [0.0, 0.0, 0.0]     # route not assigned yet
        gps = np.asarray(_payload(input_data, "GPS",
                                  np.zeros(2)), float).ravel()[:2]
        imu = _payload(input_data, "IMU")
        speed_item = _payload(input_data, "speed", 0.0)
        speed = float(speed_item["speed"]) if isinstance(speed_item, dict) \
            else float(np.asarray(speed_item).ravel()[0])

        # monotone progress: advance to the nearest plan point in a short
        # forward window, then target LOOKAHEAD meters further along
        window = self._plan_xy[self._index:self._index + 30]
        d = np.hypot(window[:, 0] - gps[0], window[:, 1] - gps[1])
        self._index += int(np.argmin(d))
        target = self._plan_xy[min(self._index + int(self.LOOKAHEAD),
                                   len(self._plan_xy) - 1)]
        if self._index >= len(self._plan_xy) - int(self.LOOKAHEAD) and \
                float(np.hypot(*(self._plan_xy[-1] - gps))) \
                < self.GOAL_REACHED:
            return [0.0, 0.0, 1.0]     # plan exhausted: brake

        rel = target - gps
        want = math.atan2(rel[1], rel[0])
        if imu is not None:
            compass = float(np.asarray(imu).ravel()[-1])
        else:
            compass = want             # no imu: assume aligned
        err = (want - compass + math.pi) % (2 * math.pi) - math.pi
        steer = float(np.clip(err / (math.pi / 6), -1.0, 1.0))
        # corner slowdown: the BasicAgent's local planner brakes into
        # sharp heading error; without it the kinematic ego overshoots
        # the lane envelope at route corners
        want_speed = self.TARGET_SPEED if abs(err) < 0.3 else 2.0
        throttle = float(np.clip(
            0.75 * (want_speed - speed) / self.TARGET_SPEED, 0.0, 0.75))
        brake = 1.0 if speed > want_speed * 1.2 else 0.0
        return [steer, throttle, brake]


# KeyboardControl mapping (human_agent.py:167-214)
_KEY_THROTTLE = {"up", "w"}
_KEY_BRAKE = {"down", "s"}
_KEY_LEFT = {"left", "a"}
_KEY_RIGHT = {"right", "d"}
_KEY_HAND_BRAKE = {"space"}


def _pygame_keys(init: bool = False) -> Set[str]:  # pragma: no cover
    """The names of the keys pressed now (needs a display); with `init`,
    pygame.init() instead. The one place pygame is imported."""
    import pygame

    if init:
        pygame.init()
        return set()
    pygame.event.pump()
    pressed = pygame.key.get_pressed()
    names = set()
    for key in range(len(pressed)):
        if pressed[key]:
            names.add(pygame.key.name(key))
    return names


class HumanAgent(AutonomousAgent):
    """Keyboard teleop (human_agent.py:100-214). `input_source` is a
    callable returning the set of currently-pressed key names; defaults
    to pygame's pressed-key scan when pygame is importable, else no
    input (zero control)."""

    def __init__(self, path_to_conf_file: Optional[str] = None,
                 input_source: Optional[Callable[[], Set[str]]] = None):
        self._input = input_source
        super().__init__(path_to_conf_file)

    def setup(self, path_to_conf_file: Optional[str]) -> None:
        if self._input is None:
            try:  # pragma: no cover - needs a display
                _pygame_keys(init=True)
                self._input = _pygame_keys
            except Exception:
                self._input = lambda: set()
        self._steer_cache = 0.0

    def sensors(self) -> List[Dict[str, Any]]:
        return [
            {"type": "sensor.camera.rgb", "x": 0.7, "y": 0.0, "z": 1.60,
             "width": 800, "height": 600, "fov": 100, "id": "Center"},
            {"type": "sensor.speedometer", "id": "speed"},
        ]

    def run_step(self, input_data: Dict[str, Any], timestamp: float
                 ) -> List[float]:
        keys = {k.lower() for k in self._input()}
        throttle = 0.6 if keys & _KEY_THROTTLE else 0.0
        brake = 1.0 if keys & (_KEY_BRAKE | _KEY_HAND_BRAKE) else 0.0
        # the reference's steer cache: ramp toward full lock while held,
        # recenter when released (human_agent.py:196-213)
        if keys & _KEY_LEFT:
            self._steer_cache = max(self._steer_cache - 0.05, -0.7)
        elif keys & _KEY_RIGHT:
            self._steer_cache = min(self._steer_cache + 0.05, 0.7)
        else:
            self._steer_cache = 0.0
        return [round(self._steer_cache, 2), throttle, brake]
