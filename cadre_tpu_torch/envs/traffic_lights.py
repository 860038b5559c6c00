"""Traffic-light and stop-sign subsystem of the host env: geometry, state
and criteria.

numpy copy of the JAX package's host traffic lights, after the scenario
runner's light annotation and state forcing (carla_data_provider.py:
309-414) and its geometric infraction tests (atomic_criteria.py:1836-2075
RunningRedLightTest: stop-line segment crossing, APPROACH_LIGHT events, a
once-per-light debounce through `_last_red_light_id`; :2076+
RunningStopTest's scan / stop / leave state machine).

Lights and stop signs are plain records (`TrafficLightInfo`,
`StopSignInfo`) in the criteria's plane. `SimDrivingEnv` places them at
route corners and runs their cycles: the forced short cycle of every light
(atomic_criteria.py:1869-1871), green 5 s, yellow 3 s, red 0.5 s
(`envs.synthetic`'s constants).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import numpy as np

from cadre_tpu_torch.envs import synthetic
from cadre_tpu_torch.envs.criteria import Criterion, VehicleSnapshot
from cadre_tpu_torch.envs.events import TrafficEvent, TrafficEventType
from cadre_tpu_torch.envs.synthetic import (
    CYCLE,
    GREEN_TIME,
    RED_TIME,
    YELLOW_TIME,
)

GREEN = "green"
YELLOW = "yellow"
RED = "red"

# light-state class ids of the perception light head; 0 = no light visible
LIGHT_CLASSES = {"none": 0, GREEN: 1, YELLOW: 2, RED: 3}

# ego bounding-box half-length (lincoln.mkz2017 extent.x)
DEFAULT_VEH_EXTENT = 2.45


@dataclasses.dataclass
class StopLine:
    """One lane entry at a signalized junction: its stop-line waypoint and
    lane direction."""

    pos: np.ndarray               # stop-line lane waypoint [2]
    dir: np.ndarray               # unit lane direction [2]
    lane_width: float = 3.5


@dataclasses.dataclass
class TrafficLightInfo:
    uid: int
    center: np.ndarray            # trigger-volume center [2]
    stop_lines: List[StopLine]
    state: str = GREEN
    phase: float = 0.0            # cycle phase offset
    frozen: Optional[str] = None  # forced state (update_light_states)
    actor: Any = None             # backing simulator actor, if any
    # per-light (green, yellow, red) override of the forced cycle
    times: Optional[tuple] = None

    def state_at(self, t: float) -> str:
        """The cycle green -> yellow -> red with the forced times."""
        if self.frozen is not None:
            return self.frozen
        g, y, _ = self.times or (GREEN_TIME, YELLOW_TIME, RED_TIME)
        u = (t + self.phase) % (sum(self.times) if self.times else CYCLE)
        if u < g:
            return GREEN
        if u < g + y:
            return YELLOW
        return RED


@dataclasses.dataclass
class StopSignInfo:
    uid: int
    center: np.ndarray            # trigger-volume center [2]
    extent: np.ndarray            # bbox half-extents [2] in the sign frame
    yaw: float = 0.0              # bbox orientation (degrees)


_FREEZE_TIMEOUT = 1e9


def force_actor_state(light: TrafficLightInfo, state: str,
                      freeze: bool = False) -> None:
    """Push a forced state to the backing simulator light: set_state(enum)
    and huge phase times to freeze (carla_data_provider.py:393-397). A
    no-op for map-only lights, which have no actor."""
    actor = light.actor
    if actor is None:
        return
    try:
        import importlib

        carla = importlib.import_module("carla")
        actor.set_state(getattr(carla.TrafficLightState,
                                state.capitalize()))
        if freeze:
            actor.set_green_time(_FREEZE_TIMEOUT)
            actor.set_red_time(_FREEZE_TIMEOUT)
            actor.set_yellow_time(_FREEZE_TIMEOUT)
    except (ImportError, RuntimeError, AttributeError):
        pass


def update_light_states(ego_light: TrafficLightInfo,
                        annotations: dict, states: dict,
                        freeze: bool = False) -> list:
    """Force light states by group role (carla_data_provider.py:369-414).

    `annotations` maps 'ref'/'opposite'/'left'/'right' -> [TrafficLightInfo];
    `states` maps 'ego' or a role -> state string. Returns the parameters
    `reset_lights` restores.
    """
    reset_params = []
    for role, state in states.items():
        lights = [ego_light] if role == "ego" else annotations.get(role, [])
        for light in lights:
            prev_times = None
            if light.actor is not None:
                try:
                    prev_times = (light.actor.get_green_time(),
                                  light.actor.get_red_time(),
                                  light.actor.get_yellow_time())
                except (RuntimeError, AttributeError):
                    prev_times = None
            reset_params.append({"light": light, "state": light.state,
                                 "frozen": light.frozen,
                                 "times": prev_times})
            light.state = state
            if freeze:
                light.frozen = state
            force_actor_state(light, state, freeze=freeze)
    return reset_params


def reset_lights(reset_params: list) -> None:
    for p in reset_params:
        light = p["light"]
        light.state = p["state"]
        light.frozen = p["frozen"]
        force_actor_state(light, p["state"])
        if p.get("times") and light.actor is not None:
            try:
                g, r, y = p["times"]
                light.actor.set_green_time(g)
                light.actor.set_red_time(r)
                light.actor.set_yellow_time(y)
            except (RuntimeError, AttributeError):
                pass


def annotate_light_group(ref: TrafficLightInfo,
                         group: Sequence[TrafficLightInfo]) -> dict:
    """Classify a junction's lights relative to `ref` by approach heading
    (carla_data_provider.py:309-342): yaw diff >330 skip, >225 right, >135
    opposite, >30 left. A same-direction head that is not `ref` itself
    joins no group, as in the reference."""
    out = {"ref": [ref], "opposite": [], "left": [], "right": []}
    if not ref.stop_lines:
        return out
    ref_yaw = math.degrees(math.atan2(*ref.stop_lines[0].dir[::-1]))
    for tl in group:
        if tl.uid == ref.uid or not tl.stop_lines:
            continue
        yaw = math.degrees(math.atan2(*tl.stop_lines[0].dir[::-1]))
        diff = (yaw - ref_yaw) % 360
        if diff > 330:
            continue
        elif diff > 225:
            out["right"].append(tl)
        elif diff > 135:
            out["opposite"].append(tl)
        elif diff > 30:
            out["left"].append(tl)
    return out


def _segments_intersect(p1, p2, q1, q2) -> bool:
    """2D segment intersection by orientation signs (the shapely
    LineString.intersection test, atomic_criteria.py:1878-1886)."""

    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)

    o1, o2 = orient(p1, p2, q1), orient(p1, p2, q2)
    o3, o4 = orient(q1, q2, p1), orient(q1, q2, p2)
    if o1 != o2 and o3 != o4:
        return True
    return False


def _snap_forward(snap: VehicleSnapshot) -> np.ndarray:
    if snap.forward is not None:
        return np.asarray(snap.forward, float)
    yaw = math.radians(snap.yaw)
    return np.array([math.cos(yaw), math.sin(yaw)])


class RunningRedLightCriterion(Criterion):
    """Geometric red-light test (atomic_criteria.py:1836-2075).

    Per tick: for each light whose trigger centre is within DISTANCE_LIGHT
    of the ego and whose stop line serves the ego's lane and direction,
    emit APPROACH_LIGHT until the ego's tail segment crosses the stop line;
    if the light is red when the tail segment crosses the line centred on
    the trigger volume, emit one TRAFFIC_LIGHT_INFRACTION for that light
    (debounced through `_last_red_light_id`).
    """

    name = "RunningRedLightTest"
    DISTANCE_LIGHT = 10.0                      # atomic_criteria.py:1846

    def __init__(self, lights: Sequence[TrafficLightInfo],
                 veh_extent: float = DEFAULT_VEH_EXTENT):
        super().__init__()
        self._lights = list(lights)
        self._ext = veh_extent
        self._last_red_light_id: Optional[int] = None
        self._last_light_id: Optional[int] = None

    def _lane_match(self, sl: StopLine, tail_far: np.ndarray,
                    fwd: np.ndarray) -> bool:
        """Same lane and direction: direction agreement and a lateral
        offset from the lane axis within 0.8 lane widths (the reference
        compares map road / lane ids)."""
        if float(fwd @ sl.dir) <= 0:
            return False
        rel = tail_far - sl.pos
        lateral = abs(float(rel[0] * sl.dir[1] - rel[1] * sl.dir[0]))
        return lateral <= 0.8 * sl.lane_width

    def update(self, snap: VehicleSnapshot) -> None:
        pos = np.asarray(snap.pos, float)
        fwd = _snap_forward(snap)
        tail_close = pos - 0.8 * self._ext * fwd
        tail_far = pos - (self._ext + 1.0) * fwd

        for light in self._lights:
            if self._last_red_light_id == light.uid:
                continue
            center = np.asarray(light.center, float)
            d_center = float(np.hypot(*(center - pos)))
            if d_center > self.DISTANCE_LIGHT:
                continue

            for sl in light.stop_lines:
                if not self._lane_match(sl, tail_far, fwd):
                    continue
                perp = np.array([-sl.dir[1], sl.dir[0]])
                half = 0.4 * sl.lane_width
                # approach phase: stop line at the lane waypoint
                lft, rgt = sl.pos + half * perp, sl.pos - half * perp
                if _segments_intersect(tail_close, tail_far, lft, rgt):
                    self._last_light_id = light.uid
                    break
                if light.uid != self._last_light_id:
                    self.list_traffic_events.append(TrafficEvent(
                        TrafficEventType.APPROACH_LIGHT,
                        f"Approaching light {light.uid} ({light.state})",
                        {"distance": d_center, "id": light.uid,
                         "state": light.state}))

            if light.state != RED:
                continue
            for sl in light.stop_lines:
                if not self._lane_match(sl, tail_far, fwd):
                    continue
                perp = np.array([-sl.dir[1], sl.dir[0]])
                half = 0.4 * sl.lane_width
                # infraction phase: line centred on the trigger volume
                lft, rgt = center + half * perp, center - half * perp
                if _segments_intersect(tail_close, tail_far, lft, rgt):
                    self.test_status = "FAILURE"
                    self.actual_value += 1
                    self.list_traffic_events.append(TrafficEvent(
                        TrafficEventType.TRAFFIC_LIGHT_INFRACTION,
                        f"Agent ran a red light {light.uid} at "
                        f"(x={center[0]:.3f}, y={center[1]:.3f})",
                        {"id": light.uid, "x": float(center[0]),
                         "y": float(center[1])}))
                    self._last_red_light_id = light.uid
                    break


def _point_inside_bb(point: np.ndarray, center: np.ndarray,
                     extent: np.ndarray, yaw_deg: float) -> bool:
    """Oriented-bbox containment (RunningStopTest.point_inside_boundingbox
    with the box's yaw)."""
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    rel = np.asarray(point, float) - np.asarray(center, float)
    local = np.array([c * rel[0] + s * rel[1], -s * rel[0] + c * rel[1]])
    return bool(abs(local[0]) < extent[0] and abs(local[1]) < extent[1])


class RunningStopCriterion(Criterion):
    """Stop-sign state machine (atomic_criteria.py:2076+): scan -> affected
    when the ego or its forward horizon enters the trigger box -> require
    speed < SPEED_THRESHOLD before leaving the influence region, else
    STOP_INFRACTION. The horizon is sampled along the ego's forward ray at
    WAYPOINT_STEP intervals (the reference walks map waypoints)."""

    name = "RunningStopTest"
    PROXIMITY_THRESHOLD = 50.0
    SPEED_THRESHOLD = 0.1
    WAYPOINT_STEP = 1.0
    HORIZON_STEPS = 20

    def __init__(self, stop_signs: Sequence[StopSignInfo]):
        super().__init__()
        self._signs = list(stop_signs)
        self._target: Optional[StopSignInfo] = None
        self._stop_completed = False
        self._affected = False

    def _is_affected(self, sign: StopSignInfo, pos: np.ndarray,
                     fwd: np.ndarray) -> bool:
        if float(np.hypot(*(sign.center - pos))) > self.PROXIMITY_THRESHOLD:
            return False
        for k in range(self.HORIZON_STEPS + 1):
            p = pos + k * self.WAYPOINT_STEP * fwd
            if _point_inside_bb(p, sign.center, sign.extent, sign.yaw):
                return True
        return False

    def update(self, snap: VehicleSnapshot) -> None:
        pos = np.asarray(snap.pos, float)
        fwd = _snap_forward(snap)

        if self._target is None:
            for sign in self._signs:
                if self._is_affected(sign, pos, fwd):
                    self._target = sign
                    self._stop_completed = False
                    self._affected = False
                    break
            return

        if not self._stop_completed and snap.speed < self.SPEED_THRESHOLD:
            self._stop_completed = True
        if not self._affected and _point_inside_bb(
                pos, self._target.center, self._target.extent,
                self._target.yaw):
            self._affected = True

        if not self._is_affected(self._target, pos, fwd):
            # left the influence region
            if self._affected and not self._stop_completed:
                self.test_status = "FAILURE"
                self.actual_value += 1
                c = self._target.center
                self.list_traffic_events.append(TrafficEvent(
                    TrafficEventType.STOP_INFRACTION,
                    f"Agent ran a stop with id={self._target.uid} at "
                    f"(x={c[0]:.3f}, y={c[1]:.3f})",
                    {"id": self._target.uid, "x": float(c[0]),
                     "y": float(c[1])}))
            self._target = None
            self._stop_completed = False
            self._affected = False


def lights_at_route_corners(keypoints: np.ndarray, dense: np.ndarray,
                            rng: np.random.RandomState,
                            setback: float = 8.0,
                            lane_width: float = 3.5,
                            min_turn_deg: float = 30.0
                            ) -> List[TrafficLightInfo]:
    """The kinematic sim's junction lights: one at each interior route
    keypoint where the heading turns by more than `min_turn_deg`, its stop
    line on the route `setback` meters before the corner, a random cycle
    phase (`synthetic.lights_at_route_corners`'s draws). `dense` is not
    read; the argument keeps the JAX package's signature."""
    lights: List[TrafficLightInfo] = []
    for stop_pos, u_in, phase in synthetic.lights_at_route_corners(
            keypoints, rng, setback=setback, min_turn_deg=min_turn_deg):
        sl = StopLine(pos=stop_pos, dir=u_in, lane_width=lane_width)
        lights.append(TrafficLightInfo(
            uid=len(lights) + 1, center=stop_pos.copy(), stop_lines=[sl],
            phase=phase))
    return lights


def nearest_light_ahead(lights: Sequence[TrafficLightInfo],
                        pos: np.ndarray, fwd: np.ndarray,
                        max_dist: float = 25.0):
    """(state class, distance) of the nearest light inside the ego
    camera's 90-degree frustum (forward >= 1.5 m and |lateral| <=
    forward): the perception light head's label. (0, -1.0) when no light
    is visible."""
    pos = np.asarray(pos, float)
    f = np.asarray(fwd, float)
    f = f / max(float(np.hypot(*f)), 1e-9)
    left = np.array([-f[1], f[0]])
    best, best_d = None, max_dist
    for light in lights:
        rel = np.asarray(light.center, float) - pos
        d = float(np.hypot(*rel))
        xf = float(rel @ f)
        if d > best_d or xf < 1.5 or abs(float(rel @ left)) > xf:
            continue
        best, best_d = light, d
    if best is None:
        return LIGHT_CLASSES["none"], -1.0
    return LIGHT_CLASSES[best.state], best_d
