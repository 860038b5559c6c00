"""Tick-driven criteria runtime of the host env.

numpy copy of the JAX package's host criteria: the 7 route criteria
(RouteCompletion, InRoute, Collision, OutsideRouteLanes, RunningRedLight,
RunningStop, AgentBlocked; leaderboard route_scenario.py:562-597) plus the
route-length-scaled timeout, as small state machines with the event
semantics of the scenario runner's atomic criteria, updated once per env
tick. The env diffs each criterion's `list_traffic_events` counter
(env_wrapper.py:923-933).

Each criterion reads a `VehicleSnapshot`, a minimal view of the world.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from cadre_tpu_torch.envs.events import TrafficEvent, TrafficEventType


@dataclasses.dataclass
class VehicleSnapshot:
    pos: np.ndarray                  # [2] meters (criteria plane)
    yaw: float                       # degrees
    speed: float                     # m/s
    collided_static: bool = False
    collided_vehicle: bool = False
    collided_pedestrian: bool = False
    off_lane: bool = False           # outside driving lanes
    # unit heading in the plane of `pos`; the geometric light and stop
    # criteria fall back to cos/sin(yaw) without it
    forward: Optional[np.ndarray] = None


class Criterion:
    """Base: accumulates TrafficEvents across the episode."""

    name = "Criterion"

    def __init__(self):
        self.list_traffic_events: List[TrafficEvent] = []
        self.actual_value: float = 0.0
        self.test_status = "INIT"

    def update(self, snap: VehicleSnapshot) -> None:  # pragma: no cover
        raise NotImplementedError

    def terminate(self) -> None:
        pass


class RouteCompletionCriterion(Criterion):
    """Waypoint-progress percentage (atomic_criteria.py:1731-1835): the
    farthest dense-route index within DISTANCE_THRESHOLD; ROUTE_COMPLETED
    at >= terminate_pct percent."""

    name = "RouteCompletionTest"
    DISTANCE_THRESHOLD = 10.0

    def __init__(self, route_xy: np.ndarray, terminate_pct: float = 99.0):
        super().__init__()
        self._route = np.asarray(route_xy, np.float64)
        self._index = 0
        self._completed = False
        self._terminate_pct = terminate_pct
        seg = np.diff(self._route, axis=0)
        seg_len = np.hypot(seg[:, 0], seg[:, 1])
        self._cum = np.concatenate([[0.0], np.cumsum(seg_len)])
        self._total = max(float(self._cum[-1]), 1e-6)

    @property
    def current_index(self) -> int:
        return self._index

    def update(self, snap: VehicleSnapshot) -> None:
        if self._completed:
            return
        n = len(self._route)
        hi = min(self._index + 50, n)
        window = self._route[self._index:hi]
        d = np.hypot(window[:, 0] - snap.pos[0], window[:, 1] - snap.pos[1])
        close = np.nonzero(d < self.DISTANCE_THRESHOLD)[0]
        if len(close):
            self._index += int(close[-1])
        self.actual_value = round(
            100.0 * self._cum[self._index] / self._total, 2)
        if self.actual_value >= self._terminate_pct:
            self._completed = True
            self.actual_value = 100.0
            self.test_status = "SUCCESS"
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.ROUTE_COMPLETED, "Route completed"))

    def terminate(self) -> None:
        if not self._completed:
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.ROUTE_COMPLETION, "Route incomplete",
                {"route_completed": self.actual_value}))


class InRouteCriterion(Criterion):
    """Route-deviation terminator (atomic_criteria.py:1599-1729): more than
    max_offroad meters from the nearest upcoming waypoint ->
    ROUTE_DEVIATION."""

    name = "InRouteTest"

    def __init__(self, route_xy: np.ndarray, completion: RouteCompletionCriterion,
                 max_offroad: float = 30.0):
        super().__init__()
        self._route = np.asarray(route_xy, np.float64)
        self._completion = completion
        self._max = max_offroad
        self._failed = False

    def update(self, snap: VehicleSnapshot) -> None:
        if self._failed:
            return
        i = self._completion.current_index
        window = self._route[i: i + 60]
        d = np.min(np.hypot(window[:, 0] - snap.pos[0],
                            window[:, 1] - snap.pos[1]))
        if d > self._max:
            self._failed = True
            self.test_status = "FAILURE"
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.ROUTE_DEVIATION,
                f"Agent deviated from the route at {snap.pos}"))


class CollisionCriterion(Criterion):
    """Collision events by actor class (atomic_criteria.py:282-441); each
    collision counts and fails the criterion."""

    name = "CollisionTest"

    def update(self, snap: VehicleSnapshot) -> None:
        if snap.collided_pedestrian:
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.COLLISION_PEDESTRIAN, "Collision: walker"))
        elif snap.collided_vehicle:
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.COLLISION_VEHICLE, "Collision: vehicle"))
        elif snap.collided_static:
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.COLLISION_STATIC, "Collision: static"))
        else:
            return
        self.actual_value += 1
        self.test_status = "FAILURE"


class OutsideRouteLanesCriterion(Criterion):
    """Off-driving-lane percentage tracker (atomic_criteria.py:1034+)."""

    name = "OutsideRouteLanesTest"

    def __init__(self):
        super().__init__()
        self._ticks = 0
        self._outside = 0

    def update(self, snap: VehicleSnapshot) -> None:
        self._ticks += 1
        if snap.off_lane:
            self._outside += 1
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION,
                "Outside route lanes",
                {"percentage": 100.0 * self._outside / self._ticks}))
            # any excursion fails the test (atomic_criteria.py:1150-1167)
            self.test_status = "FAILURE"
        self.actual_value = round(100.0 * self._outside
                                  / max(self._ticks, 1), 2)


class BlockedCriterion(Criterion):
    """ActorSpeedAboveThreshold (atomic_criteria.py:443-515): speed below
    0.1 m/s for `max_time` seconds -> VEHICLE_BLOCKED."""

    name = "AgentBlockedTest"

    def __init__(self, speed_threshold: float = 0.1,
                 max_time: float = 180.0, dt: float = 0.1):
        super().__init__()
        self._thr = speed_threshold
        self._max_ticks = int(max_time / dt)
        self._below = 0
        self._fired = False

    def update(self, snap: VehicleSnapshot) -> None:
        if self._fired:
            return
        if snap.speed < self._thr:
            self._below += 1
            if self._below >= self._max_ticks:
                self._fired = True
                self.test_status = "FAILURE"
                self.list_traffic_events.append(TrafficEvent(
                    TrafficEventType.VEHICLE_BLOCKED, "Agent blocked"))
        else:
            self._below = 0


class RouteTimeoutCriterion(Criterion):
    """Episode timeout scaled by route length (route_scenario.py:271-283):
    SECONDS_GIVEN_PER_METER * length + INITIAL_SECONDS; a ROUTE_COMPLETION
    (incomplete) event on expiry."""

    name = "RouteTimeoutTest"
    SECONDS_GIVEN_PER_METER = 0.8
    INITIAL_SECONDS = 5.0

    def __init__(self, route_length_m: float, dt: float = 0.1):
        super().__init__()
        self.timeout_s = (self.SECONDS_GIVEN_PER_METER * route_length_m
                          + self.INITIAL_SECONDS)
        self._max_ticks = int(self.timeout_s / dt)
        self._ticks = 0
        self._fired = False

    def update(self, snap: VehicleSnapshot) -> None:
        if self._fired:
            return
        self._ticks += 1
        if self._ticks >= self._max_ticks:
            self._fired = True
            self.test_status = "FAILURE"
            self.list_traffic_events.append(TrafficEvent(
                TrafficEventType.ROUTE_COMPLETION, "Route timeout"))


def default_criteria(route_xy: np.ndarray, dt: float = 0.1,
                     blocked_seconds: float = 180.0,
                     with_timeout: bool = True,
                     lights=None, stop_signs=None,
                     veh_extent: float = 2.45) -> List[Criterion]:
    """The criterion set of RouteScenario._create_test_criteria plus the
    route-length-scaled timeout; the red-light and stop tests run over the
    episode's TrafficLightInfo / StopSignInfo lists."""
    from cadre_tpu_torch.envs.traffic_lights import (
        RunningRedLightCriterion,
        RunningStopCriterion,
    )

    completion = RouteCompletionCriterion(route_xy)
    seg = np.diff(np.asarray(route_xy, np.float64), axis=0)
    length_m = float(np.hypot(seg[:, 0], seg[:, 1]).sum()) if len(seg) else 0.0
    crits: List[Criterion] = [
        completion,
        OutsideRouteLanesCriterion(),
        CollisionCriterion(),
        RunningRedLightCriterion(lights or [], veh_extent=veh_extent),
        RunningStopCriterion(stop_signs or []),
        InRouteCriterion(route_xy, completion),
        BlockedCriterion(max_time=blocked_seconds, dt=dt),
    ]
    if with_timeout:
        crits.append(RouteTimeoutCriterion(length_m, dt=dt))
    return crits
