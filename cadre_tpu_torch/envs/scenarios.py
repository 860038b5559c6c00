"""Trigger-driven adversarial scenario behaviours for the host simulator.

numpy copy of the JAX package's scenario runtime. The reference
instantiates Scenario1-10 py_trees behaviours at route trigger points
(route_scenario.py:55-66,368-435; srunner/scenarios/*): ControlLoss,
FollowLeadingVehicle, DynamicObjectCrossing, VehicleTurningRoute,
OtherLeadingVehicle, ManeuverOppositeDirection, Signal/NoSignalJunction
crossings. Here each is a small tick-driven state machine acting on the
kinematic sim: spawning or steering obstacle actors, or perturbing the ego
controls, when the ego reaches the trigger. The atomic behaviours, the
trigger conditions and the Sequence / Parallel composition follow
srunner's scenarioatomics. Every random draw comes from the rng the
manager is given (the env's own), in the JAX package's order, so the same
seed gives the same episodes.

The JSON trigger format is route_parser.parse_scenario_file's.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from cadre_tpu_torch.envs.route_fig import (
    outside_route_lanes,
    signed_route_lateral,
)
from cadre_tpu_torch.envs.synthetic import _route_corners
from cadre_tpu_torch.envs.traffic_lights import (
    GREEN,
    RED,
    annotate_light_group,
    force_actor_state,
    reset_lights,
    update_light_states,
)

TRIGGER_RADIUS = 12.0

# scenario-type -> behavior key (NUMBER_CLASS_TRANSLATION,
# route_scenario.py:55-66). Scenario7/8/9 share the SignalJunctionCrossing
# class in the reference but differ by subtype: the conflicting direction
# whose light is forced green (TrafficLightManipulator
# SUBTYPE_CONFIG_TRANSLATION, atomic_behaviors.py:2084-2090).
SCENARIO_BEHAVIORS = {
    "Scenario1": "control_loss",
    "Scenario2": "follow_leading_vehicle",
    "Scenario3": "dynamic_object_crossing",
    "Scenario4": "vehicle_turning_route",
    "Scenario5": "other_leading_vehicle",
    "Scenario6": "maneuver_opposite_direction",
    "Scenario7": "signal_junction_left",
    "Scenario8": "signal_junction_opposite",
    "Scenario9": "signal_junction_right",
    "Scenario10": "no_signal_junction_crossing",
}


@dataclasses.dataclass
class ScenarioTrigger:
    """Fires when the ego reaches `pos` (distance trigger) or at sim tick
    `at_tick` (time trigger, OpenSCENARIO SimulationTimeCondition). `builder`
    overrides the registry lookup with a custom behavior factory."""

    kind: str
    pos: Optional[np.ndarray] = None
    fired: bool = False
    at_tick: Optional[int] = None
    builder: Optional[Any] = None
    radius: float = TRIGGER_RADIUS   # per-trigger distance tolerance


class ScenarioBehavior:
    """Active behavior; `tick(env)` returns False when finished."""

    def tick(self, env) -> bool:  # pragma: no cover
        raise NotImplementedError


class OwnedActorBehavior(ScenarioBehavior):
    """Base for atomic behaviors that integrate a shared actor handle.

    Last writer wins: taking ownership marks the actor managed and records
    this behavior as its owner; a behavior that has lost ownership (another
    behavior took the actor over, e.g. a storyboard SpeedAction retargeting
    an init-speed entity) finishes on its next tick instead of
    double-advancing the actor.
    """

    def _own(self, ob) -> None:
        self._ob = ob
        ob.managed = True
        ob._owner = self

    def _owned(self) -> bool:
        return getattr(self._ob, "_owner", self) is self

    def _release(self) -> None:
        """Hand the actor back to the env's integrator on finish: a
        released actor with a velocity keeps moving (CARLA actors persist
        after their behavior subtree completes) instead of freezing
        managed-but-ownerless."""
        if getattr(self._ob, "_owner", None) is self:
            self._ob._owner = None
            self._ob.managed = False

    def tick(self, env) -> bool:
        if not self._owned():
            return False
        alive = self._tick_owned(env)
        if not alive:
            self._release()
        return alive

    def _tick_owned(self, env) -> bool:  # pragma: no cover
        raise NotImplementedError


class ControlLossBehavior(ScenarioBehavior):
    """Scenario1: inject steering noise pulses (control_loss.py)."""

    def __init__(self, rng: np.random.RandomState, duration: int = 25):
        self._rng = rng
        self._remaining = duration

    def tick(self, env) -> bool:
        env._control_noise = float(self._rng.uniform(-0.25, 0.25))
        self._remaining -= 1
        if self._remaining <= 0:
            env._control_noise = 0.0
            return False
        return True


class LeadingVehicleBehavior(OwnedActorBehavior):
    """Scenario2/5: slow vehicle ahead following the route."""

    def __init__(self, env, speed: float = 3.0, gap: float = 15.0):
        route = env._route_xy
        # place the leader `gap` meters ahead of the ego along the route
        d = np.hypot(route[:, 0] - env._pos[0], route[:, 1] - env._pos[1])
        i0 = int(np.argmin(d))
        idx = min(i0 + int(gap), len(route) - 1)
        self._own(env.spawn_scenario_actor("vehicle", route[idx],
                                           speed=speed))
        self._route = route
        self._i = idx

    def _tick_owned(self, env) -> bool:
        # advance along the route at the behavior speed
        if self._i >= len(self._route) - 1:
            return False
        step = self._ob.speed * env.dt
        nxt = self._route[min(self._i + 1, len(self._route) - 1)]
        d = nxt - self._ob.pos
        dist = float(np.hypot(*d))
        if dist < step:
            self._i += 1
        else:
            self._ob.pos = self._ob.pos + d / max(dist, 1e-6) * step
        return True


class CrossingBehavior(OwnedActorBehavior):
    """Scenario3: object crosses the route ahead of the ego
    (object_crash_vehicle.py DynamicObjectCrossing). The adversary is a
    jaywalker (adversary_type False, :211-215) or a cyclist
    (adversary_type True, :216-219 — a small vehicle blueprint); a static
    vision-blocker prop is placed between the ego's sight line and the
    crossing point (:228-248, 'static.prop.vendingmachine')."""

    def __init__(self, env, kind: str = "walker", ahead: float = 12.0,
                 lateral: float = 8.0, speed: float = 1.6):
        yaw = math.radians(env._yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        start = env._pos + fwd * ahead + left * lateral
        heading = math.atan2(-left[1], -left[0])
        if kind == "cyclist":
            # cyclist variant crosses faster (:216-218 target velocity)
            speed = max(speed, 2.5)
        self._own(env.spawn_scenario_actor(kind, start, heading=heading,
                                           speed=speed))
        # blocker prop hides the adversary until it steps onto the road;
        # unmanaged and static, it persists for the episode like the
        # reference's prop (removed only at scenario cleanup)
        env.spawn_scenario_actor(
            "static", env._pos + fwd * (ahead - 1.0) + left * (lateral - 2.0),
            heading=heading, speed=0.0)
        self._travel = 2 * lateral

    def _tick_owned(self, env) -> bool:
        step = self._ob.speed * env.dt
        self._ob.pos = self._ob.pos + step * np.array(
            [math.cos(self._ob.heading), math.sin(self._ob.heading)])
        self._travel -= step
        if self._travel <= 0:
            # crossing complete: the adversary stops at the far side (the
            # reference destroys it, object_crash_vehicle.py end behavior)
            self._ob.speed = 0.0
            return False
        return True


class OppositeVehicleBehavior(OwnedActorBehavior):
    """Scenario6/7-10: vehicle approaching against the ego's direction."""

    def __init__(self, env, ahead: float = 30.0, speed: float = 6.0,
                 lateral: float = 1.5):
        yaw = math.radians(env._yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        start = env._pos + fwd * ahead + left * lateral
        self._own(env.spawn_scenario_actor(
            "vehicle", start, heading=math.atan2(-fwd[1], -fwd[0]),
            speed=speed))
        self._life = int(2 * ahead / max(speed * env.dt, 1e-6))

    def _tick_owned(self, env) -> bool:
        step = self._ob.speed * env.dt
        self._ob.pos = self._ob.pos + step * np.array(
            [math.cos(self._ob.heading), math.sin(self._ob.heading)])
        self._life -= 1
        return self._life > 0


def _advance(ob, dt: float) -> None:
    ob.pos = ob.pos + ob.speed * dt * np.array(
        [math.cos(ob.heading), math.sin(ob.heading)])


class IdleBehavior(ScenarioBehavior):
    """Atomic Idle (atomic_behaviors.py): hold for N ticks, then finish."""

    def __init__(self, duration: int = 10):
        self._remaining = duration

    def tick(self, env) -> bool:
        self._remaining -= 1
        return self._remaining > 0


class KeepVelocityBehavior(OwnedActorBehavior):
    """Atomic KeepVelocity: drive an actor at a constant speed along its
    heading for a distance (or until the env episode ends)."""

    def __init__(self, ob, speed: float, distance: float = 50.0):
        self._own(ob)
        self._ob.speed = speed
        self._travel = distance

    def _tick_owned(self, env) -> bool:
        _advance(self._ob, env.dt)
        self._travel -= self._ob.speed * env.dt
        return self._travel > 0


class LaneChangeBehavior(OwnedActorBehavior):
    """Atomic LaneChange: lateral shift of `offset` meters while holding
    forward speed (constant-rate blend over `duration` ticks)."""

    def __init__(self, ob, offset: float = 3.5, duration: int = 20):
        self._own(ob)
        self._rate = offset / max(duration, 1)
        self._remaining = duration
        # lateral direction: left of the actor's heading
        self._left = np.array([-math.sin(ob.heading), math.cos(ob.heading)])

    def _tick_owned(self, env) -> bool:
        _advance(self._ob, env.dt)
        self._ob.pos = self._ob.pos + self._left * self._rate
        self._remaining -= 1
        return self._remaining > 0


class AccelerateToCatchUpBehavior(OwnedActorBehavior):
    """Atomic AccelerateToCatchUp: ramp the actor's speed by `throttle_inc`
    per tick until it is `trigger_gap` meters past the ego, then finish."""

    def __init__(self, ob, max_speed: float = 12.0,
                 throttle_inc: float = 0.5, trigger_gap: float = 8.0):
        self._own(ob)
        self._max = max_speed
        self._inc = throttle_inc
        self._gap = trigger_gap

    def _tick_owned(self, env) -> bool:
        self._ob.speed = min(self._max, self._ob.speed + self._inc)
        _advance(self._ob, env.dt)
        fwd = np.array([math.cos(math.radians(env._yaw)),
                        math.sin(math.radians(env._yaw))])
        ahead = float(np.dot(self._ob.pos - env._pos, fwd))
        return ahead < self._gap


class SyncArrivalBehavior(OwnedActorBehavior):
    """Atomic SyncArrival: continuously re-solve the actor's speed so it
    reaches `target` at the same time the ego does (the junction-crossing
    conflict generator)."""

    def __init__(self, ob, target: np.ndarray, max_speed: float = 15.0):
        self._own(ob)
        self._target = np.asarray(target, float)
        self._max = max_speed
        d = self._target - ob.pos
        self._ob.heading = math.atan2(d[1], d[0])

    def _tick_owned(self, env) -> bool:
        d_actor = float(np.hypot(*(self._target - self._ob.pos)))
        if d_actor < 1.0:
            return False
        d_ego = float(np.hypot(*(self._target - env._pos)))
        ego_speed = max(float(getattr(env, "_speed", 1.0)), 0.5)
        eta_ego = d_ego / ego_speed
        self._ob.speed = float(np.clip(d_actor / max(eta_ego, env.dt),
                                       0.0, self._max))
        _advance(self._ob, env.dt)
        return True


class WaypointFollowerBehavior(OwnedActorBehavior):
    """Atomic WaypointFollower (atomic_behaviors.py): drive an actor along a
    polyline at a target speed; finishes at the last waypoint."""

    def __init__(self, ob, waypoints: np.ndarray, speed: float = 5.0):
        self._own(ob)
        self._ob.speed = speed
        self._wps = np.asarray(waypoints, float)
        self._i = 0

    def _tick_owned(self, env) -> bool:
        if self._i >= len(self._wps):
            return False
        step = self._ob.speed * env.dt
        while self._i < len(self._wps):
            d = self._wps[self._i] - self._ob.pos
            dist = float(np.hypot(*d))
            if dist > max(step, 1e-6):
                self._ob.heading = math.atan2(d[1], d[0])
                self._ob.pos = self._ob.pos + d / dist * step
                return True
            self._i += 1
        return False


class ChangeAutoPilotBehavior(ScenarioBehavior):
    """Atomic ChangeAutoPilot: hand an actor to the traffic manager with a
    target speed (atomic_behaviors.py ChangeAutoPilot + TM params). For
    CARLA-backed handles this enables server autopilot; for sim obstacles it
    releases the actor to the env integrator at the given speed."""

    def __init__(self, ob, speed: float = 5.0, enable: bool = True):
        self._ob = ob
        actor = getattr(ob, "actor", None)
        if actor is not None:
            try:
                actor.set_autopilot(enable)
            except RuntimeError:
                pass
        ob.speed = speed
        ob.managed = not enable   # autopilot actors integrate themselves

    def tick(self, env) -> bool:
        return False              # one-shot


class VehicleTurningBehavior(OwnedActorBehavior):
    """Scenario4 VehicleTurningRoute (object_crash_intersection.py): a
    vehicle/cyclist waiting at the junction corner turns into the ego's lane
    and crosses it — a pursuit arc onto a point on the route ahead, then
    away across the far side."""

    def __init__(self, env, ahead: float = 14.0, lateral: float = 7.0,
                 speed: float = 4.0):
        yaw = math.radians(env._yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        start = env._pos + fwd * ahead + left * lateral
        # the turning crosser is a cyclist (object_crash_intersection.py:689
        # 'vehicle.diamondback.century')
        ob = env.spawn_scenario_actor(
            "cyclist", start, heading=math.atan2(-left[1], -left[0]),
            speed=speed)
        self._own(ob)
        # two-leg arc: onto the ego lane ahead of the trigger, then across
        self._targets = [env._pos + fwd * (ahead + 4.0),
                         env._pos + fwd * (ahead + 4.0) - left * lateral]
        self._leg = 0

    def _tick_owned(self, env) -> bool:
        while self._leg < len(self._targets):
            d = self._targets[self._leg] - self._ob.pos
            dist = float(np.hypot(*d))
            step = self._ob.speed * env.dt
            if dist > max(step, 1e-6):
                self._ob.heading = math.atan2(d[1], d[0])
                _advance(self._ob, env.dt)
                return True
            self._leg += 1
        return False


class SignalJunctionBehavior(ScenarioBehavior):
    """Scenario7/8/9 semantics: the TrafficLightManipulator two-phase light
    hack (atomic_behaviors.py:2046-2096) + a conflicting vehicle.

    Phase 1 forces the ego's junction light red and the conflicting
    direction's green; a vehicle from that direction crosses the junction
    (sync-arrival on the junction center, standing in for the reference's
    background traffic "running" the hacked green). After RED_TIME the ego
    group also goes green (INT_CONF_*2); after RESET_TIME the junction is
    restored.
    """

    RED_TIME = 1.5       # seconds the ego waits at red
    RESET_TIME = 6.0     # seconds before the junction is restored

    def __init__(self, env, direction: str = "left",
                 approach: float = 22.0, speed: float = 7.0):
        self._direction = direction
        yaw = math.radians(env._yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])

        # use lights in the same frame as env._pos/_yaw: sim lights live in
        # world space already; CarlaDrivingEnv keeps a world-frame twin of
        # its (GPS-plane) criteria records for exactly this purpose
        lights = list(getattr(env, "_lights", None)
                      or getattr(env, "_light_infos_world", None)
                      or [])
        self._ego_light = None
        self._ann = None
        self._params = []
        if lights:
            ahead = [(float(np.hypot(*(tl.center - env._pos))), tl)
                     for tl in lights
                     if float((tl.center - env._pos) @ fwd) > 0]
            ahead = [x for x in ahead if x[0] < 60.0]
            if ahead:
                # key= keeps ties from falling through to TrafficLightInfo
                # dataclass __eq__ (ndarray fields -> ambiguous truth value)
                self._ego_light = min(ahead, key=lambda x: x[0])[1]
                group = [tl for tl in lights if float(np.hypot(
                    *(tl.center - self._ego_light.center))) < 40.0]
                self._ann = annotate_light_group(self._ego_light, group)
                # INT_CONF phase 1: ego red, conflicting direction green
                self._params = update_light_states(
                    self._ego_light, self._ann,
                    {"ego": RED, direction: GREEN}, freeze=True)

        # junction center: past the ego light's stop line, else ahead
        if self._ego_light is not None and self._ego_light.stop_lines:
            sl = self._ego_light.stop_lines[0]
            junction = sl.pos + sl.dir * 10.0
        else:
            junction = env._pos + fwd * approach
        side = {"left": left, "right": -left, "opposite": fwd}[direction]
        start = junction + side * 25.0
        ob = env.spawn_scenario_actor(
            "vehicle", start, heading=math.atan2(*(-side)[::-1]),
            speed=speed)
        self._inner = SyncArrivalBehavior(ob, target=junction,
                                          max_speed=max(speed * 2, 10.0))
        self._t = 0

    def tick(self, env) -> bool:
        self._t += 1
        if self._inner is not None and not self._inner.tick(env):
            self._inner = None
        if self._ego_light is not None:
            if self._t == int(self.RED_TIME / env.dt):
                # INT_CONF phase 2: ego group green as well
                update_light_states(self._ego_light, self._ann,
                                    {"ego": GREEN, self._direction: GREEN},
                                    freeze=True)
            if self._t >= int(self.RESET_TIME / env.dt):
                reset_lights(self._params)
                self._ego_light = None
        return self._inner is not None or self._ego_light is not None


class NoSignalJunctionBehavior(ScenarioBehavior):
    """Scenario10 NoSignalJunctionCrossingRoute: an unsignalized conflict —
    a vehicle sync-arrives at the junction center exactly when the ego does
    (no_signal_junction_crossing.py uses SyncArrival the same way)."""

    def __init__(self, env, approach: float = 20.0, speed: float = 7.0):
        yaw = math.radians(env._yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        junction = env._pos + fwd * approach
        start = junction + left * 22.0
        ob = env.spawn_scenario_actor(
            "vehicle", start, heading=math.atan2(*(-left)[::-1]),
            speed=speed)
        self._inner = SyncArrivalBehavior(ob, target=junction,
                                          max_speed=max(speed * 2, 12.0))

    def tick(self, env) -> bool:
        return self._inner.tick(env)


class WeatherBehavior(ScenarioBehavior):
    """In-episode sun animation (srunner/scenariomanager/weather_sim.py
    Weather + WeatherBehavior): the sun's altitude advances with sim time
    and the world's lighting follows. The reference computes the true
    astronomic position with ephem and writes carla.WeatherParameters; the
    sim renderer needs only the altitude profile — it exposes
    `env._sun_altitude` (degrees), which scales scene brightness via
    sin(altitude) clamped at a twilight floor.
    """

    def __init__(self, sun_altitude_deg: float = 70.0,
                 degrees_per_minute: float = 30.0):
        self._alt = sun_altitude_deg
        self._rate = degrees_per_minute / 60.0   # deg per sim second

    def tick(self, env) -> bool:
        self._alt -= self._rate * env.dt
        env._sun_altitude = self._alt
        return True                              # runs all episode


class AccelerateToVelocityBehavior(OwnedActorBehavior):
    """Atomic AccelerateToVelocity (atomic_behaviors.py:862-913): ramp the
    actor's speed by `throttle_inc` per tick until `target_velocity`."""

    def __init__(self, ob, target_velocity: float, throttle_inc: float = 0.4):
        self._own(ob)
        self._target = target_velocity
        self._inc = throttle_inc

    def _tick_owned(self, env) -> bool:
        self._ob.speed = min(self._target, self._ob.speed + self._inc)
        _advance(self._ob, env.dt)
        return self._ob.speed < self._target


class StopVehicleBehavior(OwnedActorBehavior):
    """Atomic StopVehicle (atomic_behaviors.py:1147-1191): full brake until
    the actor stands still."""

    def __init__(self, ob, brake_decel: float = 6.0):
        self._own(ob)
        self._decel = brake_decel

    def _tick_owned(self, env) -> bool:
        self._ob.speed = max(0.0, self._ob.speed - self._decel * env.dt)
        _advance(self._ob, env.dt)
        return self._ob.speed > 1e-3


class HandBrakeVehicleBehavior(ScenarioBehavior):
    """Atomic HandBrakeVehicle (atomic_behaviors.py:1757-1795): lock the
    actor in place for `duration` ticks (hand-brake on then off)."""

    def __init__(self, ob, duration: int = 10):
        self._ob = ob
        self._saved_speed = ob.speed
        ob.speed = 0.0
        ob.managed = True
        self._remaining = duration

    def tick(self, env) -> bool:
        self._remaining -= 1
        if self._remaining <= 0:
            self._ob.speed = self._saved_speed
            # managed reflects CURRENT ownership truth, not the pre-brake
            # value: another behavior may still own (and advance) the actor,
            # and forcing managed=False would re-enable the env integrator
            # on top of it (the double-advance bug the flag exists to stop)
            self._ob.managed = getattr(self._ob, "_owner", None) is not None
            return False
        return True


class SetInitSpeedBehavior(ScenarioBehavior):
    """Atomic SetInitSpeed (atomic_behaviors.py:1723-1756): one-shot initial
    velocity, actor then integrates itself (managed=False)."""

    def __init__(self, ob, speed: float):
        ob.speed = speed
        ob.managed = False

    def tick(self, env) -> bool:
        return False


class ActorTransformSetterBehavior(ScenarioBehavior):
    """Atomic ActorTransformSetter (atomic_behaviors.py:1824-1875): teleport
    the actor to a pose (one-shot)."""

    def __init__(self, ob, pos, heading: Optional[float] = None):
        ob.pos = np.asarray(pos, float).copy()
        if heading is not None:
            ob.heading = heading
        actor = getattr(ob, "actor", None)
        if actor is not None:
            try:
                tf = actor.get_transform()
                tf.location.x, tf.location.y = float(pos[0]), float(pos[1])
                if heading is not None:
                    tf.rotation.yaw = math.degrees(heading)
                actor.set_transform(tf)
            except RuntimeError:
                pass

    def tick(self, env) -> bool:
        return False


def _destroy_actor(env, ob) -> None:
    actor = getattr(ob, "actor", None)
    if actor is not None:
        try:
            actor.destroy()
        except RuntimeError:
            pass
    obstacles = getattr(env, "_obstacles", None)
    if obstacles is not None:
        # identity, not ==: SimObstacle holds numpy fields
        env._obstacles = [o for o in obstacles if o is not ob]


class ActorDestroyBehavior(ScenarioBehavior):
    """Atomic ActorDestroy (atomic_behaviors.py:1796-1823)."""

    def __init__(self, ob):
        self._ob = ob

    def tick(self, env) -> bool:
        _destroy_actor(env, self._ob)
        return False


class ActorSourceBehavior(ScenarioBehavior):
    """Atomic ActorSource (atomic_behaviors.py:1915-1971): spawn a steady
    flow of vehicles at a location (one every `interval` seconds) headed
    along `heading`, as long as the spawn point is clear."""

    def __init__(self, pos, heading: float, speed: float = 5.0,
                 interval: float = 4.0, kind: str = "vehicle"):
        self._pos = np.asarray(pos, float)
        self._heading = heading
        self._speed = speed
        self._interval = interval
        self._kind = kind
        self._t = 0.0
        self.spawned: List[Any] = []

    def tick(self, env) -> bool:
        self._t += env.dt
        if self._t >= self._interval:
            clear = all(float(np.hypot(*(ob.pos - self._pos))) > 4.0
                        for ob in getattr(env, "_obstacles", []))
            if clear:
                ob = env.spawn_scenario_actor(
                    self._kind, self._pos, heading=self._heading,
                    speed=self._speed)
                ob.managed = True     # the source drives its flow
                self.spawned.append(ob)
                self._t = 0.0
        alive = {id(o) for o in getattr(env, "_obstacles", [])}
        for ob in self.spawned:
            if id(ob) in alive:       # sink may have despawned it
                _advance(ob, env.dt)
        return True                   # runs all episode


class ActorSinkBehavior(ScenarioBehavior):
    """Atomic ActorSink (atomic_behaviors.py:1972-1998): despawn any actor
    entering `radius` of `pos` (the far end of an ActorSource flow)."""

    def __init__(self, pos, radius: float = 5.0):
        self._pos = np.asarray(pos, float)
        self._r = radius

    def tick(self, env) -> bool:
        for ob in list(getattr(env, "_obstacles", [])):
            if float(np.hypot(*(ob.pos - self._pos))) < self._r:
                _destroy_actor(env, ob)
        return True


class TrafficLightStateSetterBehavior(ScenarioBehavior):
    """Atomic TrafficLightStateSetter (atomic_behaviors.py:1876-1914): force
    one light to a state (frozen until reset_lights), pushing to the
    backing simulator light when one exists."""

    def __init__(self, light, state: str):
        light.frozen = state
        light.state = state
        force_actor_state(light, state, freeze=True)

    def tick(self, env) -> bool:
        return False


class AddNoiseToVehicleBehavior(ScenarioBehavior):
    """Atomic AddNoiseToVehicle (atomic_behaviors.py:1269-1306): constant
    steer/throttle offsets on the EGO controls for `duration` ticks (the
    ControlLoss building block; ChangeNoiseParameters re-targets it)."""

    def __init__(self, steer_noise: float = 0.1, throttle_noise: float = 0.0,
                 duration: int = 20):
        self._steer = steer_noise
        self._throttle = throttle_noise
        self._remaining = duration

    def set_parameters(self, steer_noise: float, throttle_noise: float,
                       duration: Optional[int] = None) -> None:
        """ChangeNoiseParameters (atomic_behaviors.py:1307-1345)."""
        self._steer = steer_noise
        self._throttle = throttle_noise
        if duration is not None:
            self._remaining = duration

    def tick(self, env) -> bool:
        env._control_noise = self._steer
        env._throttle_noise = self._throttle
        self._remaining -= 1
        if self._remaining <= 0:
            env._control_noise = 0.0
            env._throttle_noise = 0.0
            return False
        return True


class BasicAgentBehavior(OwnedActorBehavior):
    """Atomic BasicAgentBehavior (atomic_behaviors.py:1346-1393): drive the
    actor toward a target location at a target speed (the CARLA BasicAgent
    reduced to a single-goal pursuit), finishing on arrival."""

    def __init__(self, ob, target, speed: float = 5.0):
        self._own(ob)
        self._ob.speed = speed
        self._target = np.asarray(target, float)

    def _tick_owned(self, env) -> bool:
        d = self._target - self._ob.pos
        dist = float(np.hypot(*d))
        if dist < 1.0:
            return False
        self._ob.heading = math.atan2(d[1], d[0])
        _advance(self._ob, env.dt)
        return True


# ---------------- trigger conditions + composition ----------------
# (srunner/scenariomanager/scenarioatomics/atomic_trigger_conditions.py)


class Condition:
    """Trigger condition: `__call__(env) -> bool` (True = satisfied)."""

    def __call__(self, env) -> bool:  # pragma: no cover
        raise NotImplementedError


class InTriggerDistanceToVehicle(Condition):
    """True when two actors are within `distance` of each other
    (atomic_trigger_conditions.py InTriggerDistanceToVehicle)."""

    def __init__(self, ob, other, distance: float):
        self._a, self._b, self._d = ob, other, distance

    def __call__(self, env) -> bool:
        pa = env._pos if self._a == "ego" else self._a.pos
        pb = env._pos if self._b == "ego" else self._b.pos
        return float(np.hypot(*(pa - pb))) < self._d


class InTriggerDistanceToLocation(Condition):
    def __init__(self, ob, target, distance: float):
        self._ob, self._t, self._d = ob, np.asarray(target, float), distance

    def __call__(self, env) -> bool:
        p = env._pos if self._ob == "ego" else self._ob.pos
        return float(np.hypot(*(p - self._t))) < self._d


class DriveDistance(Condition):
    """True once the actor has driven `distance` meters since arming
    (atomic_trigger_conditions.py DriveDistance)."""

    def __init__(self, ob, distance: float):
        self._ob, self._d = ob, distance
        self._last = None
        self._driven = 0.0

    def __call__(self, env) -> bool:
        p = np.array(env._pos if self._ob == "ego" else self._ob.pos, float)
        if self._last is not None:
            self._driven += float(np.hypot(*(p - self._last)))
        self._last = p
        return self._driven >= self._d


class StandStill(Condition):
    """True once the actor has been still for `duration` seconds."""

    def __init__(self, ob, duration: float, speed_threshold: float = 0.1):
        self._ob, self._dur, self._thr = ob, duration, speed_threshold
        self._ticks = 0

    def __call__(self, env) -> bool:
        speed = env._speed if self._ob == "ego" else self._ob.speed
        self._ticks = self._ticks + 1 if speed < self._thr else 0
        return self._ticks * env.dt >= self._dur


class WaitEndIntersection(Condition):
    """True after the ego has entered and then left the junction region
    (atomic_trigger_conditions.py WaitEndIntersection). Junction = within
    `radius` of `junction_pos`."""

    def __init__(self, junction_pos, radius: float = 12.0):
        self._j = np.asarray(junction_pos, float)
        self._r = radius
        self._entered = False

    def __call__(self, env) -> bool:
        inside = float(np.hypot(*(env._pos - self._j))) < self._r
        if inside:
            self._entered = True
        return self._entered and not inside


class AtRightmostLane(Condition):
    """True when the actor drives the rightmost DRIVING lane: its right
    neighbor lane exists and is not of Driving type
    (atomic_trigger_conditions.py:1253-1291 — note the reference stays
    RUNNING when get_right_lane() returns None, mirrored here)."""

    def __init__(self, ob, carla_map):
        self._ob, self._map = ob, carla_map

    def __call__(self, env) -> bool:
        p = env._pos if self._ob == "ego" else self._ob.pos
        loc = type("L", (), dict(x=float(p[0]), y=float(p[1]), z=0.0))()
        wp = self._map.get_waypoint(loc)
        if wp is None:
            return False
        right = getattr(wp, "get_right_lane", lambda: None)()
        if right is None:
            return False
        return getattr(right, "lane_type", "Driving") != "Driving"


class TriggerVelocity(Condition):
    """True once the actor's speed exceeds `target_velocity`
    (atomic_trigger_conditions.py:513-555)."""

    def __init__(self, ob, target_velocity: float):
        self._ob, self._v = ob, target_velocity

    def __call__(self, env) -> bool:
        speed = env._speed if self._ob == "ego" else self._ob.speed
        return speed > self._v


def _actor_pos(env, ob) -> np.ndarray:
    return env._pos if ob == "ego" else ob.pos


def _actor_speed(env, ob) -> float:
    return float(env._speed if ob == "ego" else ob.speed)


class InTimeToArrivalToLocation(Condition):
    """True when the actor's ETA to `target` drops below `time` seconds
    (atomic_trigger_conditions.py:930-983)."""

    def __init__(self, ob, target, time: float):
        self._ob, self._t = ob, np.asarray(target, float)
        self._time = time

    def __call__(self, env) -> bool:
        d = float(np.hypot(*(self._t - _actor_pos(env, self._ob))))
        v = _actor_speed(env, self._ob)
        if v < 1e-3:
            return d < 0.5
        return d / v < self._time


class InTimeToArrivalToVehicle(Condition):
    """True when the closing-time between two actors drops below `time`
    (atomic_trigger_conditions.py:984-1058)."""

    def __init__(self, ob, other, time: float):
        self._a, self._b, self._time = ob, other, time

    def __call__(self, env) -> bool:
        d = float(np.hypot(*(_actor_pos(env, self._a)
                             - _actor_pos(env, self._b))))
        v = _actor_speed(env, self._a) + _actor_speed(env, self._b)
        if v < 1e-3:
            return d < 0.5
        return d / v < self._time


class InTriggerRegion(Condition):
    """True while the actor is inside the axis-aligned box
    (atomic_trigger_conditions.py:695-740)."""

    def __init__(self, ob, min_x: float, max_x: float, min_y: float,
                 max_y: float):
        self._ob = ob
        self._box = (min_x, max_x, min_y, max_y)

    def __call__(self, env) -> bool:
        p = _actor_pos(env, self._ob)
        x0, x1, y0, y1 = self._box
        return x0 <= p[0] <= x1 and y0 <= p[1] <= y1


class RelativeVelocityToOtherActor(Condition):
    """True once speed(a) - speed(b) exceeds `value`
    (atomic_trigger_conditions.py:464-512)."""

    def __init__(self, ob, other, value: float):
        self._a, self._b, self._v = ob, other, value

    def __call__(self, env) -> bool:
        return (_actor_speed(env, self._a)
                - _actor_speed(env, self._b)) > self._v


class WaitForTrafficLightState(Condition):
    """True once the light reaches `state`
    (atomic_trigger_conditions.py:1294-1331). Reads the frozen state or the
    sim light cycle via the env clock."""

    def __init__(self, light, state: str):
        self._light, self._state = light, state

    def __call__(self, env) -> bool:
        t = getattr(env, "_step_count", 0) * env.dt
        return self._light.state_at(t) == self._state


class WalkerCollision(Condition):
    """True when any background VEHICLE (not the ego, not the walker
    itself) comes within 2 m of the walker
    (atomic_trigger_conditions.py:280-322)."""

    def __init__(self, ob):
        self._ob = ob

    def __call__(self, env) -> bool:
        for other in getattr(env, "_obstacles", []):
            if other is self._ob or other.kind == "walker":
                continue
            if float(np.hypot(*(other.pos - self._ob.pos))) < 2.0:
                return True
        return False


class HasBeenOccupied(Condition):
    """True when any other actor (ego excluded) sits within 5 m of the
    actor's location (atomic_trigger_conditions.py:359-409)."""

    def __init__(self, ob):
        self._ob = ob

    def __call__(self, env) -> bool:
        for other in getattr(env, "_obstacles", []):
            if other is self._ob:
                continue
            if float(np.hypot(*(other.pos - self._ob.pos))) < 5.0:
                return True
        return False


class TooFarAway(Condition):
    """True once the actor is more than `distance` m from the ego
    (atomic_trigger_conditions.py:410-463; reference threshold 20 m)."""

    def __init__(self, ob, distance: float = 20.0):
        self._ob, self._d = ob, distance

    def __call__(self, env) -> bool:
        return float(np.hypot(*(env._pos - self._ob.pos))) > self._d


class Rectify(Condition):
    """One-shot status-message setter that immediately succeeds
    (atomic_trigger_conditions.py:323-358 — the reference uses it to
    surface a message through a shared status list)."""

    def __init__(self, status_list, message: str):
        self._list, self._msg = status_list, message

    def __call__(self, env) -> bool:
        self._list[0] = self._msg
        return True


class TriggerAcceleration(Condition):
    """True once |dv/dt| crosses `target` m/s^2
    (atomic_trigger_conditions.py:556-601; the reference reads the carla
    actor's acceleration vector — the host twin differentiates speed)."""

    def __init__(self, ob, target: float):
        self._ob, self._target = ob, target
        self._prev = None

    def __call__(self, env) -> bool:
        v = _actor_speed(env, self._ob)
        accel = 0.0 if self._prev is None else abs(v - self._prev) / env.dt
        self._prev = v
        return accel > self._target


class TimeOfDayComparison(Condition):
    """True once the sim clock passes `elapsed` seconds — the analog of the
    reference's blackboard-Datetime comparison maintained by
    WeatherBehavior (atomic_trigger_conditions.py:602-646)."""

    def __init__(self, elapsed: float):
        self._elapsed = elapsed

    def __call__(self, env) -> bool:
        return getattr(env, "_step_count", 0) * env.dt > self._elapsed


class InTriggerDistanceToNextIntersection(Condition):
    """True within `distance` m of the next route corner — the synthetic
    analog of walking map waypoints to the next junction
    (atomic_trigger_conditions.py:838-883)."""

    def __init__(self, ob, distance: float):
        self._ob, self._d = ob, distance
        self._corners = None

    def __call__(self, env) -> bool:
        if self._corners is None:
            self._corners = _route_corners(np.asarray(env._route_xy))
        p = _actor_pos(env, self._ob)
        if not len(self._corners):
            return False
        return float(np.hypot(*(self._corners - p).T).min()) < self._d


class InTriggerDistanceToLocationAlongRoute(Condition):
    """True when the actor is within `distance` BEFORE `location` measured
    along the route arc (atomic_trigger_conditions.py:884-929)."""

    def __init__(self, ob, location, distance: float):
        self._ob = ob
        self._loc = np.asarray(location, float)
        self._d = distance
        self._loc_s = None

    @staticmethod
    def _arc_s(dense: np.ndarray, p: np.ndarray) -> float:
        return float(np.argmin(np.hypot(*(dense - p).T)))  # 1 m spacing

    def __call__(self, env) -> bool:
        dense = np.asarray(env._route_xy)
        if self._loc_s is None:
            self._loc_s = self._arc_s(dense, self._loc)
        p = _actor_pos(env, self._ob)
        if float(np.hypot(*(p - self._loc))) >= self._d + 20.0:
            return False
        actor_s = self._arc_s(dense, p)
        return (actor_s < self._loc_s < actor_s + self._d) \
            or self._loc_s < 1.0


class WaitUntilInFront(Condition):
    """True once the actor has passed `other` (projection on other's
    heading positive at a bumper-length lookahead) and is within 10 m
    (atomic_trigger_conditions.py:1131-1206)."""

    def __init__(self, ob, other, factor: float = 1.0,
                 check_distance: bool = True):
        self._ob, self._other = ob, other
        self._len = max(1e-6, factor) * (2.45 + 2.45)
        self._check = check_distance

    def __call__(self, env) -> bool:
        p = _actor_pos(env, self._ob)
        op = _actor_pos(env, self._other)
        h = getattr(self._other, "heading", 0.0) if self._other != "ego" \
            else math.radians(env._yaw)
        d = np.asarray([math.cos(h), math.sin(h)])
        ahead = op + self._len * d
        in_front = float((p - ahead) @ d) > 0.0
        close = (not self._check) or float(np.hypot(*(p - ahead))) < 10.0
        return in_front and close


class InTimeToArrivalToVehicleSideLane(Condition):
    """ETA to the point one lane LEFT/RIGHT of `other` below `time` —
    the cut-in trigger (atomic_trigger_conditions.py:1059-1130)."""

    def __init__(self, ob, other, time: float, side_lane: str,
                 lane_width: float = 3.5):
        if side_lane not in ("left", "right"):
            raise ValueError("side_lane must be 'left' or 'right'")
        self._ob, self._other = ob, other
        self._time = time
        # reference quirk: cutting in from the RIGHT targets the other's
        # LEFT lane and vice versa
        self._sign = +1.0 if side_lane == "right" else -1.0
        self._w = lane_width

    def __call__(self, env) -> bool:
        op = _actor_pos(env, self._other)
        h = getattr(self._other, "heading", 0.0) if self._other != "ego" \
            else math.radians(env._yaw)
        left = np.asarray([-math.sin(h), math.cos(h)])
        target = op + self._sign * self._w * left
        d = float(np.hypot(*(target - _actor_pos(env, self._ob))))
        v = _actor_speed(env, self._ob)
        if v < 1e-3:
            return d < 0.5
        return d / v < self._time


class ElapsedSimTime(Condition):
    """True once the sim clock passes `seconds` (OpenSCENARIO
    SimulationTimeCondition used as an Act/Stop gate). Reads the env's
    step counter when it maintains one, else counts its own evaluation
    ticks from arming."""

    def __init__(self, seconds: float):
        self._t, self._n = seconds, 0

    def __call__(self, env) -> bool:
        self._n += 1
        steps = getattr(env, "_step_count", None)
        if steps is None:
            steps = self._n
        return steps * env.dt >= self._t


class TimeHeadway(Condition):
    """True when the gap to `other` divided by the actor's own speed drops
    below `value` seconds (atomic_trigger_conditions.py
    InTimeHeadwayToVehicle semantics of TimeHeadwayCondition:
    openscenario_parser.py:666-692)."""

    def __init__(self, ob, other, value: float):
        self._a, self._b, self._value = ob, other, value

    def __call__(self, env) -> bool:
        d = float(np.hypot(*(_actor_pos(env, self._a)
                             - _actor_pos(env, self._b))))
        v = _actor_speed(env, self._a)
        if v < 1e-3:
            return False
        return d / v < self._value


class CollisionCondition(Condition):
    """True when the actor's bounding circle touches `other`'s (or ANY
    other actor's when other is None) — openscenario_parser.py:627-659
    CollisionCondition over the collision criterion."""

    def __init__(self, ob, other: Any = None):
        self._ob, self._other = ob, other

    @staticmethod
    def _radius(ob) -> float:
        return float(getattr(ob, "radius", 1.2))

    def __call__(self, env) -> bool:
        pa = _actor_pos(env, self._ob)
        ra = 1.2 if self._ob == "ego" else self._radius(self._ob)
        if self._other is not None:
            pb = _actor_pos(env, self._other)
            rb = 1.2 if self._other == "ego" else self._radius(self._other)
            return float(np.hypot(*(pa - pb))) < ra + rb
        candidates: List[Any] = ["ego"] if self._ob != "ego" else []
        candidates += [o for o in getattr(env, "_obstacles", [])
                       if o is not self._ob]
        for other in candidates:
            pb = _actor_pos(env, other)
            rb = 1.2 if other == "ego" else self._radius(other)
            if float(np.hypot(*(pa - pb))) < ra + rb:
                return True
        return False


class Offroad(Condition):
    """True while the actor sits outside the two-lane road envelope around
    the env's dense route centerline (openscenario_parser.py:660-665
    OffroadCondition -> OffRoadTest; envelope = route_fig.OUT_LEFT/RIGHT,
    the same bounds the OutsideRouteLanes criterion uses)."""

    def __init__(self, ob):
        self._ob = ob

    def __call__(self, env) -> bool:
        route = getattr(env, "_route_xy", None)
        if route is None:
            return False
        return outside_route_lanes(
            signed_route_lateral(route, _actor_pos(env, self._ob)))


class RunScriptBehavior(ScenarioBehavior):
    """Atomic RunScript (atomic_behaviors.py:137-175): launch an external
    command, fire-and-forget. Intended for OpenSCENARIO
    CustomCommandAction; like the reference, the scenario file is trusted
    content — be aware of the security surface before loading foreign
    .xosc files."""

    def __init__(self, script: str, base_path: Optional[str] = None):
        self._script, self._base = script, base_path

    def tick(self, env) -> bool:
        import shlex
        import subprocess
        argv = shlex.split(self._script)
        if self._base and argv and not os.path.isabs(argv[-1]):
            candidate = os.path.join(self._base, argv[-1])
            if os.path.exists(candidate):
                argv[-1] = candidate
        subprocess.Popen(argv)
        return False


class WaitForBlackboardVariable(Condition):
    """True once `env.blackboard[name] == value` (the py_trees blackboard
    pattern scenarios use to sequence across parallel subtrees)."""

    def __init__(self, name: str, value: Any = True):
        self._name, self._value = name, value

    def __call__(self, env) -> bool:
        return getattr(env, "blackboard", {}).get(self._name) == self._value


class SetBlackboardVariableBehavior(ScenarioBehavior):
    """One-shot blackboard write (py_trees SetBlackboardVariable)."""

    def __init__(self, name: str, value: Any = True):
        self._name, self._value = name, value

    def tick(self, env) -> bool:
        if not hasattr(env, "blackboard"):
            env.blackboard = {}
        env.blackboard[self._name] = self._value
        return False


class StartRecorderBehavior(ScenarioBehavior):
    """Atomic StartRecorder (atomic_behaviors.py:1999-2025): start the
    CARLA server-side recorder through the env's client (no-op on envs
    without one)."""

    def __init__(self, recorder_name: str):
        self._name = recorder_name

    def tick(self, env) -> bool:
        client = getattr(env, "client", None)
        if client is not None and hasattr(client, "start_recorder"):
            client.start_recorder(self._name)
        return False


class StopRecorderBehavior(ScenarioBehavior):
    """Atomic StopRecorder (atomic_behaviors.py:2026-2045)."""

    def tick(self, env) -> bool:
        client = getattr(env, "client", None)
        if client is not None and hasattr(client, "stop_recorder"):
            client.stop_recorder()
        return False


class ConditionBehavior(ScenarioBehavior):
    """Adapter: a condition as a behavior that runs until satisfied (the
    py_trees pattern of putting trigger conditions inside sequences)."""

    def __init__(self, condition: Condition):
        self._cond = condition

    def tick(self, env) -> bool:
        return not self._cond(env)


class SequenceBehavior(ScenarioBehavior):
    """py_trees Sequence equivalent: run children in order, one at a time;
    finished when the last child finishes."""

    def __init__(self, children: Sequence[ScenarioBehavior]):
        self._children = list(children)

    def tick(self, env) -> bool:
        while self._children:
            if self._children[0].tick(env):
                return True
            self._children.pop(0)
        return False


class ParallelBehavior(ScenarioBehavior):
    """py_trees Parallel equivalent: tick all children every step.
    `success_on_one=True` finishes when ANY child finishes (the
    SUCCESS_ON_ONE policy the scenario behavior trees use); otherwise runs
    until all children finish (SUCCESS_ON_ALL)."""

    def __init__(self, children: Sequence[ScenarioBehavior],
                 success_on_one: bool = True):
        self._children = list(children)
        self._one = success_on_one

    def tick(self, env) -> bool:
        still = [c for c in self._children if c.tick(env)]
        finished_any = len(still) < len(self._children)
        self._children = still
        if self._one and finished_any:
            return False
        return bool(self._children)


_BEHAVIOR_BUILDERS = {
    "control_loss": lambda env, rng: ControlLossBehavior(rng),
    "follow_leading_vehicle": lambda env, rng: LeadingVehicleBehavior(env),
    "other_leading_vehicle": lambda env, rng: LeadingVehicleBehavior(
        env, speed=5.0, gap=25.0),
    "dynamic_object_crossing": lambda env, rng: CrossingBehavior(env),
    "vehicle_turning_route": lambda env, rng: VehicleTurningBehavior(env),
    "maneuver_opposite_direction": lambda env, rng: OppositeVehicleBehavior(
        env),
    "signal_junction_left": lambda env, rng: SignalJunctionBehavior(
        env, "left"),
    "signal_junction_opposite": lambda env, rng: SignalJunctionBehavior(
        env, "opposite"),
    "signal_junction_right": lambda env, rng: SignalJunctionBehavior(
        env, "right"),
    "no_signal_junction_crossing": lambda env, rng: NoSignalJunctionBehavior(
        env),
}


class ScenarioManager:
    """Holds triggers for one episode; fires behaviors as the ego arrives
    (the ScenarioTriggerer role, route_scenario.py:515-560)."""

    def __init__(self, triggers: Sequence[ScenarioTrigger],
                 rng: Optional[np.random.RandomState] = None):
        self.triggers = list(triggers)
        self.active: List[ScenarioBehavior] = []
        self._rng = rng or np.random.RandomState()

    @classmethod
    def from_annotations(cls, annotations: Sequence[Dict[str, Any]],
                         route_xy: np.ndarray, max_dist: float = 15.0,
                         rng: Optional[np.random.RandomState] = None,
                         sample: bool = False,
                         no_repeat: bool = False) -> "ScenarioManager":
        """Match scenario JSON trigger transforms to route waypoints
        (scan_route_for_scenarios role, route_scenario.py:235-243).

        `sample=True` keeps ONE candidate per trigger location, chosen at
        random (the `_scenario_sampling` role, route_scenario.py:315-366).
        `no_repeat=True` additionally instantiates each scenario kind at
        most once per episode (the no_repeat_route_scenario.py variant,
        which avoids spawning the same scenario class repeatedly).
        """
        rng = rng or np.random.RandomState()
        on_route = []
        for ann in annotations:
            kind = SCENARIO_BEHAVIORS.get(ann.get("type", ""))
            if kind is None:
                continue
            pos = np.array([ann["x"], ann["y"]])
            d = np.hypot(route_xy[:, 0] - pos[0], route_xy[:, 1] - pos[1])
            if d.min() <= max_dist:
                on_route.append((kind, pos))
        if sample:
            # cluster candidates that share a trigger location; keep one
            groups: List[List[tuple]] = []
            for kind, pos in on_route:
                for g in groups:
                    if float(np.hypot(*(g[0][1] - pos))) < 2.0:
                        g.append((kind, pos))
                        break
                else:
                    groups.append([(kind, pos)])
            on_route = [g[rng.randint(len(g))] for g in groups]
        triggers = []
        used_kinds = set()
        for kind, pos in on_route:
            if no_repeat and kind in used_kinds:
                continue
            used_kinds.add(kind)
            triggers.append(ScenarioTrigger(kind, pos))
        return cls(triggers, rng)

    def tick(self, env) -> None:
        self._ticks = getattr(self, "_ticks", 0) + 1
        for trig in self.triggers:
            if trig.fired:
                continue
            hit = (trig.at_tick is not None and self._ticks >= trig.at_tick) \
                or (trig.pos is not None and float(
                    np.hypot(*(trig.pos - env._pos))) < trig.radius)
            if hit:
                trig.fired = True
                builder = trig.builder or _BEHAVIOR_BUILDERS[trig.kind]
                self.active.append(builder(env, self._rng))
        self.active = [b for b in self.active if b.tick(env)]
