"""OpenSCENARIO actor-controller plugin layer (the port's copy of the JAX
package's host `envs/actor_controls.py`).

The reference realizes OSC controllers through
`srunner/scenariomanager/actorcontrols/` (~834 LoC): `BasicControl`
(basic_control.py:18-108) defines the controller protocol — target
speed, waypoint list, init-speed latch, reached-goal flag — and
`ActorControl` (actor_control.py:28-113) is the per-actor facade that
instantiates either a user controller loaded via importlib or a
kind-based default (walkers -> PedestrianControl, vehicles ->
NpcVehicleControl, else ExternalControl) and dedupes simultaneous
longitudinal/waypoint commands by timestamp. Five plugins implement the
protocol against live CARLA actors.

Here the same protocol drives the kinematic actor handles
(`sim_env.SimObstacle` and the CARLA actor adapters share pos / speed /
heading / kind), tick-driven with `run_step(env)` so controllers compose
with the scenario trigger/sequence machinery instead of py_trees: the
`ControlledActorBehavior` wrapper owns the actor through the scenarios
ownership protocol (last-writer-wins, scenarios.py::OwnedActorBehavior)
and advances the controller each env tick — the runtime role of the
reference's `UpdateAllActorControls` atomic (atomic_behaviors.py:323).
"""
from __future__ import annotations

import importlib
import math
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from cadre_tpu_torch.envs.scenarios import OwnedActorBehavior, ScenarioBehavior


def _unit(heading: float) -> np.ndarray:
    return np.array([math.cos(heading), math.sin(heading)])


def _truthy(v: Any) -> bool:
    """OSC property values arrive as strings ('true'/'1'); args built in
    python may be real bools/numbers (strtobool semantics,
    simple_vehicle_control.py:90)."""
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


class ActorController:
    """Controller protocol (basic_control.py:18-108).

    Subclasses implement `run_step(env)` to advance `self.ob` by one env
    tick and must set `self.reached_goal` when the waypoint plan is
    exhausted. `reset()` releases any per-controller resources.
    """

    def __init__(self, ob, args: Optional[Dict[str, Any]] = None):
        self.ob = ob
        self.args = dict(args or {})
        self.target_speed: float = float(self.args.get("target_speed", 0.0))
        self.waypoints: List[np.ndarray] = []
        self._waypoints_updated = False
        self.reached_goal = False
        self.init_speed = False

    # -- command surface (basic_control.py:55-88) --
    def update_target_speed(self, speed: float) -> None:
        self.target_speed = float(speed)
        self.init_speed = False

    def update_waypoints(self, waypoints: Sequence, start_time=None) -> None:
        self.waypoints = [np.asarray(w, float) for w in waypoints]
        self._waypoints_updated = True
        self.reached_goal = False

    def set_init_speed(self) -> None:
        self.init_speed = True

    def check_reached_waypoint_goal(self) -> bool:
        return self.reached_goal

    def reset(self) -> None:
        pass

    def run_step(self, env) -> None:  # pragma: no cover - protocol
        raise NotImplementedError

    # -- shared kinematics --
    def _follow_waypoints(self, env, speed: float,
                          max_yaw_rate: Optional[float] = None) -> None:
        """Advance toward the head of the waypoint list at `speed`,
        optionally limiting the per-tick heading change (the plugins'
        LocalPlanner-PID lateral behavior collapses to a yaw-rate limit
        on a kinematic handle). Empty plan => drive straight ahead
        (simple_vehicle_control.py run_step's no-waypoint branch)."""
        ob = self.ob
        step = speed * env.dt
        while self.waypoints:
            d = self.waypoints[0] - ob.pos
            dist = float(np.hypot(*d))
            if dist > max(step, 1e-6):
                want = math.atan2(d[1], d[0])
                if max_yaw_rate is not None:
                    err = (want - ob.heading + math.pi) % (2 * math.pi) \
                        - math.pi
                    limit = max_yaw_rate * env.dt
                    want = ob.heading + float(np.clip(err, -limit, limit))
                ob.heading = want
                break
            ob.pos = self.waypoints.pop(0)
            if not self.waypoints:
                self.reached_goal = True
                return
        ob.speed = speed
        ob.pos = ob.pos + _unit(ob.heading) * step


class ExternalControl(ActorController):
    """Longitudinal and lateral control implemented entirely outside the
    scenario engine (external_control.py:19-46): run_step is a no-op."""

    def run_step(self, env) -> None:
        pass


class PedestrianControl(ActorController):
    """Walker controller (pedestrian_control.py:19-76): head to the next
    waypoint at target speed; stop (speed 0) when the plan is done."""

    def __init__(self, ob, args=None):
        if getattr(ob, "kind", "walker") != "walker":
            raise RuntimeError("PedestrianControl: actor is not a walker")
        super().__init__(ob, args)

    def run_step(self, env) -> None:
        if self.init_speed:
            self.ob.speed = self.target_speed
            self.init_speed = False
        if not self.waypoints:
            self.ob.speed = 0.0
            return
        self._follow_waypoints(env, self.target_speed)
        if self.reached_goal:
            self.ob.speed = 0.0


class NpcVehicleControl(ActorController):
    """Vehicle controller (npc_vehicle_control.py:22-107): waypoint
    following with the LocalPlanner's rate-limited steering, braking to a
    stop when the plan is exhausted. `init_speed` applies the target
    speed instantly (the reference sets the velocity vector directly,
    :74-80)."""

    MAX_YAW_RATE = 1.2  # rad/s — LocalPlanner lateral PID analog

    def __init__(self, ob, args=None):
        if getattr(ob, "kind", "vehicle") not in ("vehicle", "cyclist"):
            raise RuntimeError("NpcVehicleControl: actor is not a vehicle")
        super().__init__(ob, args)

    def run_step(self, env) -> None:
        if self.reached_goal and not self._waypoints_updated:
            self.ob.speed = 0.0   # hold the brake at plan end (:67-72)
            return
        self._waypoints_updated = False
        if self.init_speed:
            self.ob.speed = self.target_speed
            self.init_speed = False
        self._follow_waypoints(env, self.target_speed,
                               max_yaw_rate=self.MAX_YAW_RATE)


class SimpleVehicleControl(ActorController):
    """Non-physics vehicle controller (simple_vehicle_control.py:29-256):
    kinematic waypoint chase with optional acceleration limits, obstacle
    proximity stop, and red-light stop.

    args (string-valued, as OSC controller properties):
      max_acceleration / max_deceleration  [m/s^2] speed-ramp limits
      consider_obstacles + proximity_threshold [m]  stop behind dynamic
        actors straight ahead (the reference attaches an obstacle sensor;
        here the env's actor list is scanned along the heading ray)
      consider_trafficlights  stop when the env's controlling light is
        red within braking range (the plugin's traffic-light check)
    """

    def __init__(self, ob, args=None):
        super().__init__(ob, args)
        a = self.args
        self.max_accel = float(a.get("max_acceleration", math.inf))
        self.max_decel = float(a.get("max_deceleration", math.inf))
        self.consider_obstacles = _truthy(a.get("consider_obstacles", False))
        self.proximity = float(a.get("proximity_threshold", math.inf))
        self.consider_lights = _truthy(a.get("consider_trafficlights",
                                             False))

    def _blocked_ahead(self, env) -> bool:
        fwd = _unit(self.ob.heading)
        for other in getattr(env, "_obstacles", []) or []:
            if other is self.ob or getattr(other, "kind", "") == "static":
                continue
            rel = other.pos - self.ob.pos
            ahead = float(np.dot(rel, fwd))
            lateral = fwd[0] * rel[1] - fwd[1] * rel[0]
            if 0.0 < ahead < self.proximity and abs(float(lateral)) < 2.0:
                return True
        return False

    def _red_light_close(self, env) -> bool:
        for light in getattr(env, "_lights", []) or []:
            if getattr(light, "state", "") != "red":
                continue
            # TrafficLightInfo carries `center`; bare test doubles `pos`
            xy = np.asarray(getattr(light, "center",
                                    getattr(light, "pos", (0.0, 0.0))),
                            float)
            d = float(np.hypot(*(xy - self.ob.pos)))
            if d < max(10.0, self.ob.speed * 3.0):
                return True
        return False

    def run_step(self, env) -> None:
        want = self.target_speed
        if self.consider_obstacles and self._blocked_ahead(env):
            want = 0.0
        if self.consider_lights and self._red_light_close(env):
            want = 0.0
        cur = self.ob.speed
        if want > cur:
            cur = min(want, cur + self.max_accel * env.dt)
        else:
            cur = max(want, cur - self.max_decel * env.dt)
        self._follow_waypoints(env, cur)


class VehicleLongitudinalControl(ActorController):
    """Longitudinal-only controller (vehicle_longitudinal_control.py:19-77):
    holds the lane (current heading on a kinematic handle) and tracks the
    target speed; waypoints are ignored."""

    def run_step(self, env) -> None:
        self.ob.speed = self.target_speed
        self.ob.pos = self.ob.pos + _unit(self.ob.heading) \
            * self.ob.speed * env.dt


class ActorControl:
    """Per-actor controller facade (actor_control.py:28-113).

    control_module selects the controller implementation:
      None              -> kind default (walker -> PedestrianControl,
                           vehicle -> NpcVehicleControl, else External)
      'pkg.mod.Class' / 'pkg.mod:Class' -> imported via importlib
      '/path/to/my_own_control.py'      -> module file; the class name is
                           the title-cased module name (MyOwnControl),
                           the reference's file-path convention
    Longitudinal and waypoint commands carry timestamps; a command at the
    same timestamp as the previous one of its kind is dropped (the
    facade's double-command guard, actor_control.py:60-63).
    """

    def __init__(self, ob, control_module: Optional[str] = None,
                 args: Optional[Dict[str, Any]] = None):
        self.controller = self._instantiate(ob, control_module, args)
        self._last_longitudinal_command = None
        self._last_waypoint_command = None

    @staticmethod
    def _instantiate(ob, control_module, args) -> ActorController:
        if not control_module:
            kind = getattr(ob, "kind", "")
            if kind == "walker":
                return PedestrianControl(ob, args)
            if kind in ("vehicle", "cyclist"):
                return NpcVehicleControl(ob, args)
            return ExternalControl(ob, args)
        if control_module.endswith(".py"):
            name = os.path.basename(control_module)[:-3]
            sys.path.append(os.path.dirname(control_module))
            module = importlib.import_module(name)
            cls = getattr(module, name.title().replace("_", ""))
        else:
            mod_name, _, cls_name = control_module.replace(":", ".")\
                .rpartition(".")
            cls = getattr(importlib.import_module(mod_name), cls_name)
        return cls(ob, args)

    # -- forwarded command surface with per-kind timestamp dedup --
    def update_target_speed(self, speed: float, start_time=None) -> None:
        if start_time is not None and \
                start_time == self._last_longitudinal_command:
            return
        self._last_longitudinal_command = start_time
        self.controller.update_target_speed(speed)

    def update_waypoints(self, waypoints, start_time=None) -> None:
        if start_time is not None and \
                start_time == self._last_waypoint_command:
            return
        self._last_waypoint_command = start_time
        self.controller.update_waypoints(waypoints, start_time)

    def set_init_speed(self) -> None:
        self.controller.set_init_speed()

    def check_reached_waypoint_goal(self) -> bool:
        return self.controller.check_reached_waypoint_goal()

    def reset(self) -> None:
        self.controller.reset()

    def run_step(self, env) -> None:
        self.controller.run_step(env)


class ControlledActorBehavior(OwnedActorBehavior):
    """ChangeActorControl + the UpdateAllActorControls runtime
    (atomic_behaviors.py:269-361): attach an `ActorControl` to an actor
    handle (replacing any previous controller — the actor's `_control`
    slot is the registry) and advance it every env tick. Finishes when
    the controller reports its waypoint goal reached (so storyboard
    sequences can chain on completion); an empty-plan controller runs for
    the episode like the reference's, whose atomic returns RUNNING
    forever until its subtree is torn down."""

    def __init__(self, ob, control_module: Optional[str] = None,
                 args: Optional[Dict[str, Any]] = None,
                 target_speed: Optional[float] = None,
                 waypoints: Optional[Sequence] = None,
                 init_speed: bool = False):
        self._own(ob)
        prev = getattr(ob, "_control", None)
        if prev is not None:
            prev.reset()
        self.control = ActorControl(ob, control_module, args)
        ob._control = self.control
        if target_speed is not None:
            self.control.update_target_speed(target_speed)
        if waypoints is not None:
            self.control.update_waypoints(waypoints)
        if init_speed:
            self.control.set_init_speed()

    def _tick_owned(self, env) -> bool:
        self.control.run_step(env)
        return not self.control.check_reached_waypoint_goal()


class UpdateAllActorControlsBehavior(ScenarioBehavior):
    """UpdateAllActorControls (atomic_behaviors.py:318-360): execute one
    control-loop step for every controller-bearing actor that no owning
    behavior is already advancing. Stepped actors are marked managed so
    the env integrator doesn't double-move them. Never finishes (the
    reference's atomic returns RUNNING forever); build_manager installs
    one per OpenSCENARIO scenario like the reference's OpenScenario
    behavior tree does."""

    def tick(self, env) -> bool:
        for ob in list(getattr(env, "_obstacles", [])):
            control = getattr(ob, "_control", None)
            if control is None or getattr(ob, "_owner", None) is not None:
                continue
            ob.managed = True
            control.run_step(env)
        return True


class ChangeActorTargetSpeedBehavior(OwnedActorBehavior):
    """ChangeActorTargetSpeed (atomic_behaviors.py:362-522): retarget an
    actor's EXISTING controller (one-shot; whoever owns the controller
    keeps driving it), timestamped so duplicate simultaneous commands
    collapse. If the actor has NO controller yet, a kind default is
    attached and this behavior becomes its owner-stepper (the reference
    stays RUNNING and UpdateAllActorControls advances the control)."""

    def __init__(self, ob, speed: float, start_time=None,
                 init_speed: bool = False):
        self._ob, self._speed = ob, speed
        self._start_time, self._init = start_time, init_speed
        self._stepping = False
        self._started = False

    def tick(self, env) -> bool:
        if not self._started:
            self._started = True
            control = getattr(self._ob, "_control", None)
            if control is None:
                self._own(self._ob)
                self._stepping = True
                control = ActorControl(self._ob)
                self._ob._control = control
            control.update_target_speed(self._speed,
                                        start_time=self._start_time)
            if self._init:
                control.set_init_speed()
            if not self._stepping:
                return False
        if not self._stepping:
            return False
        return super().tick(env)

    def _tick_owned(self, env) -> bool:
        self._ob._control.run_step(env)
        return True                       # RUNNING until taken over


class ChangeActorWaypointsBehavior(OwnedActorBehavior):
    """ChangeActorWaypoints (atomic_behaviors.py:523-609): hand a new
    waypoint plan to the actor's existing controller (one-shot). If the
    actor has NO controller yet, a kind default is attached continuing at
    the actor's current speed, and this behavior owner-steps it until the
    plan's last waypoint is reached (the reference's RUNNING-until-goal)."""

    def __init__(self, ob, waypoints: Sequence, start_time=None):
        self._ob = ob
        self._wps = waypoints
        self._start_time = start_time
        self._stepping = False
        self._started = False

    def tick(self, env) -> bool:
        if not self._started:
            self._started = True
            control = getattr(self._ob, "_control", None)
            if control is None:
                self._own(self._ob)
                self._stepping = True
                control = ActorControl(self._ob)
                control.update_target_speed(
                    float(getattr(self._ob, "speed", 0.0)))
                self._ob._control = control
            control.update_waypoints(self._wps,
                                     start_time=self._start_time)
            if not self._stepping:
                return False
        if not self._stepping:
            return False
        return super().tick(env)

    def _tick_owned(self, env) -> bool:
        control = self._ob._control
        control.run_step(env)
        return not control.check_reached_waypoint_goal()


class ChangeActorWaypointsToReachPositionBehavior(
        ChangeActorWaypointsBehavior):
    """ChangeActorWaypointsToReachPosition (atomic_behaviors.py:610-668):
    plan = straight trace from the actor to the target position (the
    reference routes over the map; kinematic handles drive the segment —
    a map-aware plan can be passed to ChangeActorWaypointsBehavior
    directly via envs.map_router)."""

    def __init__(self, ob, target, start_time=None):
        super().__init__(ob, [np.asarray(target, float)],
                         start_time=start_time)
