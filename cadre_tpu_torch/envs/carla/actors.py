"""Scenario-actor adapter for CARLA-backed envs.

A copy of the JAX package's module.

The behavior library (envs/scenarios.py) integrates actors kinematically
through a plain handle interface: `.pos` [2] world meters, `.heading` rad,
`.speed` m/s, `.kind`, `.radius`, `.managed`. The kinematic sim satisfies it
with `SimObstacle`; this module satisfies it with a real spawned CARLA actor,
applying the integrated pose as a synchronous-mode transform update each
write (the actors the reference spawns per sub-scenario,
route_scenario.py:368-435 + srunner/scenarios/*, are driven by py_trees
behaviors; here the same tick-driven state machines drive server actors).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

VEHICLE_MODEL = "vehicle.*"
WALKER_MODEL = "walker.pedestrian.*"
# per-scenario adversary blueprints: cyclist adversary/crosser
# (object_crash_vehicle.py:219, object_crash_intersection.py:689
# 'vehicle.diamondback.century') and the jaywalker vision-blocker prop
# (object_crash_vehicle.py:228-248 'static.prop.vendingmachine')
KIND_MODELS = {
    "walker": WALKER_MODEL,
    "vehicle": VEHICLE_MODEL,
    "cyclist": "vehicle.diamondback.century",
    "static": "static.prop.vendingmachine",
}
KIND_RADII = {"walker": 0.4, "vehicle": 1.2, "cyclist": 0.6, "static": 0.6}


class CarlaActorHandle:
    """Kinematic control of one spawned actor via per-tick transform sets."""

    def __init__(self, actor, carla_mod, kind: str, radius: float,
                 heading: float = 0.0, speed: float = 0.0):
        self.actor = actor
        self._carla = carla_mod
        self.kind = kind
        self.radius = radius
        self.heading = heading
        self.speed = speed
        self.managed = False
        loc = actor.get_transform().location
        self._pos = np.array([loc.x, loc.y], float)
        self._z = loc.z

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @pos.setter
    def pos(self, value) -> None:
        self._pos = np.asarray(value, float)
        carla = self._carla
        tf = carla.Transform(
            carla.Location(x=float(self._pos[0]), y=float(self._pos[1]),
                           z=self._z),
            carla.Rotation(yaw=math.degrees(self.heading)))
        self.actor.set_transform(tf)

    def destroy(self) -> None:
        try:
            if self.actor is not None and self.actor.is_alive:
                self.actor.destroy()
        except RuntimeError:
            pass


def spawn_scenario_actor(provider, carla_mod, kind: str, pos,
                         heading: float = 0.0, speed: float = 0.0,
                         radius: Optional[float] = None,
                         z: float = 0.5) -> Optional[CarlaActorHandle]:
    """Spawn a scenario adversary (walker or vehicle) at a world position
    and wrap it in a kinematic handle. Returns None if the spawn failed
    (occupied spawn point), mirroring try_spawn_actor semantics."""
    if radius is None:
        radius = KIND_RADII.get(kind, 1.2)
    model = KIND_MODELS.get(kind, VEHICLE_MODEL)
    tf = carla_mod.Transform(
        carla_mod.Location(x=float(pos[0]), y=float(pos[1]), z=z),
        carla_mod.Rotation(yaw=math.degrees(heading)))
    actor = provider.spawn_actor(model, tf, rolename="scenario")
    if actor is None:
        return None
    handle = CarlaActorHandle(actor, carla_mod, kind, radius,
                              heading=heading, speed=speed)
    return handle
