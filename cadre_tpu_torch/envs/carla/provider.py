"""CARLA simulator facade: cached actor state + lifecycle management.

A copy of the JAX package's provider.

Contract: srunner/scenariomanager/carla_data_provider.py:34-1165 — a global
registry caching actor velocity/location/transform refreshed once per tick
(RPC amortization), world/client/traffic-manager handles, blueprint
creation, batch spawning, hero lookup, and cleanup between episodes (the
anti-slowdown reset, env_wrapper.py:582-599).

`carla` is imported lazily — this module is importable without the simulator
installed.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


def _carla():
    import carla  # deferred: only needed when a server is used

    return carla


class CarlaProvider:
    """Instance-based (not global-singleton) provider; one per env."""

    def __init__(self):
        self._client = None
        self._world = None
        self._map = None
        self._tm_port: Optional[int] = None
        self._sync = True
        self._actors: List[Any] = []
        self._velocities: Dict[int, float] = {}
        self._transforms: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self.training = True

    # ---------------- registry ----------------

    def set_client(self, client) -> None:
        self._client = client

    def set_world(self, world) -> None:
        self._world = world
        self._map = world.get_map()

    def set_tm_port(self, port: int) -> None:
        self._tm_port = port

    @property
    def world(self):
        return self._world

    @property
    def map(self):
        return self._map

    # ---------------- per-tick cache ----------------

    def on_tick(self) -> None:
        with self._lock:
            for actor in self._actors:
                if actor is None or not actor.is_alive:
                    continue
                aid = actor.id
                v = actor.get_velocity()
                self._velocities[aid] = (v.x ** 2 + v.y ** 2
                                         + v.z ** 2) ** 0.5
                self._transforms[aid] = actor.get_transform()

    def get_velocity(self, actor) -> float:
        return self._velocities.get(actor.id, 0.0)

    def get_transform(self, actor):
        return self._transforms.get(actor.id) or actor.get_transform()

    def get_location(self, actor):
        return self.get_transform(actor).location

    # ---------------- spawning ----------------

    def register(self, actor) -> Any:
        with self._lock:
            self._actors.append(actor)
        return actor

    def create_blueprint(self, model: str, rolename: str = "scenario"):
        lib = self._world.get_blueprint_library()
        bps = lib.filter(model)
        if not bps:
            raise ValueError(f"no blueprint matches {model!r}")
        bp = bps[0]
        if bp.has_attribute("role_name"):
            bp.set_attribute("role_name", rolename)
        if bp.has_attribute("color"):
            bp.set_attribute(
                "color", bp.get_attribute("color").recommended_values[0])
        return bp

    def spawn_actor(self, model: str, transform, rolename: str = "scenario",
                    autopilot: bool = False):
        bp = self.create_blueprint(model, rolename)
        actor = self._world.try_spawn_actor(bp, transform)
        if actor is None:
            return None
        if autopilot and self._tm_port is not None:
            actor.set_autopilot(True, self._tm_port)
        return self.register(actor)

    def spawn_background_traffic(self, n_vehicles: int, n_walkers: int,
                                 tm_port: Optional[int] = None) -> None:
        """Batch-spawn autopilot vehicles + wandering walkers
        (carla_data_provider.py:931-1044 behavior)."""
        carla = _carla()
        tm_port = tm_port or self._tm_port
        spawn_points = list(self._map.get_spawn_points())
        import random

        random.shuffle(spawn_points)
        for tf in spawn_points[:n_vehicles]:
            actor = self.spawn_actor("vehicle.*", tf, autopilot=True)
        for _ in range(n_walkers):
            loc = self._world.get_random_location_from_navigation()
            if loc is None:
                continue
            bp = self.create_blueprint("walker.pedestrian.*", "walker")
            walker = self._world.try_spawn_actor(
                bp, carla.Transform(loc))
            if walker is not None:
                self.register(walker)

    # ---------------- traffic lights / stop signs ----------------
    # (carla_data_provider.py:292-414 + the trigger-volume discretization of
    # RunningRedLightTest.get_traffic_light_waypoints)

    @staticmethod
    def _rotate_point(x: float, y: float, angle_deg: float):
        import math

        c = math.cos(math.radians(angle_deg))
        s = math.sin(math.radians(angle_deg))
        return c * x - s * y, s * x + c * y

    def get_trafficlight_trigger_location(self, light):
        """World location of the light's trigger volume center
        (carla_data_provider.py:344-368)."""
        carla = _carla()
        base = light.get_transform()
        area_loc = base.transform(light.trigger_volume.location)
        return carla.Location(area_loc.x, area_loc.y, area_loc.z)

    def set_all_light_times(self, green: float = 5.0, red: float = 0.5,
                            yellow: float = 3.0) -> None:
        """CADRE's forced short cycle on every light in the town
        (atomic_criteria.py:1869-1871)."""
        for actor in self._world.get_actors().filter("*traffic_light*"):
            actor.set_green_time(green)
            actor.set_red_time(red)
            actor.set_yellow_time(yellow)

    def _stop_line_waypoints(self, light):
        """Discretize the trigger box into lane waypoints advanced to the
        junction entry (atomic_criteria.py:2041-2075)."""
        base = light.get_transform()
        base_yaw = base.rotation.yaw
        area_loc = base.transform(light.trigger_volume.location)
        ext = light.trigger_volume.extent
        carla = _carla()

        xs = [x for x in self._frange(-0.9 * ext.x, 0.9 * ext.x, 1.0)]
        ini_wps = []
        for x in xs:
            px, py = self._rotate_point(x, 0.0, base_yaw)
            pt = carla.Location(x=area_loc.x + px, y=area_loc.y + py,
                                z=area_loc.z)
            wp = self._map.get_waypoint(pt)
            if wp is None:
                continue
            if not ini_wps or ini_wps[-1].road_id != wp.road_id or \
                    ini_wps[-1].lane_id != wp.lane_id:
                ini_wps.append(wp)
        wps = []
        for wp in ini_wps:
            guard = 0
            while not wp.is_intersection and guard < 200:
                nxt = wp.next(0.5)
                if not nxt or nxt[0].is_intersection:
                    break
                wp = nxt[0]
                guard += 1
            wps.append(wp)
        return area_loc, wps

    @staticmethod
    def _frange(a: float, b: float, step: float):
        x = a
        while x < b:
            yield x
            x += step

    def get_light_infos(self, to_plane):
        """Build simulator-agnostic TrafficLightInfo records for every
        traffic light in the world. `to_plane` maps a carla.Location to the
        criteria plane [2] (e.g. the GPS-meter transform)."""
        import numpy as np

        from cadre_tpu_torch.envs.traffic_lights import (
            StopLine,
            TrafficLightInfo,
        )

        carla = _carla()
        infos = []
        for actor in self._world.get_actors().filter("*traffic_light*"):
            center_loc, wps = self._stop_line_waypoints(actor)
            stop_lines = []
            for wp in wps:
                loc = wp.transform.location
                fv = wp.transform.get_forward_vector()
                p0 = to_plane(loc)
                p1 = to_plane(carla.Location(x=loc.x + fv.x, y=loc.y + fv.y,
                                             z=loc.z))
                d = np.asarray(p1, float) - np.asarray(p0, float)
                n = float(np.hypot(*d))
                if n < 1e-9:
                    continue
                stop_lines.append(StopLine(
                    pos=np.asarray(p0, float), dir=d / n,
                    lane_width=getattr(wp, "lane_width", 3.5)))
            infos.append(TrafficLightInfo(
                uid=actor.id, center=np.asarray(to_plane(center_loc), float),
                stop_lines=stop_lines, actor=actor))
        return infos

    def get_stop_sign_infos(self, to_plane):
        """StopSignInfo records for 'traffic.stop' actors
        (RunningStopTest.__init__, atomic_criteria.py:2100-2105)."""
        import numpy as np

        from cadre_tpu_torch.envs.traffic_lights import StopSignInfo

        carla = _carla()
        infos = []
        for actor in self._world.get_actors().filter("*traffic.stop*"):
            tf = actor.get_transform()
            tv = actor.trigger_volume
            center = tf.transform(tv.location)
            # bbox yaw expressed in the criteria plane: transform the box's
            # forward vector through to_plane rather than trusting raw world
            # yaw (the GPS plane is rotated relative to world axes)
            fv = tf.get_forward_vector()
            p0 = np.asarray(to_plane(center), float)
            p1 = np.asarray(to_plane(carla.Location(
                x=center.x + fv.x, y=center.y + fv.y, z=center.z)), float)
            d = p1 - p0
            import math as _math

            yaw_plane = _math.degrees(_math.atan2(d[1], d[0])) \
                if float(np.hypot(*d)) > 1e-9 else 0.0
            infos.append(StopSignInfo(
                uid=actor.id, center=p0,
                extent=np.array([max(tv.extent.x, 1.0),
                                 max(tv.extent.y, 1.0)]),
                yaw=yaw_plane))
        return infos

    # ---------------- cleanup ----------------

    def cleanup(self) -> None:
        with self._lock:
            for actor in self._actors:
                try:
                    if actor is not None and actor.is_alive:
                        actor.destroy()
                except RuntimeError:
                    pass
            self._actors = []
            self._velocities = {}
            self._transforms = {}


class GameTime:
    """Sim-clock accumulated from snapshot timestamps
    (srunner/scenariomanager/timer.py:17-80)."""

    def __init__(self):
        self._time = 0.0
        self._frame = 0
        self._initialized = False

    def on_tick(self, timestamp) -> None:
        if not self._initialized or timestamp.frame > self._frame:
            frames = timestamp.frame - self._frame if self._initialized else 1
            self._time += frames * timestamp.delta_seconds
            self._frame = timestamp.frame
            self._initialized = True

    def restart(self) -> None:
        self._time = 0.0
        self._frame = 0
        self._initialized = False

    @property
    def time(self) -> float:
        return self._time
