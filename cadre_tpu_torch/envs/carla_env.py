"""CARLA-backed driving environment implementing the EnvWrapper contract.

numpy copy of the JAX package's CarlaDrivingEnv (the same route trace,
GPS plan, criteria, light records, scenario actors, sensors and watchdog,
tick for tick). Contract: env_wrapper.py:58-1013 — client connect (60 s
timeout), synchronous mode at fixed_delta 1/frame_rate, traffic manager
on port+3, per-episode route construction with curriculum indexing, the
reference's five sensors (rgb camera 256x144 fov90 at x=1.3 z=1.3, imu,
gnss, speedometer, obstacle distance=11 hit_radius=0.5 only_dynamics),
obstacle lane/heading filtering (:944-979), and GPS-space route
following. Reward/termination/route-figure logic is shared with the
simulator via BaseDrivingEnv — byte-identical decomposed rewards either
way.

Requires the `carla` Python package and a running server; everything is
lazily imported so the rest of the framework works without it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.base_env import BaseDrivingEnv
from cadre_tpu_torch.envs.carla.provider import CarlaProvider, GameTime
from cadre_tpu_torch.envs.carla.sensors import (
    CallBack,
    SensorInterface,
    SpeedometerReader,
)
from cadre_tpu_torch.envs.carla.actors import spawn_scenario_actor
from cadre_tpu_torch.envs.criteria import VehicleSnapshot, default_criteria
from cadre_tpu_torch.envs.indexer import PriorityRouteIndexer, RouteIndexer
from cadre_tpu_torch.envs.planner import GPS_MEAN, GPS_SCALE, RoutePlanner
from cadre_tpu_torch.envs.road_option import RoadOption
from cadre_tpu_torch.envs.traffic_lights import (
    GREEN,
    RED,
    YELLOW,
    nearest_light_ahead,
)
from cadre_tpu_torch.utils.watchdog import Watchdog

# carla.TrafficLightState name -> criteria state (Off/Unknown treated green,
# matching the reference which only ever tests for Red)
_LIGHT_STATES = {"Red": RED, "Yellow": YELLOW, "Green": GREEN}

EGO_MODEL = "vehicle.lincoln.mkz2017"  # route_scenario.py:260

DEFAULT_SENSORS = [
    {"type": "sensor.camera.rgb", "x": 1.3, "y": 0.0, "z": 1.3,
     "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
     "width": 256, "height": 144, "fov": 90, "id": "rgb"},
    {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0,
     "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.05,
     "id": "imu"},
    {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0,
     "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.01,
     "id": "gps"},
    {"type": "sensor.speedometer", "reading_frequency": 20, "id": "speed"},
    {"type": "sensor.other.obstacle", "x": 0.0, "y": 0.0, "z": 0.0,
     "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "id": "obstacle"},
]


class CarlaDrivingEnv(BaseDrivingEnv):
    def __init__(self, host: str = "localhost", port: int = 8010,
                 town: str = "Town01", routes_file: Optional[str] = None,
                 scenario_file: Optional[str] = None,
                 vehicle_num: Tuple[int, int] = (0, 0),
                 client_timeout: float = 60.0, tm_seed: int = 0,
                 sensor_list: Optional[List[dict]] = None,
                 training: bool = True, **kwargs):
        super().__init__(training=training, **kwargs)
        import carla

        self._carla = carla
        self.client = carla.Client(host, port)
        self.client.set_timeout(client_timeout)
        self.world = self.client.load_world(town)
        self.tm_port = port + 3
        self.traffic_manager = self.client.get_trafficmanager(self.tm_port)
        self._tm_seed = tm_seed

        settings = self.world.get_settings()
        settings.synchronous_mode = True
        settings.fixed_delta_seconds = self.dt
        self.world.apply_settings(settings)

        self.provider = CarlaProvider()
        self.provider.training = training
        self.provider.set_client(self.client)
        self.provider.set_world(self.world)
        self.provider.set_tm_port(self.tm_port)
        self.game_time = GameTime()

        self._sensor_specs = sensor_list or DEFAULT_SENSORS
        self._sensors: List[Any] = []
        self.sensor_interface: Optional[SensorInterface] = None
        self._speedometer: Optional[SpeedometerReader] = None
        self.ego = None
        self._collision_flags = {"static": False, "vehicle": False,
                                 "walker": False}
        self._vehicle_num = vehicle_num
        self._timeout = client_timeout
        # liveness monitor around the server round trip — the reference's
        # Watchdog slot, instantiated here instead of commented out
        # (leaderboard/.../scenario_manager.py:67-71): petted before every
        # world.tick, checked after; a tick+sensor round trip longer than
        # the client timeout raises instead of hanging the worker forever
        self._watchdog = Watchdog(timeout=client_timeout, name="carla-tick")
        self._watchdog.start()
        if routes_file:
            idx_cls = PriorityRouteIndexer if training else RouteIndexer
            self.route_indexer = idx_cls(routes_file, scenario_file,
                                         vehicle_num=list(vehicle_num))
        else:
            raise ValueError("CarlaDrivingEnv requires a routes_file")

        # scenario-behavior world interface (envs/scenarios.py operates on
        # these in world-meter space)
        self._rng = np.random.RandomState(tm_seed)
        self._pos = np.zeros(2)
        self._yaw = 0.0
        self._speed = 0.0
        self._route_xy = np.zeros((2, 2))
        self._obstacles: List[Any] = []
        self._control_noise = 0.0
        self._scenario_manager = None
        self._light_infos: List[Any] = []
        self._stop_infos: List[Any] = []
        self._scenario_annotations = None
        if scenario_file is not None:
            try:
                from cadre_tpu_torch.envs.route_parser import (
                    parse_scenario_file,
                )

                self._scenario_annotations = parse_scenario_file(
                    scenario_file)
            except (OSError, ValueError):
                self._scenario_annotations = None

    # ---------------- route building ----------------

    def _trace_route(self, keypoints: np.ndarray
                     ) -> List[Tuple[Any, RoadOption]]:
        """Dense map-aware trace start->end (route_manipulation.py:132-169).

        Uses the framework's own MapRouter (envs/map_router.py — the
        GlobalRoutePlanner algorithm re-derived over the map API, so no
        `agents` egg package is required); falls back to straight-line
        interpolation only when the map exposes no lane topology."""
        carla = self._carla
        if hasattr(self.provider.map, "get_topology"):
            from cadre_tpu_torch.envs.map_router import MapRouter

            if getattr(self, "_map_router", None) is None or \
                    self._map_router._map is not self.provider.map:
                self._map_router = MapRouter(self.provider.map, 1.0)
            try:
                route = []
                for a, b in zip(keypoints[:-1], keypoints[1:]):
                    la = carla.Location(x=float(a[0]), y=float(a[1]))
                    lb = carla.Location(x=float(b[0]), y=float(b[1]))
                    route.extend(self._map_router.trace_route(la, lb))
                if route:
                    return [(wp.transform, opt) for wp, opt in route]
            except ValueError:
                pass  # disconnected topology: straight-line fallback
        # straight-line interpolation (no map topology)
        from cadre_tpu_torch.envs.route_parser import interpolate_route

        dense = interpolate_route(keypoints, 1.0)
        out = []
        for p in dense:
            tf = carla.Transform(carla.Location(x=float(p[0]),
                                                y=float(p[1])))
            out.append((tf, RoadOption.LANEFOLLOW))
        return out

    def _to_gps(self, transform) -> Dict[str, float]:
        """World transform -> geo location via the map's geo-reference."""
        loc = transform.location
        geo = self.provider.map.transform_to_geolocation(loc)
        return {"lat": geo.latitude, "lon": geo.longitude, "z": geo.altitude}

    # ---------------- world interface ----------------

    def _world_reset(self) -> None:
        carla = self._carla
        # anti-slowdown reset (env_wrapper.py:582-599)
        self._destroy_sensors()
        self.provider.cleanup()
        self.game_time.restart()
        self.provider.set_client(self.client)
        self.provider.set_world(self.world)
        self.traffic_manager.set_synchronous_mode(True)
        self.traffic_manager.set_random_device_seed(self._tm_seed)
        self._watchdog.update()
        self.world.tick()
        self._watchdog.pause()

        cfg = self.route_indexer.next()
        self._current_config = cfg
        self.route_name = cfg.index
        keypoints = np.asarray([w.xy for w in cfg.trajectory])
        route = self._trace_route(keypoints)
        self._route_transforms = route

        # ego at the first waypoint (elevated to avoid ground collision)
        start_tf = carla.Transform(
            carla.Location(route[0][0].location.x, route[0][0].location.y,
                           route[0][0].location.z + 0.5),
            route[0][0].rotation)
        self.ego = self.provider.spawn_actor(EGO_MODEL, start_tf,
                                             rolename="hero")
        if self.ego is None:
            raise RuntimeError("failed to spawn ego vehicle")

        # planner over the GPS-encoded route
        gps_plan = [(self._to_gps(tf), opt) for tf, opt in route]
        planner = RoutePlanner(min_distance=4.0, max_distance=50.0)
        planner.set_route(gps_plan, gps=True)
        self._planner = planner

        # criteria over meter-space route points
        route_xy = np.asarray([[tf.location.x, tf.location.y]
                               for tf, _ in route])
        # criteria consume GPS-space positions: convert route to gps meters
        gps_xy = np.asarray(
            [(np.array([g["lat"], g["lon"]]) - GPS_MEAN) * GPS_SCALE
             for g, _ in gps_plan])

        # scenario-behavior world state (world meters)
        self._route_xy = route_xy
        self._pos = route_xy[0].astype(np.float64).copy()
        self._yaw = float(route[0][0].rotation.yaw)
        self._speed = 0.0
        self._obstacles = []
        self._control_noise = 0.0

        # traffic-light subsystem: force CADRE's short cycles, then build
        # plane-space light/stop records for the geometric criteria
        # (carla_data_provider.py:309-414, atomic_criteria.py:1836-2075)
        def to_plane(loc):
            geo = self.provider.map.transform_to_geolocation(loc)
            return (np.array([geo.latitude, geo.longitude])
                    - GPS_MEAN) * GPS_SCALE

        self._to_plane = to_plane
        try:
            self.provider.set_all_light_times()
            self._light_infos = self.provider.get_light_infos(to_plane)
            self._stop_infos = self.provider.get_stop_sign_infos(to_plane)
            # behaviors operate in WORLD meters (the frame of self._pos /
            # self._yaw / spawn_scenario_actor); give them a world-frame
            # twin of the light records — same backing actors, so state
            # forcing is visible through both views
            self._light_infos_world = self.provider.get_light_infos(
                lambda loc: np.array([loc.x, loc.y]))
        except (RuntimeError, AttributeError):
            self._light_infos, self._stop_infos = [], []
            self._light_infos_world = []

        veh_extent = 2.45
        try:
            veh_extent = float(self.ego.bounding_box.extent.x)
        except (RuntimeError, AttributeError):
            pass
        blocked_s = 180.0 if self.training else 800 * self.dt
        self._criteria = default_criteria(gps_xy, dt=self.dt,
                                          blocked_seconds=blocked_s,
                                          lights=self._light_infos,
                                          stop_signs=self._stop_infos,
                                          veh_extent=veh_extent)

        # adversarial sub-scenarios at route trigger points
        # (route_scenario.py:368-435): behaviors spawn/steer real actors
        if self._scenario_annotations:
            from cadre_tpu_torch.envs.scenarios import ScenarioManager

            self._scenario_manager = ScenarioManager.from_annotations(
                self._scenario_annotations, route_xy, rng=self._rng,
                sample=True)
        else:
            self._scenario_manager = None

        # background traffic
        self.provider.spawn_background_traffic(
            cfg.vehicle_num or 0, cfg.walker_num or 0, self.tm_port)

        self._setup_sensors()
        self._watchdog.update()
        self.world.tick()
        self._watchdog.pause()
        self._on_world_tick()

    def _setup_sensors(self) -> None:
        carla = self._carla
        self.sensor_interface = SensorInterface(timeout=self._timeout)
        lib = self.world.get_blueprint_library()
        for spec in self._sensor_specs:
            stype = spec["type"]
            if stype.startswith("sensor.speedometer"):
                self._speedometer = SpeedometerReader(
                    self.ego, spec.get("reading_frequency", 20),
                    self.sensor_interface, tag=spec["id"])
                self._speedometer.start()
                continue
            bp = lib.find(stype)
            if stype.startswith("sensor.camera.rgb"):
                bp.set_attribute("image_size_x", str(spec["width"]))
                bp.set_attribute("image_size_y", str(spec["height"]))
                bp.set_attribute("fov", str(spec["fov"]))
                bp.set_attribute("lens_circle_multiplier", "3.0")
                bp.set_attribute("lens_circle_falloff", "3.0")
                bp.set_attribute("chromatic_aberration_intensity", "0.5")
                bp.set_attribute("chromatic_aberration_offset", "0")
            elif stype.startswith("sensor.other.gnss"):
                for attr in ["noise_alt_stddev", "noise_lat_stddev",
                             "noise_lon_stddev"]:
                    bp.set_attribute(attr, "0.000005")
            elif stype.startswith("sensor.other.imu"):
                for attr, v in [("noise_accel_stddev_x", "0.001"),
                                ("noise_accel_stddev_y", "0.001"),
                                ("noise_accel_stddev_z", "0.015"),
                                ("noise_gyro_stddev_x", "0.001"),
                                ("noise_gyro_stddev_y", "0.001"),
                                ("noise_gyro_stddev_z", "0.001")]:
                    bp.set_attribute(attr, v)
            elif stype.startswith("sensor.other.obstacle"):
                bp.set_attribute("distance", "11")
                bp.set_attribute("hit_radius", "0.5")
                bp.set_attribute("only_dynamics", "True")
                bp.set_attribute("sensor_tick", "0.01")
            tf = carla.Transform(
                carla.Location(x=spec.get("x", 0.0), y=spec.get("y", 0.0),
                               z=spec.get("z", 0.0)),
                carla.Rotation(pitch=spec.get("pitch", 0.0),
                               roll=spec.get("roll", 0.0),
                               yaw=spec.get("yaw", 0.0)))
            sensor = self.world.spawn_actor(bp, tf, self.ego)
            sensor.listen(CallBack(spec["id"], stype, sensor,
                                   self.sensor_interface))
            self._sensors.append(sensor)

        # collision sensor feeds the CollisionCriterion
        cbp = lib.find("sensor.other.collision")
        collision = self.world.spawn_actor(cbp, carla.Transform(), self.ego)
        collision.listen(self._on_collision)
        self._sensors.append(collision)
        self._watchdog.update()
        self.world.tick()
        self._watchdog.pause()

    def _on_collision(self, event) -> None:
        other = event.other_actor
        tid = other.type_id if other is not None else ""
        if tid.startswith("walker"):
            self._collision_flags["walker"] = True
        elif tid.startswith("vehicle"):
            self._collision_flags["vehicle"] = True
        else:
            self._collision_flags["static"] = True

    def _destroy_sensors(self) -> None:
        if self._speedometer is not None:
            self._speedometer.stop()
            self._speedometer = None
        for s in self._sensors:
            try:
                s.stop()
                s.destroy()
            except RuntimeError:
                pass
        self._sensors = []
        if self.sensor_interface is not None:
            self.sensor_interface.destroy()
            self.sensor_interface = None

    def _on_world_tick(self) -> None:
        snapshot = self.world.get_snapshot()
        if snapshot:
            self.game_time.on_tick(snapshot.timestamp)
        self.provider.on_tick()

    def spawn_scenario_actor(self, kind: str, pos, heading: float = 0.0,
                             speed: float = 0.0, radius=None):
        """Behavior-library actor factory: spawn a real server actor and
        return its kinematic handle; fall back to a ghost SimObstacle when
        the spawn point is blocked so the behavior still completes."""
        handle = spawn_scenario_actor(self.provider, self._carla, kind, pos,
                                      heading=heading, speed=speed,
                                      radius=radius)
        if handle is None:
            from cadre_tpu_torch.envs.sim_env import SimObstacle

            handle = SimObstacle(pos=np.asarray(pos, float).copy(),
                                 radius=radius or
                                 (0.4 if kind == "walker" else 1.2),
                                 kind=kind, speed=speed, heading=heading)
        self._obstacles.append(handle)
        return handle

    def _world_step(self, control: Sequence[float]) -> None:
        carla = self._carla
        # refresh the behavior-facing ego state, then tick sub-scenarios
        tf0 = self.ego.get_transform()
        self._pos = np.array([tf0.location.x, tf0.location.y])
        self._yaw = float(tf0.rotation.yaw)
        if self._scenario_manager is not None:
            self._scenario_manager.tick(self)

        vc = carla.VehicleControl()
        # ControlLossBehavior injects steering noise (control_loss.py)
        steer = float(control[0]) + self._control_noise
        vc.steer = float(np.clip(steer, -1.0, 1.0))
        vc.throttle = float(control[1])
        vc.brake = float(control[2])
        vc.manual_gear_shift = False
        self.ego.apply_control(vc)
        # spectator follow-cam (env_wrapper.py:871-874)
        spectator = self.world.get_spectator()
        tf = self.ego.get_transform()
        spectator.set_transform(carla.Transform(
            tf.location + carla.Location(z=50),
            carla.Rotation(pitch=-90)))
        # the watchdog brackets ONLY the server round trip: agent inference
        # (first-step JIT compile can exceed client_timeout), checkpoint
        # saves, and reset-time loading must never count against it
        self._watchdog.update()
        self.world.tick(self._timeout)
        failed = self._watchdog.failed
        self._watchdog.pause()
        if failed:
            raise RuntimeError(
                f"simulator hung: world.tick exceeded the "
                f"{self._watchdog.timeout:.0f}s watchdog")
        self._on_world_tick()

        # refresh light states from the server actors (frozen = forced by a
        # scenario behavior; the force already went to the server, but skip
        # the read-back so a slow server round trip can't flicker it)
        for info in self._light_infos:
            if info.frozen is not None:
                info.state = info.frozen
                continue
            if info.actor is not None:
                try:
                    name = str(info.actor.get_state()).rsplit(".", 1)[-1]
                    info.state = _LIGHT_STATES.get(name, GREEN)
                except RuntimeError:
                    pass

        # criteria update in GPS meter space
        gps_pos = self._last_gps_meters if hasattr(self, "_last_gps_meters") \
            else np.zeros(2)
        v = self.ego.get_velocity()
        speed = (v.x ** 2 + v.y ** 2 + v.z ** 2) ** 0.5
        self._speed = float(speed)
        yaw_rad = math.radians(tf.rotation.yaw)
        # GPS-plane heading: world (cos,sin) maps to (-sin, cos) in (lat,lon)
        gps_fwd = np.array([-math.sin(yaw_rad), math.cos(yaw_rad)])
        snap = VehicleSnapshot(
            pos=gps_pos, yaw=tf.rotation.yaw, speed=speed,
            collided_static=self._collision_flags["static"],
            collided_vehicle=self._collision_flags["vehicle"],
            collided_pedestrian=self._collision_flags["walker"],
            forward=gps_fwd)
        for crit in self._criteria:
            crit.update(snap)
        self._collision_flags = {"static": False, "vehicle": False,
                                 "walker": False}

    def _filter_obstacle(self, distance: float, actor, yaw_deg: float
                         ) -> float:
        """Lane/heading obstacle filtering (env_wrapper.py:944-979)."""
        if distance <= -1 or actor is None:
            return -1.0
        carla = self._carla
        m = self.provider.map
        ego_pt = m.get_waypoint(self.provider.get_location(self.ego),
                                project_to_road=False)
        ego_road = m.get_waypoint(self.provider.get_location(self.ego),
                                  lane_type=carla.LaneType.Driving,
                                  project_to_road=True)
        ego_lane = ego_pt.lane_id if ego_pt else -100
        ego_road_id = ego_road.road_id if ego_road else -100
        other_pt = m.get_waypoint(self.provider.get_location(actor),
                                  project_to_road=False)
        other_road = m.get_waypoint(self.provider.get_location(actor),
                                    lane_type=carla.LaneType.Driving,
                                    project_to_road=True)
        other_lane = other_pt.lane_id if other_pt else -101
        other_road_id = other_road.road_id if other_road else -101
        if ego_lane != other_lane and ego_road_id == other_road_id:
            return -1.0
        tfs = self.provider.get_transform(actor)
        actor_speed = self.provider.get_velocity(actor)
        vehicle_theta = abs(tfs.rotation.yaw - yaw_deg)
        if vehicle_theta > 180:
            vehicle_theta = 360 - vehicle_theta
        if vehicle_theta > 90 and actor_speed < 0.01 and \
                "vehicle" in actor.type_id:
            return -1.0
        return distance

    def _world_tick(self) -> Dict[str, Any]:
        data = self.sensor_interface.get_data()
        self.sensor_interface.clear_obstacle("obstacle")

        bgra = data["rgb"][1]
        rgb = bgra[:, :, :3][:, :, ::-1].copy()  # BGR -> RGB
        gnss = data["gps"][1]
        gps_meters = (gnss[:2] - GPS_MEAN) * GPS_SCALE
        self._last_gps_meters = gps_meters
        speed = data["speed"][1]["speed"]
        if math.isnan(speed):
            speed = 0.0
        imu = data["imu"][1]
        compass = float(imu[-1])
        yaw_deg = float(imu[3])
        obstacle_distance, obstacle_actor = -1.0, None
        odata = data.get("obstacle", (-1, None))
        if odata[1] is not None and odata[0] > -1:
            dist_arr, obstacle_actor = odata[1]
            obstacle_distance = float(dist_arr[0])
        obstacle = self._filter_obstacle(obstacle_distance, obstacle_actor,
                                         yaw_deg)
        # GPS-space forward: world (cos,sin) maps to (-sin, cos) in (lat,lon)
        fwd = np.array([-math.sin(math.radians(yaw_deg)),
                        math.cos(math.radians(yaw_deg))])
        light_state, light_dist = nearest_light_ahead(
            self._light_infos, gps_meters, fwd)
        return {
            "rgb": rgb,
            "gps": gps_meters,
            "full_gps": gnss[:3],
            "speed": float(speed),
            "compass": compass,
            "forward": fwd,
            "imu": [float(imu[0]), float(imu[1]), float(imu[2]), yaw_deg],
            "obstacle": obstacle,
            "light_state": light_state,
            "light_dist": light_dist,
            "target_diff": 0,
            "topdown_seg": None,
        }

    def _planner_step(self, gps):
        # base passes tick['gps'] (already meter-transformed here)
        return self._planner.run_step(gps)

    def _cleanup_episode(self) -> None:
        super()._cleanup_episode()
        if isinstance(self.route_indexer, PriorityRouteIndexer):
            for crit in self._criteria:
                if crit.name == "RouteCompletionTest":
                    self.route_indexer.update_route(
                        self._current_config.index, crit.actual_value,
                        crit.current_index)

    def close(self) -> None:
        self._watchdog.stop()
        self._destroy_sensors()
        self.provider.cleanup()
        settings = self.world.get_settings()
        settings.synchronous_mode = False
        settings.fixed_delta_seconds = None
        self.world.apply_settings(settings)
