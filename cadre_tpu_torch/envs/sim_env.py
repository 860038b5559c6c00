"""Kinematic driving simulator behind the host-env contract.

numpy copy of the JAX package's SimDrivingEnv: a bicycle-model ego
vehicle, dense polyline routes (from a route XML or synthetic), the
criteria runtime, route-driving background vehicles and wandering walkers,
corner traffic lights, roadside props and a cheap synthetic camera. The
same seed gives the same episodes, frames and rewards as the JAX
package's env.

Control mapping at 10 Hz: steer in [-1,1] -> wheel angle up to 35 degrees
on a 2.9 m wheelbase, throttle -> 3.5 m/s^2, brake -> 8 m/s^2.

A scenario file (`scenario_file`, route_parser.parse_scenario_file's
JSON) arms the adversarial behaviours of envs/scenarios.py at the trigger
points on each episode's route; `animate_weather` moves the sun through
the episode. Both draw from the env's own rng at the JAX package's points:
the manager is built after the planner on reset and ticks first on every
step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.base_env import BaseDrivingEnv
from cadre_tpu_torch.envs.criteria import VehicleSnapshot, default_criteria
from cadre_tpu_torch.envs.indexer import PriorityRouteIndexer, RouteIndexer
from cadre_tpu_torch.envs.planner import RoutePlanner
from cadre_tpu_torch.envs.road_option import RoadOption
from cadre_tpu_torch.envs.route_fig import (
    outside_route_lanes,
    signed_route_lateral,
)
from cadre_tpu_torch.envs.route_parser import (
    RouteConfig,
    interpolate_route,
    parse_scenario_file,
)
from cadre_tpu_torch.envs.scenarios import (
    ScenarioManager,
    ScenarioTrigger,
    WeatherBehavior,
)
from cadre_tpu_torch.envs.synthetic import (
    PROP_BUILDING,
    PROP_POLE,
    PROP_VEGETATION,
    SIZE_X,
    SIZE_Y,
    WEATHER_PRESETS,
    roadside_props,
    synthetic_route,
)
from cadre_tpu_torch.envs.traffic_lights import (
    GREEN,
    RED,
    YELLOW,
    TrafficLightInfo,
    lights_at_route_corners,
    nearest_light_ahead,
)

@dataclasses.dataclass
class SimObstacle:
    pos: np.ndarray
    radius: float = 1.0
    kind: str = "vehicle"  # 'vehicle' | 'walker' | 'cyclist' | 'static'
    speed: float = 0.0
    heading: float = 0.0
    # True when a scenario behaviour moves this actor itself; the env's
    # own integrators then leave it alone
    managed: bool = False
    # route-driving background vehicle: arc position (m) along the dense
    # route (-1 = not route-bound) and its cruise speed
    route_s: float = -1.0
    cruise: float = 0.0


def prop_color(kind: float, shade: float) -> Tuple[float, float, float]:
    """Deterministic prop colour (the same formula in both renderers)."""
    if kind == PROP_BUILDING:
        return (100.0 + 60.0 * shade, 95.0 + 55.0 * shade,
                90.0 + 50.0 * shade)
    if kind == PROP_VEGETATION:
        return (30.0, 110.0 + 70.0 * shade, 35.0)
    return (140.0, 140.0, 140.0)                 # pole


class SimDrivingEnv(BaseDrivingEnv):
    def __init__(self, routes_file: Optional[str] = None,
                 scenario_file: Optional[str] = None,
                 vehicle_num: Tuple[int, int] = (0, 0),
                 seed: int = 0, training: bool = True,
                 use_priority_indexer: Optional[bool] = None,
                 render_camera: bool = True,
                 weather: Optional[str] = "ClearNoon",
                 randomize_weather: bool = False,
                 with_traffic_lights: bool = True,
                 animate_weather: bool = False,
                 sun_altitude: float = 70.0,
                 route_legs: int = 3,
                 route_leg_len: Tuple[float, float] = (40.0, 90.0),
                 with_props: bool = True,
                 light_times: Optional[Tuple[float, float, float]] = None,
                 npc_cruise: Tuple[float, float] = (3.0, 6.5),
                 **kwargs):
        super().__init__(training=training, **kwargs)
        self._rng = np.random.RandomState(seed)
        # synthetic-route shape when no routes_file is given
        self._route_legs = int(route_legs)
        self._route_leg_len = (float(route_leg_len[0]),
                               float(route_leg_len[1]))
        self.render_camera = render_camera
        self.weather = weather or "ClearNoon"
        self._randomize_weather = randomize_weather
        self._vehicle_num = vehicle_num
        if routes_file is not None:
            if use_priority_indexer is None:
                use_priority_indexer = training
            idx_cls = PriorityRouteIndexer if use_priority_indexer \
                else RouteIndexer
            self.route_indexer = idx_cls(routes_file, scenario_file,
                                         vehicle_num=list(vehicle_num))
        else:
            self.route_indexer = None
        # ego state
        self._pos = np.zeros(2)
        self._yaw = 0.0
        self._speed = 0.0
        self._wheelbase = 2.9
        self._max_wheel = math.radians(35.0)
        self._obstacles: List[SimObstacle] = []
        self._route_xy = np.zeros((2, 2))
        self._with_traffic_lights = with_traffic_lights
        self._animate_weather = animate_weather
        self._sun_altitude = sun_altitude
        self._sun_altitude0 = sun_altitude
        self._lights: List[TrafficLightInfo] = []
        self._with_props = with_props
        # collection-time override of the forced light cycle (green,
        # yellow, red seconds)
        self._light_times = light_times
        self._npc_cruise = npc_cruise
        self._props = np.zeros((0, 6), np.float32)
        self._collision = {"static": False, "vehicle": False, "walker": False}
        self._current_config: Optional[RouteConfig] = None
        # ego control offsets of the ControlLoss / AddNoiseToVehicle
        # behaviours
        self._control_noise = 0.0
        self._throttle_noise = 0.0
        self._scenario_manager: Optional[ScenarioManager] = None
        self._scenario_annotations = None
        if scenario_file is not None:
            try:
                self._scenario_annotations = parse_scenario_file(
                    scenario_file)
            except (OSError, ValueError):
                # as the JAX env: an unreadable file arms no scenario
                self._scenario_annotations = None

    # ---------------- world interface ----------------

    def _world_reset(self) -> None:
        if self._randomize_weather:
            names = list(WEATHER_PRESETS)
            self.weather = names[self._rng.randint(len(names))]
        if self.route_indexer is not None and self.route_indexer.peek():
            cfg = self.route_indexer.next()
            self._current_config = cfg
            pts = np.asarray([w.xy for w in cfg.trajectory])
            self.route_name = cfg.index
            n_vehicles = cfg.vehicle_num or 0
            n_walkers = cfg.walker_num or 0
            st = cfg.st or 0
        else:
            pts = synthetic_route(self._rng, n_legs=self._route_legs,
                                  leg_len=self._route_leg_len)
            self.route_name = int(self._rng.randint(10_000))
            n_vehicles, n_walkers = self._vehicle_num
            st = 0

        dense = interpolate_route(pts, resolution=1.0)
        dense = dense[st:] if st < len(dense) - 2 else dense
        self._route_xy = dense
        start = dense[0]
        d0 = dense[min(3, len(dense) - 1)] - start
        self._yaw = math.degrees(math.atan2(d0[1], d0[0]))
        self._pos = start.astype(np.float64).copy()
        self._speed = 0.0
        self._collision = {"static": False, "vehicle": False, "walker": False}

        # background vehicles drive the route; walkers wander near it
        self._obstacles = []
        total = len(dense)
        for _ in range(int(n_vehicles or 0)):
            i = self._rng.randint(total // 4, total)
            cruise = self._rng.uniform(*self._npc_cruise)
            self._obstacles.append(SimObstacle(
                pos=dense[i].astype(float).copy(), radius=1.2,
                kind="vehicle", speed=cruise, route_s=float(i),
                cruise=cruise))
        for _ in range(int(n_walkers or 0)):
            i = self._rng.randint(total // 4, total)
            self._obstacles.append(SimObstacle(
                pos=dense[i] + self._rng.uniform(-3, 3, 2), radius=0.4,
                kind="walker",
                speed=self._rng.uniform(0.3, 1.2),
                heading=self._rng.uniform(0, 2 * math.pi)))

        # signalized junctions at route corners
        if self._with_traffic_lights:
            self._lights = lights_at_route_corners(pts, dense, self._rng)
            if self._light_times is not None:
                for li in self._lights:
                    li.times = self._light_times
        else:
            self._lights = []
        self._props = roadside_props(dense, self._rng) if self._with_props \
            else np.zeros((0, 6), np.float32)

        blocked_s = 180.0 if self.training else 800 * self.dt
        self._criteria = default_criteria(dense, dt=self.dt,
                                          blocked_seconds=blocked_s,
                                          lights=self._lights)
        planner = RoutePlanner(min_distance=4.0, max_distance=50.0)
        cmds = [RoadOption.LANEFOLLOW] * len(dense)
        planner.set_route_meters(dense, cmds)
        self._planner = planner

        # adversarial scenario triggers along the route
        self._control_noise = 0.0
        self._throttle_noise = 0.0
        if self._scenario_annotations:
            self._scenario_manager = ScenarioManager.from_annotations(
                self._scenario_annotations, dense, rng=self._rng)
        else:
            self._scenario_manager = None

        # in-episode sun animation (the reference's WeatherBehavior sits in
        # every scenario tree, basic_scenario.py:204-303)
        self._sun_altitude = self._sun_altitude0
        if self._animate_weather:
            if self._scenario_manager is None:
                self._scenario_manager = ScenarioManager([])
            self._scenario_manager.triggers.append(ScenarioTrigger(
                kind="weather", at_tick=1,
                builder=lambda env, rng: WeatherBehavior(
                    sun_altitude_deg=self._sun_altitude0)))

    def _planner_step(self, gps):
        return self._planner.run_step(gps)

    def spawn_scenario_actor(self, kind: str, pos: np.ndarray,
                             heading: float = 0.0, speed: float = 0.0,
                             radius: Optional[float] = None) -> SimObstacle:
        """The actor factory of the scenario behaviours: a new obstacle
        at `pos`, sized by kind unless `radius` is given."""
        if radius is None:
            radius = {"walker": 0.4, "cyclist": 0.6,
                      "static": 0.6}.get(kind, 1.2)
        ob = SimObstacle(pos=np.asarray(pos, float).copy(), radius=radius,
                         kind=kind, speed=speed, heading=heading)
        self._obstacles.append(ob)
        return ob

    def _world_step(self, control: Sequence[float]) -> None:
        steer, throttle, brake = float(control[0]), float(control[1]), \
            float(control[2])
        if self._scenario_manager is not None:
            self._scenario_manager.tick(self)
        steer = steer + self._control_noise          # ControlLoss
        steer = max(-1.0, min(1.0, steer))
        throttle = throttle + self._throttle_noise   # AddNoiseToVehicle
        throttle = max(0.0, min(1.0, throttle))
        brake = max(0.0, min(1.0, brake))

        accel = 3.5 * throttle - 8.0 * brake - 0.08 * self._speed
        self._speed = max(0.0, self._speed + accel * self.dt)
        wheel = steer * self._max_wheel
        yaw_rate = self._speed / self._wheelbase * math.tan(wheel)
        self._yaw += math.degrees(yaw_rate * self.dt)
        heading = np.array([math.cos(math.radians(self._yaw)),
                            math.sin(math.radians(self._yaw))])
        self._pos = self._pos + heading * self._speed * self.dt

        # route-driving background vehicles: kinematic car-followers on the
        # dense route (car-following gap 8 m, red-light stop within 10 m,
        # accel limit 3 m/s^2). Every hold is checked against the PRE-step
        # positions of all actors, one simultaneous snapshot, as the device
        # env does.
        dense = self._route_xy
        t_now = self._step_count * self.dt
        pre_pos = {id(ob): ob.pos.copy() for ob in self._obstacles}
        for ob in self._obstacles:
            if ob.route_s < 0 or ob.managed:
                continue
            i0 = min(int(ob.route_s), len(dense) - 2)
            seg = dense[i0 + 1] - dense[i0]
            n = float(np.hypot(*seg))
            dirn = seg / n if n > 1e-6 else np.array([1.0, 0.0])
            held = False
            for other in self._obstacles:
                if other is ob:
                    continue
                rel = pre_pos[id(other)] - pre_pos[id(ob)]
                fwd = float(rel @ dirn)
                lat = abs(float(rel[0] * dirn[1] - rel[1] * dirn[0]))
                if 0.1 < fwd < 8.0 and lat < 2.5:
                    held = True
                    break
            rel_e = self._pos - ob.pos
            fwd_e = float(rel_e @ dirn)
            lat_e = abs(float(rel_e[0] * dirn[1] - rel_e[1] * dirn[0]))
            held = held or (0.1 < fwd_e < 8.0 and lat_e < 2.5)
            if not held:
                for li in self._lights:
                    if li.state_at(t_now) != RED:
                        continue
                    sl = li.stop_lines[0]
                    rel_l = np.asarray(li.center[:2]) - ob.pos
                    fwd_l = float(rel_l @ dirn)
                    lat_l = abs(float(rel_l[0] * dirn[1]
                                      - rel_l[1] * dirn[0]))
                    if 0.0 < fwd_l < 10.0 and lat_l < 0.8 * 3.5 and \
                            float(np.asarray(sl.dir[:2]) @ dirn) > 0:
                        held = True
                        break
            target = 0.0 if held else ob.cruise
            ob.speed = max(0.0, float(np.clip(
                target, ob.speed - 3.0 * self.dt,
                ob.speed + 3.0 * self.dt)))
            ob.route_s += ob.speed * self.dt
            if ob.route_s >= len(dense) - 2:
                # recycle to the start unless the ego is within 25 m of it
                if float(np.hypot(*(dense[1] - self._pos))) > 25.0:
                    ob.route_s = 1.0
                else:
                    ob.route_s = float(len(dense) - 2)
            i0 = min(int(ob.route_s), len(dense) - 2)
            frac = ob.route_s - i0
            ob.pos = dense[i0] + frac * (dense[i0 + 1] - dense[i0])
            ob.heading = math.atan2(dirn[1], dirn[0])

        # unmanaged actors with a velocity off the route move themselves
        for ob in self._obstacles:
            if ob.kind in ("walker", "vehicle", "cyclist") and ob.speed > 0 \
                    and not ob.managed and ob.route_s < 0:
                ob.pos = ob.pos + ob.speed * self.dt * np.array(
                    [math.cos(ob.heading), math.sin(ob.heading)])

        # collision check (ego radius 1.2 m)
        self._collision = {"static": False, "vehicle": False, "walker": False}
        for ob in self._obstacles:
            if float(np.hypot(*(ob.pos - self._pos))) < ob.radius + 1.2:
                key = "walker" if ob.kind == "walker" else (
                    "static" if ob.kind == "static" else "vehicle")
                self._collision[key] = True

        # advance the light cycles on sim time
        t = self._step_count * self.dt
        for light in self._lights:
            light.state = light.state_at(t)

        # OutsideRouteLanesTest analogue: the signed lateral from the dense
        # route against the two-lane envelope, suppressed inside turns
        off_lane = (not self._turn_state.in_turn) and outside_route_lanes(
            signed_route_lateral(self._route_xy, self._pos))

        snap = VehicleSnapshot(
            pos=self._pos.copy(), yaw=self._yaw, speed=self._speed,
            collided_static=self._collision["static"],
            collided_vehicle=self._collision["vehicle"],
            collided_pedestrian=self._collision["walker"],
            forward=heading, off_lane=off_lane)
        for crit in self._criteria:
            crit.update(snap)

    def _nearest_obstacle_ahead(self) -> float:
        """Forward obstacle distance within an 11 m cone, else -1 (the
        obstacle sensor contract, env_wrapper.py:832-837)."""
        heading = np.array([math.cos(math.radians(self._yaw)),
                            math.sin(math.radians(self._yaw))])
        best = -1.0
        for ob in self._obstacles:
            rel = ob.pos - self._pos
            dist = float(np.hypot(*rel))
            if dist > 11.0 or dist < 1e-6:
                continue
            ahead = float(rel @ heading)
            if ahead <= 0:
                continue
            lateral = abs(float(rel[0] * heading[1] - rel[1] * heading[0]))
            if lateral < 1.5:
                if best < 0 or dist < best:
                    best = dist
        return best

    # reduced seg classes: 0 unlabeled, 1 road, 2 car, 3 person, 4-6 props,
    # 7 road line
    def _render_rgb(self, with_seg: bool = False):
        """Forward-view rendering: sky/ground, roadside props, the projected
        route ribbon, obstacle blobs and light heads, then the weather
        pass. With `with_seg`, also the class map [H,W]."""
        h, w = SIZE_X, SIZE_Y  # 144 x 256
        sky, brightness, noise_std = WEATHER_PRESETS.get(
            self.weather, WEATHER_PRESETS["ClearNoon"])
        # brightness follows sin(altitude) normalised to the default
        # 70-degree sun, floored at twilight
        alt = self._sun_altitude
        if alt != 70.0:
            factor = math.sin(math.radians(max(alt, 0.0))) \
                / math.sin(math.radians(70.0))
            brightness = brightness * float(np.clip(factor, 0.15, 1.05))
        img = np.zeros((h, w, 3), np.uint8)
        seg = np.zeros((h, w), np.uint8)
        img[: h // 2] = sky
        img[h // 2:] = (90, 90, 90)       # asphalt
        seg[h // 2:] = 1                  # road
        if not self.render_camera:
            return (img, seg) if with_seg else img
        yaw = math.radians(self._yaw)
        cos_y, sin_y = math.cos(yaw), math.sin(yaw)
        f = 128.0  # focal (pixels), 90-degree fov at 256 wide
        horizon = h // 2
        cam_h = 1.3
        # props first, in the device renderer's rect order, so the
        # policy-relevant pixels stay on top
        for prop in self._props:
            px, py, half_w, height, kind, shade = (float(v) for v in prop)
            relx, rely = px - self._pos[0], py - self._pos[1]
            xf = relx * cos_y + rely * sin_y
            yl = -relx * sin_y + rely * cos_y
            if xf < 2.0 or xf > 60.0:
                continue
            u = int(w / 2 - f * yl / xf)
            vg = int(horizon + f * cam_h / xf)
            vt = int(horizon - f * (height - cam_h) / xf)
            r = max(1, int(f * half_w / xf))
            color = prop_color(kind, shade)
            seg_cls = int(kind)
            u0, u1 = max(0, u - r), min(w, u + r)
            v0, v1 = max(0, vt), min(h, vg)
            if u1 > u0 and v1 > v0:
                img[v0:v1, u0:u1] = color
                seg[v0:v1, u0:u1] = seg_cls
            if kind == PROP_POLE:       # sign head box on the pole top
                rs = max(1, int(f * 0.5 / xf))
                su0, su1 = max(0, u - rs), min(w, u + rs)
                sv0, sv1 = max(0, vt - rs), min(h, vt + rs)
                if su1 > su0 and sv1 > sv0:
                    img[sv0:sv1, su0:su1] = (200, 180, 40)
                    seg[sv0:sv1, su0:su1] = 5
        # vectorised projection of the route markers
        rel = self._route_xy[::2] - self._pos
        xf_all = rel[:, 0] * cos_y + rel[:, 1] * sin_y   # forward
        yl_all = -rel[:, 0] * sin_y + rel[:, 1] * cos_y  # left(+)
        vis = (xf_all >= 1.0) & (xf_all <= 60.0)
        xf_v, yl_v = xf_all[vis], yl_all[vis]
        us = (w / 2 - f * yl_v / xf_v).astype(np.int64)
        vs = (horizon + f * cam_h / xf_v).astype(np.int64)
        rs = np.maximum(1, (24.0 / xf_v).astype(np.int64))
        on = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
        for u, v, r in zip(us[on], vs[on], rs[on]):
            img[max(0, v - r):min(h, v + r),
                max(0, u - r):min(w, u + r)] = (200, 200, 200)
            seg[max(0, v - r):min(h, v + r),
                max(0, u - r):min(w, u + r)] = 7  # road line
        for ob in self._obstacles:
            rel = ob.pos - self._pos
            xf = rel[0] * cos_y + rel[1] * sin_y
            yl = -rel[0] * sin_y + rel[1] * cos_y
            if xf < 1.0 or xf > 60.0:
                continue
            u = int(w / 2 - f * yl / xf)
            v = int(horizon + f * cam_h / xf)
            if 0 <= u < w and 0 <= v < h:
                r = max(2, int(f * ob.radius / xf))
                if ob.kind == "walker":
                    color, seg_cls = (40, 40, 200), 3
                elif ob.kind == "static":   # blocker prop renders as scenery
                    color, seg_cls = (130, 120, 110), 4
                else:                       # vehicle or cyclist
                    color, seg_cls = (200, 40, 40), 2
                img[max(0, v - 2 * r):min(h, v), max(0, u - r):min(w, u + r)] \
                    = color
                seg[max(0, v - 2 * r):min(h, v),
                    max(0, u - r):min(w, u + r)] = seg_cls
        # traffic-light heads: a coloured box on a pole ~5 m above the stop
        # line, clamped to the canvas top when the ego is close
        light_colors = {RED: (255, 30, 30), YELLOW: (255, 220, 40),
                        GREEN: (40, 255, 60)}
        for light in self._lights:
            rel = light.center - self._pos
            xf = rel[0] * cos_y + rel[1] * sin_y
            yl = -rel[0] * sin_y + rel[1] * cos_y
            if xf < 1.5 or xf > 60.0:
                continue
            u = int(w / 2 - f * yl / xf)
            v = int(horizon - f * (5.0 - cam_h) / xf)
            if not (0 <= u < w):
                continue
            r = max(2, int(f * 0.6 / xf))
            v = max(v, r)
            color = light_colors[light.state]
            v0, v1 = max(0, v - r), min(h, v + r)
            u0, u1 = max(0, u - r), min(w, u + r)
            if v1 > v0 and u1 > u0:
                img[v0:v1, u0:u1] = color
                seg[v0:v1, u0:u1] = 5        # pole/sign seg class
                # pole down to the road surface
                vg = int(horizon + f * cam_h / xf)
                img[max(0, v1):min(h, vg), max(0, u - 1):min(w, u + 1)] = \
                    (60, 60, 60)
                seg[max(0, v1):min(h, vg), max(0, u - 1):min(w, u + 1)] = 5

        # weather pass: brightness below the horizon + sensor noise
        if brightness != 1.0:
            ground = img[h // 2:].astype(np.int16)
            img[h // 2:] = (ground * brightness).astype(np.uint8)
        if noise_std > 0:
            noise = self._rng.randn(h, w, 3) * noise_std
            img = np.clip(img.astype(np.int16) + noise.astype(np.int16),
                          0, 255).astype(np.uint8)
        return (img, seg) if with_seg else img

    def _world_tick(self) -> Dict[str, Any]:
        # compass = yaw: the draw rotation adds pi/2, mapping ego-forward to
        # "up" on the 256-tall canvas
        yaw_rad = math.radians(self._yaw)
        fwd = np.array([math.cos(yaw_rad), math.sin(yaw_rad)])
        light_state, light_dist = nearest_light_ahead(
            self._lights, self._pos, fwd)
        return {
            "rgb": self._render_rgb(),
            "gps": self._pos.copy(),
            "full_gps": np.array([self._pos[0], self._pos[1], 0.0]),
            "speed": self._speed,
            "compass": yaw_rad,
            "forward": fwd,
            "imu": [0.0, 0.0, 0.0, self._yaw],
            "obstacle": self._nearest_obstacle_ahead(),
            "light_state": light_state,
            "light_dist": light_dist,
            "target_diff": 0,
            "topdown_seg": None,
        }

    def _cleanup_episode(self) -> None:
        super()._cleanup_episode()
        if isinstance(self.route_indexer, PriorityRouteIndexer) and \
                self._current_config is not None:
            for crit in self._criteria:
                if crit.name == "RouteCompletionTest":
                    self.route_indexer.update_route(
                        self._current_config.index, crit.actual_value,
                        crit.current_index)
