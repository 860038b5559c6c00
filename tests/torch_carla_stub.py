"""In-process fake of the `carla` RPC client API, for the port.

A copy of tests/carla_stub.py whose grid map comes from
cadre_tpu_torch.envs.town_maps, so that it imports nothing of the JAX
package (chip_smoke.py installs it as `carla` on the GPU machine).

The subset CadreTPU's CARLA-facing code touches (CarlaDrivingEnv,
CarlaProvider, sensors, scenario actors), backed by a tiny deterministic
world: one straight east-west road along y=0, an optional signalized
junction, bicycle-model ego physics at the synchronous fixed delta, and
per-tick synthetic sensor streams (camera/gnss/imu + collision overlap
events). This is the contract-test seam the reference never had: it lets CI
drive reset -> trigger -> scenario-spawn -> infraction end-to-end without a
server (the reference requires a live CARLA binary for any of this).

Geo convention matches CARLA town geo-references as the env consumes them:
latitude = 49 - y/S, longitude = 49 + x/S so that the GPS-meter plane is
(-y, x) and a world heading (cos t, sin t) maps to (-sin t, cos t).

Install with `install(monkeypatch_or_none)` / `sys.modules['carla'] = make_module()`.
"""
from __future__ import annotations

import math
import sys
import types
import weakref

import numpy as np

GPS_S = 111324.60662786


class Location:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)

    def distance(self, other):
        return math.sqrt((self.x - other.x) ** 2 + (self.y - other.y) ** 2
                         + (self.z - other.z) ** 2)

    def __add__(self, other):
        return Location(self.x + other.x, self.y + other.y, self.z + other.z)

    def __repr__(self):
        return f"Location({self.x:.2f}, {self.y:.2f}, {self.z:.2f})"


class Rotation:
    def __init__(self, pitch=0.0, yaw=0.0, roll=0.0):
        self.pitch, self.yaw, self.roll = float(pitch), float(yaw), float(roll)


class Vector3D:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)


class Transform:
    def __init__(self, location=None, rotation=None):
        self.location = location or Location()
        self.rotation = rotation or Rotation()

    def get_forward_vector(self):
        yaw = math.radians(self.rotation.yaw)
        return Vector3D(math.cos(yaw), math.sin(yaw), 0.0)

    def transform(self, loc):
        """Apply this transform (yaw-only) to a local-frame location."""
        yaw = math.radians(self.rotation.yaw)
        c, s = math.cos(yaw), math.sin(yaw)
        return Location(self.location.x + c * loc.x - s * loc.y,
                        self.location.y + s * loc.x + c * loc.y,
                        self.location.z + loc.z)


class BoundingBox:
    def __init__(self, location=None, extent=None):
        self.location = location or Location()
        self.extent = extent or Vector3D(2.45, 1.0, 0.8)


class VehicleControl:
    def __init__(self, steer=0.0, throttle=0.0, brake=0.0):
        self.steer, self.throttle, self.brake = steer, throttle, brake
        self.manual_gear_shift = False
        self.hand_brake = False


class _TLState:
    def __init__(self, name):
        self._name = name

    def __repr__(self):
        return f"TrafficLightState.{self._name}"

    def __str__(self):
        return self._name


class TrafficLightState:
    Red = _TLState("Red")
    Yellow = _TLState("Yellow")
    Green = _TLState("Green")
    Off = _TLState("Off")
    Unknown = _TLState("Unknown")


class LaneType:
    Driving = 1
    Sidewalk = 2


class GeoLocation:
    def __init__(self, latitude, longitude, altitude=0.0):
        self.latitude, self.longitude = latitude, longitude
        self.altitude = altitude


_NEXT_ID = [1]


class Actor:
    def __init__(self, world, type_id, transform, rolename="scenario"):
        self.id = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        self.type_id = type_id
        self._world = world
        self._transform = Transform(
            Location(transform.location.x, transform.location.y,
                     transform.location.z),
            Rotation(transform.rotation.pitch, transform.rotation.yaw,
                     transform.rotation.roll))
        self.is_alive = True
        self.attributes = {"role_name": rolename}
        self.bounding_box = BoundingBox()
        self._velocity = Vector3D()
        self._autopilot = False

    def get_transform(self):
        return self._transform

    def set_transform(self, tf):
        self._transform = tf

    def get_location(self):
        return self._transform.location

    def get_velocity(self):
        return self._velocity

    def get_world(self):
        return self._world

    def set_autopilot(self, enabled=True, tm_port=None):
        self._autopilot = enabled

    def destroy(self):
        self.is_alive = False
        self._world._actors = [a for a in self._world._actors if a is not self]
        return True


class Vehicle(Actor):
    """Bicycle-model physics stepped by the world tick."""

    def __init__(self, world, type_id, transform, rolename="scenario"):
        super().__init__(world, type_id, transform, rolename)
        self._control = VehicleControl()
        self._speed = 0.0
        self._wheelbase = 2.9

    def apply_control(self, vc):
        self._control = vc

    def get_control(self):
        return self._control

    def _physics_step(self, dt):
        c = self._control
        accel = 3.5 * c.throttle - 8.0 * c.brake - 0.08 * self._speed
        self._speed = max(0.0, self._speed + accel * dt)
        yaw = math.radians(self._transform.rotation.yaw)
        wheel = c.steer * math.radians(35.0)
        yaw_rate = self._speed / self._wheelbase * math.tan(wheel)
        yaw += yaw_rate * dt
        loc = self._transform.location
        loc.x += math.cos(yaw) * self._speed * dt
        loc.y += math.sin(yaw) * self._speed * dt
        self._transform.rotation.yaw = math.degrees(yaw)
        self._velocity = Vector3D(math.cos(yaw) * self._speed,
                                  math.sin(yaw) * self._speed, 0.0)


class Walker(Actor):
    pass


class TrafficLight(Actor):
    def __init__(self, world, transform, trigger_extent=(4.0, 1.5, 1.0)):
        super().__init__(world, "traffic.traffic_light", transform)
        self.trigger_volume = BoundingBox(
            Location(0.0, 0.0, 0.0), Vector3D(*trigger_extent))
        self._state = TrafficLightState.Green
        self.times = {}

    def get_state(self):
        return self._state

    def set_state(self, state):
        self._state = state

    def set_green_time(self, t):
        self.times["green"] = t

    def get_green_time(self):
        return self.times.get("green", 10.0)

    def set_red_time(self, t):
        self.times["red"] = t

    def get_red_time(self):
        return self.times.get("red", 2.0)

    def set_yellow_time(self, t):
        self.times["yellow"] = t

    def get_yellow_time(self):
        return self.times.get("yellow", 3.0)

    def get_group_traffic_lights(self):
        return [self]


class StopSign(Actor):
    def __init__(self, world, transform, trigger_extent=(2.0, 2.0, 1.0)):
        super().__init__(world, "traffic.stop", transform)
        self.trigger_volume = BoundingBox(
            Location(0.0, 0.0, 0.0), Vector3D(*trigger_extent))


class _SensorData:
    pass


class Sensor(Actor):
    def __init__(self, world, type_id, transform, parent, attrs):
        super().__init__(world, type_id, transform)
        self._parent = parent
        self._callback = None
        self._attrs = attrs

    def listen(self, callback):
        self._callback = callback

    def stop(self):
        self._callback = None

    def _emit(self, frame):
        if self._callback is None or self._parent is None:
            return
        t = self.type_id
        parent_tf = self._parent.get_transform()
        d = _SensorData()
        d.frame = frame
        if t.startswith("sensor.camera.rgb"):
            h = int(self._attrs.get("image_size_y", 144))
            w = int(self._attrs.get("image_size_x", 256))
            img = self._world._render_camera(self._parent, h, w)
            d.raw_data = img.tobytes()
            d.height, d.width = h, w
        elif t.startswith("sensor.other.gnss"):
            loc = parent_tf.location
            d.latitude = 49.0 - loc.y / GPS_S
            d.longitude = 49.0 + loc.x / GPS_S
            d.altitude = loc.z
        elif t.startswith("sensor.other.imu"):
            yaw = math.radians(parent_tf.rotation.yaw)
            d.accelerometer = Vector3D(0.0, 0.0, 9.81)
            d.gyroscope = Vector3D()
            d.transform = parent_tf
            # radians from geographic north (+lat = -y), clockwise to east
            d.compass = math.atan2(math.cos(yaw), -math.sin(yaw)) % (2 * math.pi)
        elif t.startswith("sensor.other.obstacle"):
            hit = self._world._nearest_obstacle(self._parent)
            if hit is None:
                return  # obstacle sensor only fires on detection
            d.distance, d.other_actor = hit
        elif t.startswith("sensor.other.collision"):
            other = self._world._collision_for(self._parent)
            if other is None:
                return
            d.other_actor = other
            d.normal_impulse = Vector3D(1.0, 0.0, 0.0)
        else:
            return
        self._callback(d)


class Blueprint:
    def __init__(self, bp_id):
        self.id = bp_id
        self._attrs = {}

    def has_attribute(self, name):
        return True

    def set_attribute(self, name, value):
        self._attrs[name] = value

    def get_attribute(self, name):
        class _A:
            recommended_values = ["0,0,0"]

        return _A()


class BlueprintLibrary:
    _KNOWN = ["vehicle.lincoln.mkz2017", "vehicle.tesla.model3",
              "vehicle.diamondback.century",
              "static.prop.vendingmachine", "static.prop.container",
              "walker.pedestrian.0001", "sensor.camera.rgb",
              "sensor.other.imu", "sensor.other.gnss",
              "sensor.other.obstacle", "sensor.other.collision"]

    def filter(self, pattern):
        import fnmatch

        return [Blueprint(k) for k in self._KNOWN
                if fnmatch.fnmatch(k, pattern)]

    def find(self, bp_id):
        return Blueprint(bp_id)


class Waypoint:
    def __init__(self, world_map, x, y, lane_width=3.5):
        self._map = world_map
        # snap to the road axis y=0, heading +x
        self.transform = Transform(Location(x, 0.0, 0.0), Rotation(yaw=0.0))
        self.road_id = 0
        self.lane_id = -1
        self.lane_width = lane_width
        self.is_intersection = world_map._in_junction(x)
        self.is_junction = self.is_intersection

    def next(self, dist):
        return [Waypoint(self._map, self.transform.location.x + dist, 0.0)]


class Map:
    """One straight east-west road on y=0; junction at [jx, jx+20]."""

    def __init__(self, name="Town01", junction_x=None):
        self.name = name
        self._junction_x = junction_x

    def _in_junction(self, x):
        return self._junction_x is not None and \
            self._junction_x <= x <= self._junction_x + 20.0

    def get_waypoint(self, location, project_to_road=True, lane_type=None):
        if not project_to_road and abs(location.y) > 5.0:
            return None
        return Waypoint(self, location.x, location.y)

    def get_spawn_points(self):
        return [Transform(Location(20.0 * i, 0.0, 0.3)) for i in range(5)]

    def transform_to_geolocation(self, location):
        return GeoLocation(49.0 - location.y / GPS_S,
                           49.0 + location.x / GPS_S, location.z)


# Grid-road town map with real lane topology — framework implementation
# (cadre_tpu_torch/envs/town_maps.py); re-exported here so contract tests
# build worlds whose dense-trace branch runs against it.
from cadre_tpu_torch.envs.town_maps import (  # noqa: E402,F401
    GridTownMap,
    GridWaypoint,
)


class _Timestamp:
    def __init__(self, frame, delta):
        self.frame = frame
        self.delta_seconds = delta
        self.elapsed_seconds = frame * delta


class _Snapshot:
    def __init__(self, frame, delta):
        self.timestamp = _Timestamp(frame, delta)


class _ActorList(list):
    def filter(self, pattern):
        import fnmatch

        return _ActorList(a for a in self
                          if fnmatch.fnmatch(a.type_id, pattern))


class WorldSettings:
    def __init__(self):
        self.synchronous_mode = False
        self.fixed_delta_seconds = None
        self.no_rendering_mode = False


class World:
    def __init__(self, town="Town01", junction_x=None, map_obj=None):
        self._map = map_obj if map_obj is not None \
            else Map(town, junction_x=junction_x)
        self._settings = WorldSettings()
        self._actors = _ActorList()
        self._frame = 0
        self._bp = BlueprintLibrary()
        self._spectator = Actor(self, "spectator", Transform())
        self._collisions = {}  # actor id -> other actor (this tick)

    # -- api --
    def get_map(self):
        return self._map

    def get_settings(self):
        return self._settings

    def apply_settings(self, s):
        self._settings = s

    def get_blueprint_library(self):
        return self._bp

    def get_spectator(self):
        return self._spectator

    def get_actors(self):
        return _ActorList(self._actors)

    def get_snapshot(self):
        return _Snapshot(self._frame, self._settings.fixed_delta_seconds
                         or 0.05)

    def get_random_location_from_navigation(self):
        return None  # no walker navmesh in the stub

    def try_spawn_actor(self, bp, transform, parent=None):
        bid = bp.id
        if bid.startswith("sensor."):
            actor = Sensor(self, bid, transform, parent, bp._attrs)
        elif bid.startswith("walker."):
            actor = Walker(self, bid, transform)
        elif bid.startswith("vehicle."):
            actor = Vehicle(self, bid, transform,
                            bp._attrs.get("role_name", "scenario"))
        elif "traffic_light" in bid:
            actor = TrafficLight(self, transform)
        else:
            actor = Actor(self, bid, transform)
        self._actors.append(actor)
        return actor

    def spawn_actor(self, bp, transform, parent=None):
        actor = self.try_spawn_actor(bp, transform, parent)
        if actor is None:
            raise RuntimeError("spawn failed")
        return actor

    def tick(self, timeout=None):
        dt = self._settings.fixed_delta_seconds or 0.05
        self._frame += 1
        self._collisions = {}
        for a in list(self._actors):
            if isinstance(a, Vehicle) and not isinstance(a, Sensor):
                a._physics_step(dt)
        # overlap-based collision detection for heroes
        for a in self._actors:
            if not isinstance(a, Vehicle) or \
                    a.attributes.get("role_name") != "hero":
                continue
            for b in self._actors:
                if b is a or isinstance(b, (Sensor, TrafficLight, StopSign)) \
                        or b.type_id == "spectator":
                    continue
                if not isinstance(b, (Vehicle, Walker, Actor)):
                    continue
                ra = 2.0
                rb = 0.5 if isinstance(b, Walker) else 2.0
                if a.get_location().distance(b.get_location()) < ra + rb:
                    self._collisions[a.id] = b
                    break
        for a in list(self._actors):
            if isinstance(a, Sensor):
                a._emit(self._frame)
        return self._frame

    # -- stub internals --
    def _render_camera(self, parent, h, w):
        img = np.full((h, w, 4), 90, np.uint8)
        img[: h // 2] = (235, 180, 135, 255)  # BGRA sky
        return img

    def _nearest_obstacle(self, parent):
        yaw = math.radians(parent.get_transform().rotation.yaw)
        fwd = np.array([math.cos(yaw), math.sin(yaw)])
        ploc = parent.get_location()
        best = None
        for b in self._actors:
            if b is parent or isinstance(b, (Sensor, TrafficLight, StopSign)) \
                    or b.type_id == "spectator":
                continue
            if not (b.type_id.startswith("vehicle")
                    or b.type_id.startswith("walker")):
                continue
            rel = np.array([b.get_location().x - ploc.x,
                            b.get_location().y - ploc.y])
            dist = float(np.hypot(*rel))
            if dist > 11.0 or dist < 1e-6 or float(rel @ fwd) <= 0:
                continue
            lateral = abs(float(rel[0] * fwd[1] - rel[1] * fwd[0]))
            if lateral < 1.5 and (best is None or dist < best[0]):
                best = (dist, b)
        return best

    def _collision_for(self, parent):
        return self._collisions.get(parent._parent.id
                                    if isinstance(parent, Sensor)
                                    else parent.id)


class TrafficManager:
    def __init__(self, port):
        self._port = port

    def set_synchronous_mode(self, enabled):
        pass

    def set_random_device_seed(self, seed):
        pass

    def get_port(self):
        return self._port


class Client:
    # class-level hook: tests pre-install worlds keyed by port
    _worlds = {}

    def __init__(self, host, port):
        self._port = port
        self._world = Client._worlds.get(port) or World()

    def set_timeout(self, t):
        pass

    def load_world(self, town):
        if self._port not in Client._worlds:
            self._world = World(town)
        return self._world

    def get_world(self):
        return self._world

    def get_trafficmanager(self, port):
        return TrafficManager(port)

    def start_recorder(self, name):
        self.recorder_file = name

    def stop_recorder(self):
        self.recorder_file = None


def make_module():
    mod = types.ModuleType("carla")
    for name, obj in globals().items():
        if isinstance(obj, type) or name in ("TrafficLightState",):
            mod.__dict__[name] = obj
    mod.Location = Location
    mod.Rotation = Rotation
    mod.Transform = Transform
    mod.Vector3D = Vector3D
    mod.VehicleControl = VehicleControl
    mod.TrafficLightState = TrafficLightState
    mod.LaneType = LaneType
    mod.Client = Client
    return mod


def install():
    """Register the stub as `carla` in sys.modules (idempotent)."""
    mod = make_module()
    sys.modules["carla"] = mod
    return mod
