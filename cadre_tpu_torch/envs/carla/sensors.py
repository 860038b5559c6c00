"""Thread-safe sensor fan-in for CARLA streams.

A copy of the JAX package's module.

Contract: leaderboard/envs/sensor_interface.py — per-sensor callbacks parse
carla data to numpy and push (tag, frame, data) into a queue; `get_data`
blocks until every registered sensor has delivered the current frame
(timeout 60 s); the obstacle sensor is a latched buffer cleared explicitly
(`clear_obstacle`, used by env_wrapper.py:922); the speedometer is a
pseudo-sensor projecting velocity onto the vehicle heading
(sensor_interface.py:91-126).
"""
from __future__ import annotations

import copy
import math
import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np


class SensorConfigurationInvalid(Exception):
    pass


class SensorReceivedNoData(Exception):
    pass


class SensorInterface:
    def __init__(self, timeout: float = 60.0):
        self._sensors: Dict[str, Any] = {}
        self._queue: "queue.Queue" = queue.Queue()
        self._timeout = timeout
        self._obstacle: Tuple[int, Any] = (-1, None)
        self._lock = threading.Lock()

    def register_sensor(self, tag: str, sensor) -> None:
        if tag in self._sensors:
            raise SensorConfigurationInvalid(f"duplicated sensor tag {tag}")
        self._sensors[tag] = sensor

    def update_sensor(self, tag: str, data, frame: int) -> None:
        if tag not in self._sensors:
            raise SensorConfigurationInvalid(f"sensor {tag} not registered")
        if tag == "obstacle":
            with self._lock:
                self._obstacle = (frame, data)
            return
        self._queue.put((tag, frame, data))

    def clear_obstacle(self, tag: str = "obstacle") -> None:
        with self._lock:
            self._obstacle = (-1, None)

    def get_data(self) -> Dict[str, Tuple[int, Any]]:
        """Block until every non-obstacle sensor delivered a frame."""
        data: Dict[str, Tuple[int, Any]] = {}
        expected = {t for t in self._sensors if t != "obstacle"}
        t0 = time.time()
        try:
            while len(data) < len(expected):
                remaining = self._timeout - (time.time() - t0)
                if remaining <= 0:
                    raise SensorReceivedNoData(
                        "sensor data wait exceeded timeout")
                tag, frame, payload = self._queue.get(True, remaining)
                data[tag] = (frame, payload)
        except queue.Empty:
            raise SensorReceivedNoData("sensor data wait exceeded timeout")
        with self._lock:
            frame, payload = self._obstacle
            data["obstacle"] = (frame, payload) if payload is not None \
                else (-1, (np.array([-1.0]), None))
        return data

    def destroy(self) -> None:
        self._sensors = {}
        self._queue = queue.Queue()


class CallBack:
    """Parses carla sensor payloads to numpy (sensor_interface.py:134-210)."""

    def __init__(self, tag: str, sensor_type: str, sensor,
                 interface: SensorInterface):
        self._tag = tag
        self._type = sensor_type
        self._interface = interface
        interface.register_sensor(tag, sensor)

    def __call__(self, data) -> None:
        t = self._type
        if t.startswith("sensor.camera"):
            arr = np.frombuffer(data.raw_data, dtype=np.uint8)
            arr = copy.deepcopy(arr).reshape(data.height, data.width, 4)
            self._interface.update_sensor(self._tag, arr, data.frame)
        elif t.startswith("sensor.lidar"):
            pts = np.frombuffer(data.raw_data, dtype=np.float32)
            pts = copy.deepcopy(pts).reshape(-1, 4)
            self._interface.update_sensor(self._tag, pts, data.frame)
        elif t.startswith("sensor.other.gnss"):
            arr = np.array([data.latitude, data.longitude, data.altitude],
                           np.float64)
            self._interface.update_sensor(self._tag, arr, data.frame)
        elif t.startswith("sensor.other.imu"):
            # rotation.yaw is already degrees (sensor_interface.py:194-198);
            # compass is radians from north
            arr = np.array([
                data.accelerometer.x, data.accelerometer.y,
                data.accelerometer.z,
                data.transform.rotation.yaw
                if hasattr(data, "transform") else 0.0,
                data.compass,
            ], np.float64)
            self._interface.update_sensor(self._tag, arr, data.frame)
        elif t.startswith("sensor.other.obstacle"):
            self._interface.update_sensor(
                self._tag, (np.array([data.distance]), data.other_actor),
                data.frame)
        else:
            self._interface.update_sensor(self._tag, data, data.frame)


class SpeedometerReader:
    """Pseudo-sensor thread projecting velocity onto heading
    (sensor_interface.py:91-126)."""

    MAX_RETRIES = 10

    def __init__(self, vehicle, frame_rate: float,
                 interface: SensorInterface, tag: str = "speed"):
        self._vehicle = vehicle
        self._interface = interface
        self._tag = tag
        self._period = 1.0 / frame_rate
        self._running = False
        self._thread: Optional[threading.Thread] = None
        interface.register_sensor(tag, self)

    def _speed(self) -> float:
        attempts = 0
        while attempts < self.MAX_RETRIES:
            try:
                velocity = self._vehicle.get_velocity()
                transform = self._vehicle.get_transform()
                yaw = math.radians(transform.rotation.yaw)
                pitch = math.radians(transform.rotation.pitch)
                fwd = np.array([
                    math.cos(pitch) * math.cos(yaw),
                    math.cos(pitch) * math.sin(yaw),
                    math.sin(pitch)])
                v = np.array([velocity.x, velocity.y, velocity.z])
                return float(v @ fwd)
            except Exception:
                attempts += 1
                time.sleep(0.2)
        return 0.0

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        frame = 0
        while self._running:
            frame += 1
            self._interface.update_sensor(
                self._tag, {"speed": self._speed()}, frame)
            time.sleep(self._period)

    def stop(self) -> None:
        self._running = False

    def destroy(self) -> None:
        self.stop()
