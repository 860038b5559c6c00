"""Leaderboard-style autonomous-agent container (the port's copy of the
JAX package's host `envs/autonomous_agent.py`).

Role: leaderboard/autoagents/autonomous_agent.py + agent_wrapper.py: the
standard agent API (a sensors() spec and run_step(input_data, timestamp)
-> control) that plugs an agent into the route harness, with sensor
configuration validation. The training path bypasses it (the env drives
the agent directly); the harness agents of `envs/autoagents.py` run on it.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

import numpy as np

from cadre_tpu_torch.envs.route_parser import downsample_route


class Track(enum.Enum):
    SENSORS = "SENSORS"
    MAP = "MAP"


class AutonomousAgent:
    def __init__(self, path_to_conf_file: Optional[str] = None):
        self.track = Track.SENSORS
        self._global_plan = None
        self._global_plan_world_coord = None
        self.wallclock_t0 = None
        self.setup(path_to_conf_file)

    # -------- to be overridden --------

    def setup(self, path_to_conf_file: Optional[str]) -> None:
        pass

    def sensors(self) -> List[Dict[str, Any]]:
        """Sensor spec dicts (id/type/x/y/z/... per DEFAULT_SENSORS)."""
        return []

    def run_step(self, input_data: Dict[str, Any], timestamp: float
                 ) -> List[float]:
        """-> [steer, throttle, brake]."""
        raise NotImplementedError

    def destroy(self) -> None:
        pass

    # -------- harness plumbing --------

    def set_global_plan(self, global_plan_gps, global_plan_world_coord
                        ) -> None:
        # keep the pre-downsample plan too: the reference's NpcAgent
        # re-derives dense geometry from the CARLA map (BasicAgent
        # _trace_route) between the 50 m-sparse points; in the synthetic
        # world the dense plan IS that map geometry (and the reference
        # EnvWrapper itself feeds the dense `_plan_gps_HACK` to its
        # planner, env_wrapper.py:346-354)
        self._raw_plan_world_coord = list(global_plan_world_coord)
        xy = np.asarray([(p[0].location.x, p[0].location.y)
                         if hasattr(p[0], "location") else p[0][:2]
                         for p in global_plan_world_coord])
        ds_ids = downsample_route(xy, 50)
        self._global_plan_world_coord = [global_plan_world_coord[x]
                                         for x in ds_ids]
        self._global_plan = [global_plan_gps[x] for x in ds_ids]


def validate_sensor_configuration(sensors: List[Dict[str, Any]],
                                  track: Track = Track.SENSORS) -> None:
    """Sensor validation (agent_wrapper.py role): unique ids, allowed types,
    bounded extrinsics."""
    allowed = {
        "sensor.camera.rgb", "sensor.lidar.ray_cast", "sensor.other.radar",
        "sensor.other.gnss", "sensor.other.imu", "sensor.opendrive_map",
        "sensor.speedometer", "sensor.other.obstacle",
    }
    seen = set()
    for spec in sensors:
        sid = spec.get("id")
        if sid in seen:
            raise ValueError(f"duplicated sensor id {sid!r}")
        seen.add(sid)
        stype = spec.get("type", "")
        if stype not in allowed:
            raise ValueError(f"illegal sensor type {stype!r}")
        if track == Track.SENSORS and stype == "sensor.opendrive_map":
            raise ValueError("opendrive_map sensor requires MAP track")
        for axis in ("x", "y", "z"):
            if abs(float(spec.get(axis, 0.0))) > 3.0:
                raise ValueError(
                    f"sensor {sid!r} {axis} offset exceeds 3 m limit")
