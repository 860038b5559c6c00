"""Route XML and scenario JSON parsing, and straight-line route
densification.

numpy copy of the JAX package's host route parser
(leaderboard/utils/route_parser.py:23-90 contract): route files are

  <routes><route id=".." map=".."><waypoint x=".." y=".." z=".." .../>
  </route></routes>

and scenario files the leaderboard's available_scenarios JSON:

  {"available_scenarios": [{"<town>": [{"scenario_type": "Scenario3",
    "available_event_configurations": [{"transform": {"x": .., "y": ..,
    "z": .., "yaw": ..}, "other_actors": ..}, ...]}, ...]}]}
"""
from __future__ import annotations

import dataclasses
import json
import os
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Waypoint:
    x: float
    y: float
    z: float = 0.0
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0

    @property
    def xy(self) -> np.ndarray:
        return np.array([self.x, self.y])


@dataclasses.dataclass
class RouteConfig:
    """One route: its name, town and sparse keypoint trajectory. The host
    env's indexers fill in the rest: `index`, the background traffic
    (`vehicle_num`, `walker_num`) and `st`, the curriculum's resume
    waypoint (priority_route_indexer.py:42-49)."""

    name: str
    town: str
    trajectory: List[Waypoint]
    index: int = 0
    vehicle_num: Optional[int] = None
    walker_num: Optional[int] = None
    st: Optional[int] = None
    scenario_file: Optional[str] = None


def parse_routes_file(routes_file: str,
                      scenario_file: Optional[str] = None
                      ) -> List[RouteConfig]:
    """Every <route> of the file, in file order, each carrying
    `scenario_file`."""
    configs = []
    for route in ET.parse(routes_file).iter("route"):
        wps = [Waypoint(x=float(w.attrib["x"]), y=float(w.attrib["y"]),
                        z=float(w.attrib.get("z", 0.0)),
                        yaw=float(w.attrib.get("yaw", 0.0)),
                        pitch=float(w.attrib.get("pitch", 0.0)),
                        roll=float(w.attrib.get("roll", 0.0)))
               for w in route.iter("waypoint")]
        configs.append(RouteConfig(name="RouteScenario_" + route.attrib["id"],
                                   town=route.attrib.get("map", "Town01"),
                                   trajectory=wps,
                                   scenario_file=scenario_file))
    return configs


def parse_scenario_file(scenario_file: str, town: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Flatten an available_scenarios JSON into one dict per event
    configuration: type, town, x, y, z, yaw and other_actors. A directory
    reads every `.json` in it, in name order; `town` keeps that town's
    scenarios only."""
    if os.path.isdir(scenario_file):
        out = []
        for fn in sorted(os.listdir(scenario_file)):
            if fn.endswith(".json"):
                out.extend(parse_scenario_file(
                    os.path.join(scenario_file, fn), town))
        return out
    with open(scenario_file) as f:
        blob = json.load(f)
    out = []
    for town_blob in blob.get("available_scenarios", []):
        for town_name, scenarios in town_blob.items():
            if town is not None and town_name != town:
                continue
            for sc in scenarios:
                stype = sc.get("scenario_type")
                for cfg in sc.get("available_event_configurations", []):
                    tf = cfg.get("transform", {})
                    out.append({
                        "type": stype,
                        "town": town_name,
                        "x": float(tf.get("x", 0)),
                        "y": float(tf.get("y", 0)),
                        "z": float(tf.get("z", 0)),
                        "yaw": float(tf.get("yaw", 0)),
                        "other_actors": cfg.get("other_actors"),
                    })
    return out


def interpolate_route(points: np.ndarray, resolution: float = 1.0
                      ) -> np.ndarray:
    """Densify a keypoint polyline to about `resolution`-meter spacing."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) < 2:
        return pts
    out = [pts[0]]
    for a, b in zip(pts[:-1], pts[1:]):
        seg = b - a
        dist = float(np.hypot(*seg))
        n = max(1, int(dist // resolution))
        for i in range(1, n + 1):
            out.append(a + seg * (i / n))
    return np.asarray(out)


def downsample_route(route_xy: np.ndarray, sample_factor: float = 50.0
                     ) -> List[int]:
    """Indices of waypoints about `sample_factor` meters apart, the
    endpoints kept (leaderboard route_manipulation.downsample_route)."""
    ids = [0]
    dist = 0.0
    for i in range(1, len(route_xy)):
        dist += float(np.hypot(*(route_xy[i] - route_xy[i - 1])))
        if dist > sample_factor:
            ids.append(i)
            dist = 0.0
    if ids[-1] != len(route_xy) - 1:
        ids.append(len(route_xy) - 1)
    return ids
