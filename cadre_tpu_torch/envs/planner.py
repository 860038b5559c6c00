"""Route planner of the host env.

numpy copy of the JAX package's host planner (leaderboard
team_code/planner.py:240-355 contract): a deque of (position, RoadOption)
built from the global plan, GPS lat/lon de-meaned and scaled to meters
(`set_route`, the CARLA env's) or a route already in meters
(`set_route_meters`, the sim env's); `run_step(gps)` pops the waypoints
passed within `min_distance` and returns (near_node, near_command,
route_list up to `max_distance` of cumulative length ahead).
"""
from __future__ import annotations

from collections import deque
from typing import List, Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.road_option import RoadOption

# CARLA gps -> meters conversion of the reference (planner.py:248-249)
GPS_MEAN = np.array([49.0, 49.0])
GPS_SCALE = np.array([111324.60662786, 111324.60662786])


class RoutePlanner:
    def __init__(self, min_distance: float, max_distance: float):
        self.route: deque = deque()
        self.min_distance = min_distance
        self.max_distance = max_distance
        self.mean = GPS_MEAN.copy()
        self.scale = GPS_SCALE.copy()

    def set_route(self, global_plan: Sequence[Tuple], gps: bool = False
                  ) -> None:
        """global_plan: [({'lat','lon'} | (x, y), RoadOption), ...]."""
        self.route.clear()
        for pos, cmd in global_plan:
            if gps:
                p = np.array([pos["lat"], pos["lon"]], dtype=np.float64)
                p = (p - self.mean) * self.scale
            else:
                p = np.asarray(pos, dtype=np.float64)[:2] - self.mean
            self.route.append((p, cmd))

    def set_route_meters(self, points: Sequence[Tuple[float, float]],
                         commands: Sequence[RoadOption]) -> None:
        """The route in meters: (point, command) pairs; the planner's
        mean and scale become 0 and 1, as the JAX planner's do."""
        self.mean = np.zeros(2)
        self.scale = np.ones(2)
        self.route.clear()
        for p, c in zip(points, commands):
            self.route.append((np.asarray(p, dtype=np.float64), c))

    def run_step(self, gps: np.ndarray
                 ) -> Tuple[np.ndarray, RoadOption, List[np.ndarray]]:
        """(near_node, near_command, route_list ahead) (planner.py:312-355),
        vectorised over the lookahead window."""
        if len(self.route) == 1:
            return self.route[0][0], self.route[0][1], [self.route[0][0]]

        # at most the window that can fit max_distance (1 m-dense routes)
        # plus slack for sparse ones
        window = min(len(self.route), int(self.max_distance) * 3 + 2)
        pts = np.asarray([self.route[i][0] for i in range(window)])
        seg = np.hypot(*(pts[1:] - pts[:-1]).T)
        cumulative = np.cumsum(seg)
        # the reference's loop breaks AFTER adding the first point past
        # max_distance
        n_ahead = int(np.searchsorted(cumulative, self.max_distance)) + 1
        n_ahead = min(n_ahead + 1, len(pts))

        dist = np.hypot(*(pts[1:n_ahead] - gps).T)
        in_range = dist <= self.min_distance
        to_pop = int(np.argmax(dist * in_range)) + 1 if in_range.any() else 0

        route_list = [pts[i] for i in range(n_ahead)]
        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()
                del route_list[0]
        return self.route[1][0], self.route[1][1], route_list
