"""Route planner of the host env.

numpy copy of the JAX package's host planner (leaderboard
team_code/planner.py:240-355 contract) for a route in meters: a deque of
(position, RoadOption); `run_step(gps)` pops the waypoints passed within
`min_distance` and returns (near_node, near_command, route_list up to
`max_distance` of cumulative length ahead). The GPS form of the plan
(`set_route`) comes with the CARLA env (ROADMAP.md queue A item 17).
"""
from __future__ import annotations

from collections import deque
from typing import List, Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.road_option import RoadOption


class RoutePlanner:
    def __init__(self, min_distance: float, max_distance: float):
        self.route: deque = deque()
        self.min_distance = min_distance
        self.max_distance = max_distance

    def set_route_meters(self, points: Sequence[Tuple[float, float]],
                         commands: Sequence[RoadOption]) -> None:
        """The route in meters: (point, command) pairs."""
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
