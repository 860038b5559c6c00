"""Route indexers of the host env: sequential (eval) and the priority
curriculum (training).

numpy copy of the JAX package's host indexers:
  - RouteIndexer (leaderboard/utils/route_indexer.py:6-41): sequential
    round-robin over the parsed routes.
  - PriorityRouteIndexer (leaderboard/utils/priority_route_indexer.py:
    11-61): each route twice (with traffic / without); next() draws
    uniformly with probability eps = 0.2, else from the softmax of the
    priorities 100 - completion; update_route keeps the curriculum's resume
    waypoint `st`.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np

from cadre_tpu_torch.envs.route_parser import RouteConfig, parse_routes_file


class RouteIndexer:
    """Sequential eval indexer."""

    def __init__(self, routes_file: str, scenario_file: Optional[str] = None,
                 vehicle_num: Optional[Sequence[int]] = None):
        if vehicle_num is None:
            vehicle_num = (None, None)
        configs = parse_routes_file(routes_file, scenario_file)
        self._configs: List[RouteConfig] = []
        for i, cfg in enumerate(configs):
            cfg.index = i
            cfg.vehicle_num = vehicle_num[0]
            cfg.walker_num = vehicle_num[1]
            self._configs.append(cfg)
        self._index = 0

    def __len__(self) -> int:
        return len(self._configs)

    def peek(self) -> bool:
        return len(self._configs) > 0

    def next(self) -> RouteConfig:
        cfg = self._configs[self._index % len(self._configs)]
        self._index += 1
        return cfg


class PriorityRouteIndexer:
    """Curriculum sampler that favours low-completion routes. Without `rng`
    it draws from an unseeded RandomState, as the reference does."""

    def __init__(self, routes_file: str, scenario_file: Optional[str] = None,
                 vehicle_num: Optional[Sequence[int]] = None,
                 rng: Optional[np.random.RandomState] = None,
                 epsilon: float = 0.2):
        if vehicle_num is None:
            vehicle_num = (None, None)
        base = parse_routes_file(routes_file, scenario_file)
        self.n_routes = 2 * len(base)
        self.completion_ratio = np.zeros(self.n_routes)
        self.route_priority = 100.0 * np.ones(self.n_routes)
        self._configs: List[RouteConfig] = []
        self._rng = rng or np.random.RandomState()
        self._epsilon = epsilon
        cnt = 0
        for cfg in base:
            with_traffic = copy.copy(cfg)
            with_traffic.index = cnt
            with_traffic.vehicle_num = vehicle_num[0]
            with_traffic.walker_num = vehicle_num[1]
            self._configs.append(with_traffic)
            cnt += 1
            no_traffic = copy.copy(cfg)
            no_traffic.index = cnt
            no_traffic.vehicle_num = 0
            no_traffic.walker_num = 0
            self._configs.append(no_traffic)
            cnt += 1

    def __len__(self) -> int:
        return self.n_routes

    def peek(self) -> bool:
        return True

    def update_route(self, route_id: int, route_completion: float,
                     st_waypoint: Optional[int]) -> None:
        """Record completion; keep `st` for partially completed routes."""
        if route_completion == 100:
            self._configs[route_id].st = None
        else:
            self._configs[route_id].st = st_waypoint
        self.completion_ratio[route_id] = route_completion
        self.route_priority[route_id] = 100.0 - route_completion

    def next(self) -> RouteConfig:
        eps = self._rng.random_sample()
        if eps > 1.0 - self._epsilon:
            idx = self._rng.randint(0, self.n_routes)
        elif np.sum(self.route_priority) == 0:
            idx = self._rng.randint(0, self.n_routes)
        else:
            # softmax over priorities, max subtracted for stability
            p = np.exp(self.route_priority - self.route_priority.max())
            p = p / p.sum()
            idx = int(self._rng.choice(self.n_routes, 1, p=p)[0])
        return self._configs[idx]
