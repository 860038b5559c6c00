"""Leaderboard driving-score computation of the host-env eval.

numpy copy of the JAX package's scoring. Contract: leaderboard/utils/statistics_manager.py:22-26,118+ — per-route
score = route completion x product of infraction penalties:
  pedestrian collision 0.50, vehicle collision 0.60, static collision 0.65,
  red light 0.70, stop sign 0.80
with terminal failures (route deviation / blocked) zeroing completion credit
beyond the achieved percentage. Global score = mean over routes.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Sequence

from cadre_tpu_torch.envs.criteria import Criterion
from cadre_tpu_torch.envs.events import TrafficEventType

PENALTY_COLLISION_PEDESTRIAN = 0.50
PENALTY_COLLISION_VEHICLE = 0.60
PENALTY_COLLISION_STATIC = 0.65
PENALTY_TRAFFIC_LIGHT = 0.70
PENALTY_STOP = 0.80

_PENALTIES = {
    TrafficEventType.COLLISION_PEDESTRIAN: PENALTY_COLLISION_PEDESTRIAN,
    TrafficEventType.COLLISION_VEHICLE: PENALTY_COLLISION_VEHICLE,
    TrafficEventType.COLLISION_STATIC: PENALTY_COLLISION_STATIC,
    TrafficEventType.TRAFFIC_LIGHT_INFRACTION: PENALTY_TRAFFIC_LIGHT,
    TrafficEventType.STOP_INFRACTION: PENALTY_STOP,
}


@dataclasses.dataclass
class RouteRecord:
    route_id: str
    completion: float              # 0..100
    infractions: Dict[str, int]
    penalty: float
    score: float


def score_route(route_id: str, criteria: Sequence[Criterion]) -> RouteRecord:
    """Compute the composed driving score from an episode's criteria."""
    penalty = 1.0
    infractions: Dict[str, int] = {}
    completion = 0.0
    for crit in criteria:
        if crit.name == "RouteCompletionTest":
            completion = crit.actual_value
        for event in crit.list_traffic_events:
            et = event.get_type()
            if et in _PENALTIES:
                penalty *= _PENALTIES[et]
                infractions[et.name] = infractions.get(et.name, 0) + 1
    return RouteRecord(route_id=route_id, completion=completion,
                       infractions=infractions, penalty=penalty,
                       score=completion * penalty)


def write_criteria_csv(path: str, criteria: Sequence[Criterion]) -> None:
    """Append one row of per-criterion actual_values, creating the file with
    a criterion-name header (the reference writes its fixed 7-criterion
    header once, scenario_manager.py:85-91, then appends
    `criterion.actual_value` per episode in get_criteria() order,
    result_writer.py:44-58; here the header names track the env's actual
    criteria set, which may include RouteTimeout)."""
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.writer(f)
        if new:
            writer.writerow([c.name for c in criteria])
        writer.writerow([c.actual_value for c in criteria])


class StatisticsManager:
    """Accumulates per-route records; `global_record` averages scores."""

    def __init__(self):
        self.records: List[RouteRecord] = []

    def add(self, record: RouteRecord) -> None:
        self.records.append(record)

    def compute(self, route_id: str,
                criteria: Sequence[Criterion]) -> RouteRecord:
        rec = score_route(route_id, criteria)
        self.add(rec)
        return rec

    def global_record(self) -> Dict[str, float]:
        if not self.records:
            return {"score_composed": 0.0, "score_route": 0.0,
                    "score_penalty": 1.0, "routes": 0}
        n = len(self.records)
        return {
            "score_composed": sum(r.score for r in self.records) / n,
            "score_route": sum(r.completion for r in self.records) / n,
            "score_penalty": sum(r.penalty for r in self.records) / n,
            "routes": n,
        }
