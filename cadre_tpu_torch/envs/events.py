"""Traffic events emitted by the scenario criteria runtime.

Contract: srunner/scenariomanager/traffic_events.py:13-34 — a 15-value enum
(including the CADRE-added APPROACH_LIGHT) plus an event carrying type,
message and a payload dict.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, Optional


class TrafficEventType(enum.Enum):
    NORMAL_DRIVING = 0
    COLLISION_STATIC = 1
    COLLISION_VEHICLE = 2
    COLLISION_PEDESTRIAN = 3
    ROUTE_DEVIATION = 4
    ROUTE_COMPLETION = 5
    ROUTE_COMPLETED = 6
    TRAFFIC_LIGHT_INFRACTION = 7
    WRONG_WAY_INFRACTION = 8
    ON_SIDEWALK_INFRACTION = 9
    STOP_INFRACTION = 10
    OUTSIDE_LANE_INFRACTION = 11
    OUTSIDE_ROUTE_LANES_INFRACTION = 12
    VEHICLE_BLOCKED = 13
    APPROACH_LIGHT = 14


class TrafficEvent:
    def __init__(self, event_type: TrafficEventType,
                 message: Optional[str] = None,
                 dictionary: Optional[Dict[str, Any]] = None):
        self._type = event_type
        self._message = message or ""
        self._dict = dictionary

    def get_type(self) -> TrafficEventType:
        return self._type

    def get_message(self) -> str:
        return self._message

    def set_message(self, message: str) -> None:
        self._message = message

    def get_dict(self) -> Optional[Dict[str, Any]]:
        return self._dict

    def set_dict(self, dictionary: Dict[str, Any]) -> None:
        self._dict = dictionary

    def __repr__(self) -> str:  # pragma: no cover
        return f"TrafficEvent({self._type.name}, {self._message!r})"
