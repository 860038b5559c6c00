"""High-level navigation commands (CARLA agents.navigation RoadOption).

The policy's command index is `RoadOption.value - 1`, giving the 4-command
bank LEFT/RIGHT/STRAIGHT/LANEFOLLOW = 0/1/2/3.
"""
from __future__ import annotations

import enum


class RoadOption(enum.Enum):
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


def command_index(option: RoadOption) -> int:
    """RoadOption -> policy bank index (0..3)."""
    return int(option.value) - 1
