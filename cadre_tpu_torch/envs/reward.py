"""Decomposed steer/throttle reward of the host env.

numpy copy of the JAX package's host reward (env_wrapper.py:361-482
contract):
  steer_reward    = (deviation_reward + theta_reward)/2 + steer events
  throttle_reward = speed_reward + throttle events
Event table: collision-static -> steer -1 + done (training); collision
vehicle/pedestrian -> throttle -1 + done; blocked -> throttle -1/-2 + done;
route deviation -> steer -1 + done; route completed -> both +5 + done;
outside-lanes -> steer -1 + done. The theta reward has a 30-degree grace in
turns; overspeed ends a training episode; the speed target shrinks near an
obstacle; the deviation D_max is 2.5 / 5 m (10 m in eval); the block
timeout is 400 steps (800 in eval).

A pure function over an explicit RewardState.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.events import TrafficEvent, TrafficEventType
from cadre_tpu_torch.envs.road_option import RoadOption


@dataclasses.dataclass
class RewardConfig:
    min_speed: float = 5.0
    max_speed: float = 9.0
    target_speed: float = 7.0
    max_degree: float = 90.0
    training: bool = True
    d_max_straight: float = 2.5
    d_max_turn: float = 5.0
    d_max_eval: float = 10.0


@dataclasses.dataclass
class RewardState:
    begin: bool = True            # first step after reset skips events
    last_event_timestamp: int = 0
    step: int = 0


@dataclasses.dataclass
class RewardResult:
    rewards: np.ndarray           # [steer_reward, throttle_reward]
    done: bool
    error_message: str
    action_done: Tuple[int, int]  # (steer_done, throttle_done)


def compute_reward(state: RewardState, cfg: RewardConfig, speed: float,
                   dis: float, theta: float,
                   new_event_list: Sequence[TrafficEvent], obstacle: float,
                   in_turn: bool, near_command: RoadOption,
                   max_block_time: int = 400) -> RewardResult:
    throttle_event_reward = 0.0
    steer_event_reward = 0.0
    target_reached = False
    done = False
    throttle_done = 0
    steer_done = 0
    error_message = ""

    if not state.begin:
        for event in new_event_list:
            et = event.get_type()
            if et == TrafficEventType.COLLISION_STATIC:
                error_message = "collision static"
                steer_event_reward -= 1
                steer_done = 1
                if cfg.training:
                    done = True
            elif et in (TrafficEventType.COLLISION_PEDESTRIAN,
                        TrafficEventType.COLLISION_VEHICLE):
                throttle_event_reward -= 1
                throttle_done = 1
                done = True
                error_message = (
                    "collision pedestrians!"
                    if et == TrafficEventType.COLLISION_PEDESTRIAN
                    else "collision vehicles!")
            elif et == TrafficEventType.VEHICLE_BLOCKED:
                error_message = "vehicle blocked"
                done = True
                throttle_done = 1
                throttle_event_reward -= 1
            elif et == TrafficEventType.ROUTE_DEVIATION:
                error_message = "route deviation"
                done = True
                steer_event_reward -= 1
                steer_done = 1
            elif et == TrafficEventType.ROUTE_COMPLETED:
                steer_done = 1
                throttle_done = 1
                error_message = "success"
                steer_event_reward += 5
                throttle_event_reward += 5
                target_reached = True
                done = True
            elif et == TrafficEventType.ROUTE_COMPLETION:
                if not target_reached:
                    d = event.get_dict()
                    score_route = d["route_completed"] if d else 0
                    error_message = f"route completion with {score_route}"
                done = True
            elif et == TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION:
                error_message = "outside route!"
                done = True
                steer_event_reward -= 1
                steer_done = 1
    else:
        state.begin = False

    # theta reward in [0, 1] with 30-degree grace inside turns
    degree = abs(180.0 * theta / np.pi)
    if in_turn:
        degree = max(0.0, degree - 30.0)
    theta_reward = max(0.0, 1.0 - degree / cfg.max_degree)

    if speed > cfg.max_speed:
        throttle_event_reward -= 1
        throttle_done = 1
        if cfg.training:
            done = True
            error_message = "exceed speed"

    detect_obstacle = -1 < obstacle < 12
    if detect_obstacle:
        state.last_event_timestamp = state.step
        target_speed = max(0.0, obstacle - 5.0)
        speed_reward = 1.0 - max(speed - target_speed, 0.0) / (
            cfg.max_speed - target_speed)
        if obstacle < 5:
            speed_reward = -1.0 if speed > 0.1 else 1.0
    elif speed < cfg.min_speed:
        speed_reward = speed / cfg.min_speed
    elif speed > cfg.target_speed:
        speed_reward = max(0.0, 1.0 - (speed - cfg.target_speed)
                           / (cfg.max_speed - cfg.target_speed))
    else:
        speed_reward = 1.0

    # deviation reward (0..1), D_max widened in turns / for non-lanefollow
    if in_turn or near_command != RoadOption.LANEFOLLOW:
        d_max = cfg.d_max_turn
    else:
        d_max = cfg.d_max_straight
    if not cfg.training:
        d_max = cfg.d_max_eval
    deviation_reward = max(0.0, 1.0 - dis / d_max)

    # block timeout
    if speed < 1 and (state.step - state.last_event_timestamp) > max_block_time:
        state.last_event_timestamp = state.step
        done = True
        throttle_event_reward -= 2
        throttle_done = 1
        error_message = "vehicle blocked"

    if len(new_event_list) > 0 or speed > 1:
        state.last_event_timestamp = state.step

    throttle_reward = speed_reward + throttle_event_reward
    steer_reward = (deviation_reward + theta_reward) / 2 + steer_event_reward
    return RewardResult(
        rewards=np.array([steer_reward, throttle_reward], np.float32),
        done=bool(done),
        error_message=error_message,
        action_done=(steer_done, throttle_done),
    )
