"""Agent, rollout, training, CARLA env and eval configuration (the
reference's config_files/agent_config.py and eval_agent_config.py), as
cadre_tpu.configs.agent_config gives them."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

# 33-bin steering LUT: index -> steer
STEER_CONTROL: np.ndarray = np.array(
    [-8, -7, -6, -5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, -9, 10,
     -10, 11, -11, 12, -12, 13, -13, 14, -14, 15, -15, 16, -16],
    dtype=np.float64) / 16.0

# 3-bin throttle LUT: index -> (throttle, brake)
THROTTLE_CONTROL: np.ndarray = np.array(
    [[0.0, 0.0],   # coast
     [0.0, 1.0],   # brake
     [0.6, 0.0]],  # throttle
    dtype=np.float64)

NUM_COMMANDS = 4                           # LEFT, RIGHT, STRAIGHT, LANEFOLLOW
MEASUREMENT_DIM = 18                       # 3 measurements tiled x6
SEQ_LENGTH = 8                             # observation history frames


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    num_steps: int = 200
    mini_batch_num: int = 2
    feature_dims: int = 512 + MEASUREMENT_DIM  # 530
    seq_length: int = SEQ_LENGTH
    use_gae: bool = True
    gamma: float = 0.99
    tau: float = 0.95


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """agent_cfg (config_files/agent_config.py:27-48). `memory` is
    'lstm' (the reference's), 'transformer' or 'none'; `use_lstm=False`
    is its legacy spelling of 'none'; `ordinal` puts the actor's logits
    through `rl.distributions.ordinal_logits`. The PPO coefficients are
    carried as the JAX package carries them: the update reads
    `rl.ppo.PPOConfig`."""

    use_lstm: bool = True
    command_num: int = NUM_COMMANDS
    measurement_dim: int = MEASUREMENT_DIM
    num_steer_outputs: int = len(STEER_CONTROL)        # 33
    num_throttle_outputs: int = len(THROTTLE_CONTROL)  # 3
    frame: int = SEQ_LENGTH
    ent_coeff: float = 0.01
    value_coeff: float = 0.1
    clip_coeff: float = 1.0
    clip: float = 0.1
    vae_params: str = "CoPM"   # 'CoPM' | 'CoPM w/o att' | others
    ordinal: bool = False
    memory: str = "lstm"       # 'lstm' | 'transformer' | 'none'

    @property
    def obs_dim(self) -> int:
        """2 * z + measurements for the CoPM encoders, z + measurements
        otherwise, z = 256 (ppo_agent/models.py:38-41). The agent's own
        width is its encoder's latent + measurements
        (`CadreAgent.obs_dim`)."""
        z = 256
        if self.vae_params in ("CoPM", "CoPM w/o att"):
            return 2 * z + self.measurement_dim
        return z + self.measurement_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_episode: int = 3000
    max_grad_norm: float = 250.0
    use_adv_norm: bool = True
    ppo_epoch: int = 4
    lr: float = 3e-4
    save_interval: int = 100
    log_interval: int = 10
    num_processes: int = 4


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """env_cfg (agent_config.py:60-125): the CARLA servers, their towns,
    the traffic and the NoCrash route and scenario files. Not the device
    env's config, which is `envs.torch_env.EnvConfig`."""

    root_path: str = "result"
    frame_rate: int = 10
    timeout: float = 60.0
    client_timeout: float = 60.0
    vehicle_block_time: int = 400
    min_speed: float = 5.0
    max_speed: float = 9.0
    target_speed: float = 7.0
    max_degree: float = 90.0
    host: str = "localhost"
    training: bool = True
    route_indexer: str = "priority"
    num_processes: int = 4
    ports: Tuple[int, ...] = (8010, 8020, 8030, 8040)
    towns: Tuple[str, ...] = ("Town01",) * 4
    amount: Tuple[int, int] = (150, 0)   # (vehicles, walkers)
    seq_length: int = SEQ_LENGTH
    routes: Tuple[str, ...] = (
        "nocrash_route/Nocrash_follow_lane_turn_route.xml",
        "nocrash_route/Nocrash_right_turn_route.xml",
        "nocrash_route/Nocrash_left_turn_route.xml",
        "nocrash_route/Nocrash_straight_turn_route.xml",
    )
    scenarios: Tuple[str, ...] = (
        "nocrash_scenarios/follow_lane_nocrash_scenarios/Town01",
        "leaderboard/data/all_towns_traffic_scenarios_public.json",
        "leaderboard/data/all_towns_traffic_scenarios_public.json",
        "nocrash_scenarios/straight_nocrash_scenarios/Town01",
    )


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """eval_cfg (config_files/eval_agent_config.py:51-57)."""

    eval_episode: int = 25
    load_episodes: Tuple[int, ...] = (2400, 2500, 2600, 2700, 2800, 2900)
    vehicle_num: int = 20
    walker_num: int = 50
    brake_threshold: float = 0.5


def convert_action(steer_idx: int, throttle_idx: int) -> List[float]:
    """Discrete (steer bin, throttle bin) -> [steer, throttle, brake]
    (ppo_agent/agent.py:77-81)."""
    steer = float(STEER_CONTROL[steer_idx])
    throttle, brake = THROTTLE_CONTROL[throttle_idx]
    return [steer, float(throttle), float(brake)]


def avg_action(action_list: Sequence[Sequence[int]],
               brake_threshold: float = 0.5) -> List[float]:
    """Ensemble average of discrete actions as [steer, throttle, brake]; a
    mean brake below `brake_threshold` is zeroed when K > 1
    (ppo_agent/agent.py:83-95)."""
    controls = np.array([convert_action(a[0], a[1]) for a in action_list])
    mean = controls.mean(axis=0).tolist()
    if len(action_list) > 1 and mean[-1] < brake_threshold:
        mean[-1] = 0.0
    return mean
