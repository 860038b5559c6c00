"""Scripted expert for the device env, batched over N envs.

PyTorch counterpart of cadre_tpu.envs.jax_expert: pure pursuit on the
planner window, bang-bang speed control, obstacle braking and red/yellow
light braking, quantized to the production control LUTs, so that its
completion on a route bank bounds what a policy limited to the same LUTs
can reach.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import (
    STEER_CONTROL,
    THROTTLE_CONTROL,
)
from cadre_tpu_torch.envs.torch_env import (
    _FAR,
    DrivingEnv,
    EnvConfig,
    EnvState,
    RouteBank,
    _heading,
    _light_phases,
    _nearest_obstacle_ahead,
    _route_window,
)


@functools.lru_cache(maxsize=None)
def _luts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The steer and throttle LUTs on `device`, copied there once."""
    return (torch.as_tensor(STEER_CONTROL, dtype=torch.float32, device=device),
            torch.as_tensor(THROTTLE_CONTROL, dtype=torch.float32,
                            device=device))


def expert_action(cfg: EnvConfig, bank: RouteBank, state: EnvState,
                  lookahead: int = 3, target_speed: float = 7.0,
                  brake_distance: float = 6.0, obey_lights: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(steer index, throttle index) [N] int64 into the control LUTs.

    Steer: pure pursuit on the planner window's `lookahead` node, to the
    nearest LUT entry (the first of equals). Throttle: brake for an
    obstacle within `brake_distance` m ahead or a red or yellow light
    within 12 m ahead in the direction of travel, else coast above
    `target_speed` and accelerate below it."""
    w, _, _ = _route_window(bank, state, cfg.window)
    fwd = _heading(state.yaw)
    rel = w[:, lookahead] - state.pos
    cross = fwd[:, 0] * rel[:, 1] - fwd[:, 1] * rel[:, 0]
    dot = (rel * fwd).sum(-1).clamp_min(1e-3)
    steer = torch.clamp(torch.atan2(cross, dot) * 4.0 / math.pi, -1.0, 1.0)
    steer_lut, _ = _luts(steer.device)
    steer_idx = torch.argmin(torch.abs(steer_lut - steer[:, None]), dim=1)

    obstacle = _nearest_obstacle_ahead(state)
    brake_obs = (obstacle > 0.0) & (obstacle < brake_distance)

    lights = bank.lights[state.route_id]                  # [N, L, 5]
    rel_l = lights[..., :2] - state.pos[:, None]
    d_l = torch.sqrt((rel_l * rel_l).sum(-1))
    ahead = (rel_l * fwd[:, None]).sum(-1) > 0.0
    same_dir = (lights[..., 3:5] * fwd[:, None]).sum(-1) > 0.0
    stopworthy = (lights[..., 0] < _FAR / 2) & ahead & same_dir & \
        (d_l < 12.0) & (_light_phases(cfg, lights, state.step) >= 1)
    brake_light = stopworthy.any(1) & obey_lights

    over = state.speed > target_speed
    throttle_idx = torch.where(brake_obs | brake_light, 1,
                               torch.where(over, 0, 2))
    return steer_idx, throttle_idx


def expert_control(cfg: EnvConfig, bank: RouteBank, state: EnvState,
                   **kw) -> torch.Tensor:
    """[N, 3] (steer, throttle, brake) through the LUTs."""
    si, ti = expert_action(cfg, bank, state, **kw)
    steer_lut, throttle_lut = _luts(si.device)
    return torch.cat([steer_lut[si][:, None], throttle_lut[ti]], dim=-1)


@torch.no_grad()
def expert_episode_stats(bank: RouteBank, num_envs: int = 16,
                         steps: int = 1500, seed: int = 0,
                         config: Optional[EnvConfig] = None, device="cuda",
                         **kw) -> Tuple[np.ndarray, np.ndarray]:
    """The expert drives `num_envs` envs over `bank` for `steps` ticks,
    its draws from a generator seeded by `seed`; returns (completions,
    error codes) of the finished episodes, read from the device once."""
    cfg = config or EnvConfig(render=False)
    env = DrivingEnv(bank, num_envs=num_envs, config=cfg, seed=seed,
                     device=device)
    state, _ = env.reset()
    done, comp, err = [], [], []
    for _ in range(steps):
        state, out = env.step(state, expert_control(cfg, bank, state, **kw))
        done.append(out.done)
        comp.append(out.completion)
        err.append(out.error_code)
    m = torch.stack(done).cpu().numpy()
    return (torch.stack(comp).cpu().numpy()[m],
            torch.stack(err).cpu().numpy()[m])
