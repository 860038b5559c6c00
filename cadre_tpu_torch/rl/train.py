"""Single-env PPO training loop on a host env.

PyTorch counterpart of cadre_tpu.rl.train (the reference's
ppo_agent/train.py:14-127): collect `num_steps` transitions into the steer
and throttle rollouts, GAE and advantage normalisation, `ppo_epoch` x
`mini_batch_num` minibatch updates on the agent's optimizer, a log line
every `log_interval` episodes and a snapshot every `save_interval`, to
<work_dir>/<rank>/models/ppo_model_<episode>.pt.

As in the JAX package, the final value is bootstrapped from the live
post-rollout observation (the reference reads a slot of its buffer that
was never written). The env is numpy on the host; the encoder, the banks,
the buffers and the update live on the agent's device.

Random numbers come from a generator on the agent's device seeded from
`seed + rank`, or, per episode, from `draws` (`IterationDraws`).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import (
    RolloutConfig,
    TrainConfig,
    convert_action,
)
from cadre_tpu_torch.rl.agent import CadreAgent, Gumbel
from cadre_tpu_torch.rl.distributions import gumbel as draw_gumbel
from cadre_tpu_torch.rl.rollout import (
    RolloutBuffer,
    after_update,
    batched_returns,
    create_rollout,
    gather_minibatch_batched,
    insert,
    minibatch_indices,
    normalize_advantages,
)
from cadre_tpu_torch.utils.logger import logger


class IterationDraws(NamedTuple):
    """Every random number of one episode of `train` or one iteration of
    `train_vec`."""

    gumbel: Sequence[Gumbel]       # T + 1 (steer, throttle) noise pairs:
    #                                each tick's, then the bootstrap's
    perms: Any                     # (steer, throttle) [E*M, B] row indices


@dataclasses.dataclass
class EpisodeStats:
    episode: int
    value_loss: float
    policy_loss: float
    entropy_loss: float
    steer_reward: float
    throttle_reward: float
    env_steps: int
    sps: float


def agent_gumbel(agent: CadreAgent, n: int, gen: torch.Generator) -> Gumbel:
    """Standard Gumbel noise for one act of `n` envs from `gen`."""
    cfg = agent.agent_cfg
    return (draw_gumbel((n, cfg.num_steer_outputs), gen, agent.device),
            draw_gumbel((n, cfg.num_throttle_outputs), gen, agent.device))


def collect_rollout(env, agent: CadreAgent, steer_buf: RolloutBuffer,
                    throttle_buf: RolloutBuffer, obs: Dict[str, Any],
                    num_steps: int, gumbels: Sequence[Gumbel]):
    """One num_steps rollout (train.py:55-75) into one-env buffers;
    `gumbels` holds num_steps + 1 noise pairs, the last for the bootstrap.
    Returns (obs, done, bufs, reward sums, bootstrap values [1])."""
    steer_sum = throttle_sum = 0.0
    done = False
    for step in range(num_steps):
        command = obs["command"]
        out = agent.act(obs, gumbels[step])
        sa, ta = torch.stack([out.steer_action,
                              out.throttle_action]).cpu().tolist()
        obs, reward, done, info = env.step(convert_action(sa, ta))
        steer_done, throttle_done = info["action_done"]
        steer_sum += float(reward[0])
        throttle_sum += float(reward[1])

        steer_buf = insert(
            steer_buf, out.features, out.steer_action, out.steer_log_prob,
            out.steer_value, reward[0], 0.0 if steer_done else 1.0,
            out.hidden, command)
        throttle_buf = insert(
            throttle_buf, out.features, out.throttle_action,
            out.throttle_log_prob, out.throttle_value, reward[1],
            0.0 if throttle_done else 1.0, out.hidden, command)
        if done:
            obs = env.reset()

    # bootstrap values from the live post-rollout observation
    if done:
        next_values = (torch.zeros(1, device=agent.device),
                       torch.zeros(1, device=agent.device))
    else:
        final = agent.act(obs, gumbels[num_steps])
        next_values = (final.steer_value.reshape(1),
                       final.throttle_value.reshape(1))
    return obs, done, steer_buf, throttle_buf, (steer_sum, throttle_sum), \
        next_values


def ppo_update_epochs(agent: CadreAgent, steer_buf: RolloutBuffer,
                      throttle_buf: RolloutBuffer, next_values,
                      train_cfg: TrainConfig, rollout_cfg: RolloutConfig,
                      perms=None, generator: Optional[torch.Generator] = None):
    """GAE, advantage normalisation and ppo_epoch x mini_batch_num updates
    (train.py:76-110). `perms` (steer, throttle) [E*M, B] replace the
    permutations drawn from `generator`, one per epoch and signal. Returns
    the mean (value, policy, entropy) losses."""
    next_steer, next_throttle = next_values
    s_ret, s_adv = batched_returns(steer_buf, next_steer, rollout_cfg.gamma,
                                   rollout_cfg.tau)
    t_ret, t_adv = batched_returns(throttle_buf, next_throttle,
                                   rollout_cfg.gamma, rollout_cfg.tau)
    if train_cfg.use_adv_norm:
        s_adv = normalize_advantages(s_adv)
        t_adv = normalize_advantages(t_adv)

    m_num, t_steps = rollout_cfg.mini_batch_num, rollout_cfg.num_steps
    losses = []
    for epoch in range(train_cfg.ppo_epoch):
        if perms is None:
            s_idx, t_idx = (minibatch_indices(t_steps, m_num, generator,
                                              device=agent.device)
                            for _ in range(2))
        else:
            s_idx, t_idx = (p[epoch * m_num:(epoch + 1) * m_num].to(
                agent.device) for p in perms)
        for m in range(m_num):
            s_mb = gather_minibatch_batched(steer_buf, s_ret, s_adv,
                                            s_idx[m])
            t_mb = gather_minibatch_batched(throttle_buf, t_ret, t_adv,
                                            t_idx[m])
            losses.append(agent.update_policy(s_mb, t_mb))
    return [float(np.mean([l[i] for l in losses])) for i in range(3)]


def train(env, agent: CadreAgent, rollout_cfg: Optional[RolloutConfig] = None,
          train_cfg: Optional[TrainConfig] = None, rank: int = 0,
          work_dir: Optional[str] = None, seed: int = 0,
          episode_hook: Optional[Callable[[EpisodeStats], None]] = None,
          max_episode: Optional[int] = None,
          draws: Optional[Sequence[IterationDraws]] = None
          ) -> List[EpisodeStats]:
    """Single-worker training loop (the reference's train() body)."""
    rollout_cfg = rollout_cfg or RolloutConfig()
    train_cfg = train_cfg or TrainConfig()
    episodes = max_episode if max_episode is not None else \
        train_cfg.max_episode
    t_steps, feature = rollout_cfg.num_steps, agent.obs_dim
    steer_buf, throttle_buf = (
        create_rollout(t_steps, 1, rollout_cfg.seq_length, feature,
                       device=agent.device) for _ in range(2))
    model_dir = None
    if work_dir is not None:
        model_dir = os.path.join(work_dir, str(rank), "models")
        os.makedirs(model_dir, exist_ok=True)

    gen = torch.Generator(device=agent.device)
    gen.manual_seed(seed + rank)
    obs = env.reset()
    stats_log: List[EpisodeStats] = []
    for episode in range(episodes):
        t0 = time.time()
        d = draws[episode] if draws is not None else IterationDraws(
            [agent_gumbel(agent, 1, gen) for _ in range(t_steps + 1)], None)
        obs, done, steer_buf, throttle_buf, sums, next_values = \
            collect_rollout(env, agent, steer_buf, throttle_buf, obs,
                            t_steps, d.gumbel)
        vl, pl, el = ppo_update_epochs(agent, steer_buf, throttle_buf,
                                       next_values, train_cfg, rollout_cfg,
                                       d.perms, gen)
        steer_buf = after_update(steer_buf, agent.hidden_state)
        throttle_buf = after_update(throttle_buf, agent.hidden_state)
        dt = time.time() - t0
        stats = EpisodeStats(episode, vl, pl, el, sums[0], sums[1], t_steps,
                             t_steps / dt)
        stats_log.append(stats)
        if episode_hook:
            episode_hook(stats)

        if episode % train_cfg.log_interval == 0 and rank == 0:
            logger.log(
                f"Episode: {episode}, value loss: {vl:.4f}, policy loss: "
                f"{pl:.4f}, entropy loss: {el:.4f}, steer R: {sums[0]:.1f}, "
                f"throttle R: {sums[1]:.1f}, {stats.sps:.1f} steps/s")
            logger.record_tabular("episode", episode)
            logger.record_tabular("value_loss", vl)
            logger.record_tabular("policy_loss", pl)
            logger.record_tabular("entropy_loss", el)
            logger.record_tabular("steer_reward", sums[0])
            logger.record_tabular("throttle_reward", sums[1])
            logger.record_tabular("steps_per_sec", stats.sps)
            logger.dump_tabular()

        if model_dir is not None and episode % train_cfg.save_interval == 0 \
                and rank == 0:
            agent.save_snapshot(
                os.path.join(model_dir, f"ppo_model_{episode}.pt"))
    return stats_log
