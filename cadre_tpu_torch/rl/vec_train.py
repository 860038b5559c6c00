"""Vectorized multi-env PPO training on host envs.

PyTorch counterpart of cadre_tpu.rl.vec_train: N host envs step behind one
batched act per tick, into batched [T, N] rollouts on the agent's device;
then GAE and the PPO epochs over the T*N rows. The env is numpy on the
host; the encoder, the banks, the buffers and the update live on the
agent's device, and the actions are the one thing a tick reads back.

Each tick is the fused tick `act_vec_store`, which stores the previous
tick's transition, encodes only the newest frame of each env and acts.
After any env reset, and on the first tick of an iteration, the whole
frame window is encoded again (a refresh). As in the reference, every act
sees the stale zero LSTM carry.

- `fused_update` (default): the whole update phase through
  `rl.fused_update.make_fused_iteration_update`; else one minibatch step
  at a time through `agent.update_policy`, the JAX package's other path.
- `mesh` (parallel/mesh.py): data-parallel over ranks, each stepping its
  own envs (the caller gives rank r its share of the N envs). The banks
  start as rank 0's; each minibatch step is
  `parallel.train_step.make_distributed_update` (gradients SUMMED over
  the ranks, then clipped), on rows each rank draws from its own envs,
  with advantages normalised by every rank's moments. (The JAX
  `train_vec(mesh=)` permutes the rows of all envs and shards each
  minibatch, which needs every row on every device; the port's ranks
  pick their own rows, as the reference's workers do.) Only rank 0 logs
  and writes snapshots.

Random numbers come from generators on the agent's device seeded from
`seed`, or, per iteration, from `draws` (`rl.train.IterationDraws`).
Snapshots go to <work_dir>/models/ppo_model_<iteration>.pt every
`save_interval` iterations.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import (
    RolloutConfig,
    TrainConfig,
    convert_action,
)
from cadre_tpu_torch.parallel.mesh import Mesh, broadcast_
from cadre_tpu_torch.parallel.multihost import is_chief
from cadre_tpu_torch.parallel.train_step import make_distributed_update
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.fused_update import (
    make_fused_iteration_update,
    make_perms,
    normalize_advantages_global,
)
from cadre_tpu_torch.rl.rollout import (
    after_update,
    batched_returns,
    create_rollout,
    gather_minibatch_batched,
)
from cadre_tpu_torch.rl.train import IterationDraws, agent_gumbel
from cadre_tpu_torch.utils.logger import logger
from cadre_tpu_torch.utils.profiling import PhaseTimer

@dataclasses.dataclass
class VecEpisodeStats:
    iteration: int
    value_loss: float
    policy_loss: float
    entropy_loss: float
    env_steps: int
    env_steps_per_sec: float
    mean_steer_reward: float
    mean_throttle_reward: float
    episodes_finished: int
    mean_completion: float
    # seconds of this iteration in each PhaseTimer phase (act, env, update)
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fused ticks that encoded the whole frame window
    refreshes: int = 0


def train_vec(vec_env, agent: CadreAgent,
              rollout_cfg: Optional[RolloutConfig] = None,
              train_cfg: Optional[TrainConfig] = None,
              iterations: int = 100, seed: int = 0,
              work_dir: Optional[str] = None,
              iteration_hook: Optional[Callable] = None,
              fused_update: bool = True,
              mesh: Optional[Mesh] = None,
              draws: Optional[Sequence[IterationDraws]] = None
              ) -> List[VecEpisodeStats]:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: a parallel.mesh.Mesh (make_mesh()), not "
                        f"{mesh!r}")
    chief = is_chief()
    rollout_cfg = rollout_cfg or RolloutConfig()
    train_cfg = train_cfg or TrainConfig()
    n = vec_env.num_envs
    t_steps = rollout_cfg.num_steps
    f = agent.obs_dim
    dev = agent.device

    steer_buf, throttle_buf = (
        create_rollout(t_steps, n, rollout_cfg.seq_length, f, device=dev)
        for _ in range(2))
    hidden = (torch.zeros(n, f, device=dev), torch.zeros(n, f, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + (mesh.rank if mesh is not None else 0))
    model_dir = None
    if work_dir is not None and chief:
        model_dir = os.path.join(work_dir, "models")
        os.makedirs(model_dir, exist_ok=True)

    fused_fn = dist_update = None
    if mesh is not None:
        broadcast_(agent.policy_parameters(), mesh)
        dist_update = make_distributed_update(agent.steer, agent.throttle,
                                              agent.ppo_cfg, mesh)
    elif fused_update:
        ppo_cfg = dataclasses.replace(agent.ppo_cfg,
                                      ppo_epoch=train_cfg.ppo_epoch,
                                      gamma=rollout_cfg.gamma,
                                      tau=rollout_cfg.tau)
        fused_fn = make_fused_iteration_update(
            agent.steer, agent.throttle, ppo_cfg, rollout_cfg, seed=seed)

    tick = vec_env.reset()
    stats_log: List[VecEpisodeStats] = []
    feat_hist = None          # [T, N, F] on the device
    need_refresh = True
    for it in range(iterations):
        t0 = time.time()
        timer = PhaseTimer()
        d = draws[it] if draws is not None else None
        reward_sums = np.zeros(2)
        refreshes = 0
        pending = None        # the previous tick's outputs, stored next tick
        for step in range(t_steps):
            g = d.gumbel[step] if d is not None else agent_gumbel(agent, n,
                                                                  gen)
            with timer.phase("act"):
                refreshes += int(need_refresh)
                steer_out, throttle_out, _, feat_hist, steer_buf, \
                    throttle_buf = agent.act_vec_store(
                        tick, feat_hist, hidden, steer_buf, throttle_buf,
                        pending or agent.zero_pending(n),
                        store=pending is not None, refresh=need_refresh,
                        gumbel=g)
                need_refresh = False
                # the tick's one read of the device: both action vectors
                steer_a, throttle_a = torch.stack(
                    [steer_out.action, throttle_out.action]).cpu().tolist()
            commands = np.asarray(tick["command"], np.int64)
            controls = [convert_action(sa, ta)
                        for sa, ta in zip(steer_a, throttle_a)]
            with timer.phase("env"):
                tick, rewards, dones, infos = vec_env.step(controls)
            if bool(np.any(dones)):
                need_refresh = True  # reset envs restart their histories
            steer_done = np.asarray(
                [i["action_done"][0] for i in infos], np.float32)
            throttle_done = np.asarray(
                [i["action_done"][1] for i in infos], np.float32)
            reward_sums += rewards.mean(0)

            # `hidden` is the act's input carry (the stale zeros): the
            # deferred store records it, not the post-act carry
            pending = (steer_out, throttle_out, commands,
                       np.asarray(rewards, np.float32),
                       1.0 - steer_done, 1.0 - throttle_done, hidden)

        # bootstrap from the live post-rollout observation; the same fused
        # tick flushes the last pending transition into the buffers
        g = d.gumbel[t_steps] if d is not None else agent_gumbel(agent, n,
                                                                 gen)
        with timer.phase("act"):
            refreshes += int(need_refresh)
            steer_fin, throttle_fin, _, feat_hist, steer_buf, \
                throttle_buf = agent.act_vec_store(
                    tick, feat_hist, hidden, steer_buf, throttle_buf,
                    pending, store=True, refresh=need_refresh, gumbel=g)
            need_refresh = True  # the history now holds the bootstrap

        perms = d.perms if d is not None else None
        with timer.phase("update"):
            if fused_fn is not None:
                aux = fused_fn(agent.opt, steer_buf, throttle_buf,
                               (steer_fin.value, throttle_fin.value), perms)
                vl, pl, el = torch.stack(tuple(aux)).cpu().tolist()
            else:
                vl, pl, el = _minibatch_updates(
                    agent, steer_buf, throttle_buf,
                    (steer_fin.value, throttle_fin.value), train_cfg,
                    rollout_cfg, perms, gen, dist_update, mesh)

        # rewind the ring pointers so the next iteration's rows land at
        # 0..T-1
        steer_buf = after_update(steer_buf)
        throttle_buf = after_update(throttle_buf)

        dt = time.time() - t0
        eps = vec_env.pop_episode_stats()
        stats = VecEpisodeStats(
            iteration=it, value_loss=vl, policy_loss=pl, entropy_loss=el,
            env_steps=t_steps * n, env_steps_per_sec=t_steps * n / dt,
            mean_steer_reward=float(reward_sums[0]),
            mean_throttle_reward=float(reward_sums[1]),
            episodes_finished=len(eps),
            mean_completion=float(np.mean([e["completion"] for e in eps]))
            if eps else 0.0,
            phase_seconds=dict(timer.totals), refreshes=refreshes)
        stats_log.append(stats)
        if iteration_hook:
            iteration_hook(stats)
        if chief and it % train_cfg.log_interval == 0:
            phases = " ".join(f"{k}={v['mean_ms']:.1f}ms"
                              for k, v in timer.report().items())
            logger.log(
                f"iter {it}: {stats.env_steps_per_sec:.0f} env-steps/s, "
                f"value {vl:.4f}, policy {pl:.4f}, ent {el:.4f}, "
                f"{stats.episodes_finished} eps done "
                f"(mean completion {stats.mean_completion:.1f}%) [{phases}]")
        if model_dir is not None and it % train_cfg.save_interval == 0:
            agent.save_snapshot(os.path.join(model_dir, f"ppo_model_{it}.pt"))
    return stats_log


def _minibatch_updates(agent: CadreAgent, steer_buf, throttle_buf,
                       next_values, train_cfg: TrainConfig,
                       rollout_cfg: RolloutConfig, perms,
                       gen: torch.Generator, dist_update=None,
                       mesh: Optional[Mesh] = None):
    """The update one minibatch step at a time (`fused_update=False`, or
    a mesh): GAE, normalisation, then per epoch one row permutation per
    signal (`perms` rows, or drawn from `gen`) cut into mini_batch_num
    slices, each an `agent.update_policy` or, with a mesh, a
    `dist_update` on the agent's optimizer. Returns the mean losses."""
    s_ret, s_adv = batched_returns(steer_buf, next_values[0],
                                   rollout_cfg.gamma, rollout_cfg.tau)
    t_ret, t_adv = batched_returns(throttle_buf, next_values[1],
                                   rollout_cfg.gamma, rollout_cfg.tau)
    if train_cfg.use_adv_norm:
        s_adv = normalize_advantages_global(s_adv, mesh)
        t_adv = normalize_advantages_global(t_adv, mesh)
    total_rows = steer_buf.num_steps * steer_buf.num_envs
    if perms is None:
        perms = tuple(make_perms(train_cfg.ppo_epoch, total_rows,
                                 rollout_cfg.mini_batch_num, gen,
                                 agent.device) for _ in range(2))
    losses = []
    for s_idx, t_idx in zip(*perms):
        s_mb = gather_minibatch_batched(steer_buf, s_ret, s_adv,
                                        s_idx.to(agent.device))
        t_mb = gather_minibatch_batched(throttle_buf, t_ret, t_adv,
                                        t_idx.to(agent.device))
        if dist_update is None:
            losses.append(agent.update_policy(s_mb, t_mb))
        else:
            aux = dist_update(agent.opt, s_mb, t_mb)
            losses.append(torch.stack(tuple(aux)).cpu().tolist())
    return [float(np.mean([l[i] for l in losses])) for i in range(3)]
