"""The whole-iteration PPO update.

PyTorch counterpart of cadre_tpu.rl.fused_update.make_fused_iteration_update:
GAE for both
signals, advantage normalisation, ppo_epoch x mini_batch_num minibatch
steps over epoch-major row permutations (separate ones for steer and
throttle, remainder rows dropped), each a gather, the loss, the gradients
of both banks, a global-norm clip and an Adam step; then the means of the
loss terms over every step. Each minibatch's rows are ordered by their
command (stable) inside the gather it already makes, so that each bank
runs on its own rows alone (`PolicyBank.evaluate_masked`); the rows each
bank has in every minibatch, of both signals, are read back on the host
once, before the first step. That is the update's one wait for the
device; the loop then issues its work without waiting.

With a mesh (parallel/mesh.py), its sharded branch: each rank's buffers
hold its own envs; it permutes and minibatches its own rows from a
generator of its own (seeded with its rank), normalises the advantages
with the moments of every rank's rows, and MEAN-reduces the gradients of
each minibatch step before the clip (pmean: the reference's workers
sampling their own minibatches). The loss terms are mean-reduced too.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import RolloutConfig
from cadre_tpu_torch.models.policy import (
    PolicyBank,
    group_by_command,
    read_bank_rows,
)
from cadre_tpu_torch.parallel.mesh import Mesh, mean_reduce_, sum_reduce_
from cadre_tpu_torch.rl.ppo import LossAux, PPOConfig, update_step
from cadre_tpu_torch.rl.rollout import (
    RolloutBuffer,
    batched_returns,
    gather_minibatch_batched,
    normalize_advantages,
)

Perms = Tuple[torch.Tensor, torch.Tensor]   # (steer, throttle) [E*M, B]


def minibatch_layout(total_rows: int, mini_batch_num: int) -> Tuple[int, int]:
    """(minibatches per epoch, rows per minibatch); the remainder of
    total_rows is dropped."""
    eff_mb = min(mini_batch_num, total_rows)
    return eff_mb, total_rows // eff_mb


def make_perms(n_epochs: int, total_rows: int, mini_batch_num: int,
               generator: torch.Generator, device) -> torch.Tensor:
    """One row permutation per epoch, cut into minibatches: [E*M, B]."""
    eff_mb, mb_size = minibatch_layout(total_rows, mini_batch_num)
    perms = torch.stack([
        torch.randperm(total_rows, generator=generator, device=device)
        for _ in range(n_epochs)])
    return perms[:, :mb_size * eff_mb].reshape(n_epochs * eff_mb, mb_size)


def normalize_advantages_global(adv: torch.Tensor,
                                mesh: Optional[Mesh]) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) with the mean and the population std of
    every rank's advantages: a summed count and sum, then a summed sum of
    squared deviations (the JAX `gnorm`). Without a mesh, or in a world
    of one, normalize_advantages."""
    if mesh is None or mesh.world == 1:
        return normalize_advantages(adv)
    count_sum = torch.stack([adv.new_tensor(float(adv.numel())), adv.sum()])
    sum_reduce_([count_sum], mesh)
    mean = count_sum[1] / count_sum[0]
    sq = ((adv - mean) ** 2).sum()
    sum_reduce_([sq], mesh)
    return (adv - mean) / (torch.sqrt(sq / count_sum[0]) + 1e-8)


def make_fused_iteration_update(steer: PolicyBank, throttle: PolicyBank,
                                cfg: PPOConfig, rollout_cfg: RolloutConfig,
                                seed: int = 0,
                                mesh: Optional[Mesh] = None) -> Callable:
    """Returns
    update(opt, steer_buf, throttle_buf, next_values, perms=None) -> LossAux
    of means over every minibatch step; the banks' parameters and `opt`'s
    state are updated in place. After a call, `update.bank_rows` holds
    its rows per bank summed over every minibatch step, (steer, throttle)
    [C] host ints (this rank's rows with a mesh).

    `perms` (steer, throttle) [E*M, B] int64 row indices replace the
    permutations, which otherwise come from a generator on the banks'
    device seeded from `seed`. The minibatch count is
    rollout_cfg.mini_batch_num; the epoch count, clip, coefficients, gamma
    and tau come from `cfg`.
    """
    device = next(steer.parameters()).device
    gen = torch.Generator(device=device)
    entropy = [seed, 1] if mesh is None else [seed, 1, mesh.rank]
    gen.manual_seed(int(np.random.SeedSequence(entropy).generate_state(1)[0]))
    grad_reduce = None if mesh is None else \
        (lambda grads: mean_reduce_(grads, mesh))

    def update(opt: torch.optim.Optimizer, steer_buf: RolloutBuffer,
               throttle_buf: RolloutBuffer,
               next_values: Tuple[torch.Tensor, torch.Tensor],
               perms: Optional[Perms] = None) -> LossAux:
        next_steer, next_throttle = next_values
        s_ret, s_adv = batched_returns(steer_buf, next_steer, cfg.gamma,
                                       cfg.tau)
        t_ret, t_adv = batched_returns(throttle_buf, next_throttle,
                                       cfg.gamma, cfg.tau)
        s_adv = normalize_advantages_global(s_adv, mesh)
        t_adv = normalize_advantages_global(t_adv, mesh)
        if perms is None:
            total_rows = steer_buf.num_steps * steer_buf.num_envs
            perms = tuple(make_perms(cfg.ppo_epoch, total_rows,
                                     rollout_cfg.mini_batch_num, gen, device)
                          for _ in range(2))
        s_idx, t_idx = perms
        commands = torch.stack([_flat_command(steer_buf)[s_idx],
                                _flat_command(throttle_buf)[t_idx]], dim=1)
        order, counts = group_by_command(commands, steer.num_banks)
        s_idx = s_idx.gather(1, order[:, 0])
        t_idx = t_idx.gather(1, order[:, 1])
        rows = read_bank_rows(counts)                  # [E*M][2][C]
        auxes = []
        for si, ti, r in zip(s_idx, t_idx, rows):
            s_mb = gather_minibatch_batched(steer_buf, s_ret, s_adv, si)
            t_mb = gather_minibatch_batched(throttle_buf, t_ret, t_adv, ti)
            auxes.append(torch.stack(update_step(
                steer, throttle, opt, s_mb, t_mb, cfg, grad_reduce,
                bank_rows=r)))
        update.bank_rows = np.sum(rows, axis=0).tolist()
        aux = torch.stack(auxes).mean(dim=0)
        if mesh is not None:
            mean_reduce_([aux], mesh)
        return LossAux(*aux)

    update.bank_rows = None
    return update


def _flat_command(buf: RolloutBuffer) -> torch.Tensor:
    """The commands of the buffer's T*N rows, flattened row-major as
    gather_minibatch_batched indexes them."""
    return buf.command[:buf.num_steps].reshape(-1)
