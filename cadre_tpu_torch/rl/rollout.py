"""Rollout storage and the math the PPO update runs on it.

PyTorch counterpart of the batched parts of cadre_tpu.rl.rollout:
`RolloutBuffer` plays the part of `BatchedRollout` ([T+1, N, ...], slot T
is padding), `compute_gae` / `batched_returns` are the GAE reverse scan,
`normalize_advantages` the whole-rollout standardisation, and
`gather_minibatch_batched` the minibatch gather over the [T, N] rows
flattened row-major (row t*N + env).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class RolloutBuffer(NamedTuple):
    """[T+1, N, ...] storage of one signal; slot T is zero padding."""

    obs: torch.Tensor              # [T+1, N, seq, F]
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    mask: torch.Tensor             # 1 - action_done of the signal
    command: torch.Tensor
    hn: torch.Tensor               # [T+1, N, F]
    cn: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.obs.shape[0] - 1

    @property
    def num_envs(self) -> int:
        return self.obs.shape[1]


class Minibatch(NamedTuple):
    obs_seq: torch.Tensor          # [seq, B, F]
    action: torch.Tensor           # [B]
    old_value: torch.Tensor
    returns: torch.Tensor
    mask: torch.Tensor
    old_log_prob: torch.Tensor
    advantage: torch.Tensor
    hidden: Tuple[torch.Tensor, torch.Tensor]   # ([B, F], [B, F])
    command: torch.Tensor


def compute_gae(reward: torch.Tensor, value: torch.Tensor, mask: torch.Tensor,
                next_value: torch.Tensor, gamma: float, tau: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over the leading time axis, every trailing axis independent.

    reward/value/mask: [T, ...]; next_value: [...] bootstrap. Returns
    (returns, advantages), each [T, ...], with
      delta_t = r_t + gamma * V_{t+1} * m_t - V_t
      gae_t   = delta_t + gamma * tau * m_t * gae_{t+1}.
    """
    value_tp1 = torch.cat([value[1:], next_value[None]], dim=0)
    gae = torch.zeros_like(next_value)
    adv = []
    for t in range(reward.shape[0] - 1, -1, -1):
        delta = reward[t] + gamma * value_tp1[t] * mask[t] - value[t]
        gae = delta + gamma * tau * mask[t] * gae
        adv.append(gae)
    adv = torch.stack(adv[::-1])
    return adv + value, adv


def batched_returns(buf: RolloutBuffer, next_value: torch.Tensor,
                    gamma: float, tau: float):
    """GAE of every env over the buffer's first T slots; next_value [N]."""
    t = buf.num_steps
    return compute_gae(buf.reward[:t], buf.value[:t], buf.mask[:t],
                       next_value, gamma, tau)


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8), the population std (ddof 0)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def gather_minibatch_batched(buf: RolloutBuffer, returns: torch.Tensor,
                             adv: torch.Tensor, flat_idx: torch.Tensor
                             ) -> Minibatch:
    """flat_idx [B] over the T*N rows of the [T, N] rollout flattened
    row-major; obs comes out [seq, B, F]."""
    t, n = buf.num_steps, buf.num_envs

    def flat(x):
        return x[:t].reshape((t * n,) + x.shape[2:])[flat_idx]

    return Minibatch(
        obs_seq=flat(buf.obs).transpose(0, 1),
        action=flat(buf.action),
        old_value=flat(buf.value),
        returns=returns.reshape(-1)[flat_idx],
        mask=flat(buf.mask),
        old_log_prob=flat(buf.log_prob),
        advantage=adv.reshape(-1)[flat_idx],
        hidden=(flat(buf.hn), flat(buf.cn)),
        command=flat(buf.command))
