"""Rollout storage and the math the PPO update runs on it.

PyTorch counterpart of cadre_tpu.rl.rollout: `RolloutBuffer` plays the
part of both of its buffers, `BatchedRollout` ([T+1, N, ...], slot T is
padding) and the single-env `Rollout` (here N = 1); `insert` writes one
step at the ring pointer (the LSTM carry at the next slot while the
pointer is below T) and `after_update` rewinds it; `compute_gae` /
`batched_returns` are the GAE reverse scan, `normalize_advantages` the
whole-rollout standardisation, `gather_minibatch_batched` the minibatch
gather over the [T, N] rows flattened row-major (row t*N + env; row t
with one env) and `minibatch_indices` the single-env loop's row
permutation cut into minibatches.

The ring pointer `step` is a host int: `insert` writes the buffer's
tensors in place and returns the buffer with the pointer advanced, so no
insert reads the device back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class RolloutBuffer(NamedTuple):
    """[T+1, N, ...] storage of one signal; slot T is zero padding."""

    obs: torch.Tensor              # [T+1, N, seq, F]
    action: torch.Tensor           # [T+1, N] int64
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    mask: torch.Tensor             # 1 - action_done of the signal
    command: torch.Tensor          # [T+1, N] int64
    hn: torch.Tensor               # [T+1, N, F]
    cn: torch.Tensor
    step: int = 0                  # ring pointer of insert

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
    """GAE of every env over the buffer's first T slots; next_value [N]
    (a scalar with one env)."""
    t = buf.num_steps
    return compute_gae(buf.reward[:t], buf.value[:t], buf.mask[:t],
                       next_value.reshape(buf.value.shape[1:]), gamma, tau)


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8), the population std (ddof 0)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def gather_minibatch_batched(buf: RolloutBuffer, returns: torch.Tensor,
                             adv: torch.Tensor, flat_idx: torch.Tensor
                             ) -> Minibatch:
    """flat_idx [B] over the T*N rows of the [T, N] rollout flattened
    row-major (storage.py:98-120 with one env); obs comes out [seq, B, F]."""
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


def create_rollout(num_steps: int, num_envs: int, seq_length: int,
                   feature_dims: int, device="cpu") -> RolloutBuffer:
    """An empty [T+1, N, ...] buffer (N = 1 for the single-env loop)."""
    t1n = (num_steps + 1, num_envs)
    z = torch.zeros(t1n, device=device)
    zi = torch.zeros(t1n, dtype=torch.long, device=device)
    return RolloutBuffer(
        obs=torch.zeros(t1n + (seq_length, feature_dims), device=device),
        action=zi.clone(), log_prob=z.clone(), value=z.clone(),
        reward=z.clone(), mask=z.clone(), command=zi.clone(),
        hn=torch.zeros(t1n + (feature_dims,), device=device),
        cn=torch.zeros(t1n + (feature_dims,), device=device))


def _put(dst: torch.Tensor, s: int, src) -> None:
    """dst[s] <- src: a tensor (any shape of dst[s]'s size) is copied on
    its device, a host scalar fills the slot, a numpy array is uploaded."""
    if isinstance(src, torch.Tensor):
        dst[s].copy_(src.reshape(dst.shape[1:]))
    elif np.ndim(src) == 0:
        dst[s] = float(src) if dst.is_floating_point() else int(src)
    else:
        dst[s].copy_(torch.from_numpy(np.asarray(src)).reshape(
            dst.shape[1:]))


def insert(buf: RolloutBuffer, obs, action, log_prob, value, reward, mask,
           hidden, command) -> RolloutBuffer:
    """One step of N envs at the ring pointer (storage.py:45-58): every
    argument has a leading [N], or is a scalar, [seq, F] or [1, F] with
    one env. The carry goes to slot step+1 while step < T."""
    s, t = buf.step, buf.num_steps
    with torch.no_grad():
        for dst, src in ((buf.obs, obs), (buf.action, action),
                         (buf.log_prob, log_prob), (buf.value, value),
                         (buf.reward, reward), (buf.mask, mask),
                         (buf.command, command)):
            _put(dst, s, src)
        if s < t:
            _put(buf.hn, s + 1, hidden[0])
            _put(buf.cn, s + 1, hidden[1])
    return buf._replace(step=(s + 1) % (t + 1))


def after_update(buf: RolloutBuffer, hidden=None) -> RolloutBuffer:
    """Rewind the ring pointer, so that the next rollout's transitions land
    at rows 0..T-1 in time order; with `hidden`, seed slot 0's carry from
    the live LSTM state (storage.py:60-66; the reference's vectorised loop
    never calls it)."""
    if hidden is not None:
        with torch.no_grad():
            buf.hn[0] = hidden[0].reshape(buf.hn.shape[1:])
            buf.cn[0] = hidden[1].reshape(buf.cn.shape[1:])
    return buf._replace(step=0)


def minibatch_indices(num_steps: int, mini_batch_num: int,
                      generator: Optional[torch.Generator] = None,
                      perm: Optional[torch.Tensor] = None,
                      device="cpu") -> torch.Tensor:
    """A row permutation (`perm`, or one drawn from `generator`) cut into
    mini_batch_num chunks, the remainder dropped: [M, B]."""
    if perm is None:
        perm = torch.randperm(num_steps, generator=generator, device=device)
    size = num_steps // mini_batch_num
    return perm[:size * mini_batch_num].reshape(mini_batch_num, size)
