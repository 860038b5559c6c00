"""Clipped-surrogate PPO loss and optimizer step for the dual steer /
throttle command banks.

PyTorch counterpart of cadre_tpu.rl.ppo (unsharded): for each signal each
sample of the minibatch goes through its own command's bank alone
(`PolicyBank.evaluate_masked`, the terms and gradients of the JAX
package's dense one-hot mask); ratio clip at `clip`, clipped
value loss 0.5*max(sq, sq_clipped), losses summed over the two signals,
total = value_coeff*value + clip_coeff*action - ent_coeff*entropy. The
gradients of both banks are clipped together by their global norm
(optax.clip_by_global_norm's formula) and applied with Adam.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from cadre_tpu_torch.models.policy import PolicyBank
from cadre_tpu_torch.rl.rollout import Minibatch
from cadre_tpu_torch.utils.profiling import span

BankRows = Tuple[Sequence[int], Sequence[int]]   # (steer, throttle) [C]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip: float = 0.1
    clip_coeff: float = 1.0
    value_coeff: float = 0.1
    ent_coeff: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 250.0
    ppo_epoch: int = 4
    mini_batch_num: int = 2
    gamma: float = 0.99
    tau: float = 0.95
    use_adv_norm: bool = True
    num_steps: int = 200
    seq_length: int = 8


class LossAux(NamedTuple):
    value_loss: torch.Tensor
    action_loss: torch.Tensor
    entropy_loss: torch.Tensor


def _signal_loss(bank: PolicyBank, mb: Minibatch, clip: float,
                 bank_rows: Optional[Sequence[int]] = None):
    """One signal's clipped surrogate + clipped value loss + entropy."""
    values, log_prob, entropy = bank.evaluate_masked(
        mb.obs_seq, mb.hidden, mb.action, mb.command, bank_rows)
    ratio = torch.exp(log_prob - mb.old_log_prob)
    surr1 = ratio * mb.advantage
    surr2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * mb.advantage
    action_loss = -torch.minimum(surr1, surr2).mean()

    v_clipped = mb.old_value + torch.clamp(values - mb.old_value, -clip, clip)
    v_losses = (values - mb.returns) ** 2
    v_losses_clipped = (v_clipped - mb.returns) ** 2
    value_loss = 0.5 * torch.maximum(v_losses, v_losses_clipped).mean()
    return value_loss, action_loss, entropy.mean()


def ppo_loss(steer: PolicyBank, throttle: PolicyBank, steer_mb: Minibatch,
             throttle_mb: Minibatch, cfg: PPOConfig,
             bank_rows: Optional[BankRows] = None):
    """(total loss over both signals, LossAux). `bank_rows`, (steer,
    throttle) rows per bank, says each minibatch comes grouped by command
    (`PolicyBank.evaluate_masked`)."""
    s_rows, t_rows = bank_rows or (None, None)
    sv, sa, se = _signal_loss(steer, steer_mb, cfg.clip, s_rows)
    tv, ta, te = _signal_loss(throttle, throttle_mb, cfg.clip, t_rows)
    value_loss = (sv + tv) * cfg.value_coeff
    action_loss = (sa + ta) * cfg.clip_coeff
    ent_loss = (se + te) * cfg.ent_coeff
    total = value_loss + action_loss - ent_loss
    return total, LossAux(value_loss, action_loss, ent_loss)


def make_optimizer(params: Sequence[torch.nn.Parameter],
                   cfg: PPOConfig) -> torch.optim.Adam:
    """Adam at cfg.lr over the policy parameters of both banks; the clip
    is `clip_by_global_norm_`, applied before each step."""
    return torch.optim.Adam(params, lr=cfg.lr)


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: with norm the l2 norm over every
    tensor, leave the gradients as they are when norm < max_norm, else set
    each to g / norm * max_norm. No host sync; returns the norm."""
    norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def update_step(steer: PolicyBank, throttle: PolicyBank,
                opt: torch.optim.Optimizer, steer_mb: Minibatch,
                throttle_mb: Minibatch, cfg: PPOConfig,
                grad_reduce: Optional[Callable[[List[torch.Tensor]], None]]
                = None, bank_rows: Optional[BankRows] = None) -> LossAux:
    """One minibatch step: loss, gradients of both banks, global-norm clip
    at cfg.max_grad_norm, Adam. Every parameter gets a dense gradient, so
    Adam moves every bank on every step, as optax does. `grad_reduce`
    combines the gradients over data-parallel ranks in place before the
    clip (parallel/mesh.py: a sum or a mean); `bank_rows` as `ppo_loss`
    takes it."""
    with span("update/loss"):
        total, aux = ppo_loss(steer, throttle, steer_mb, throttle_mb, cfg,
                              bank_rows)
    params = [p for group in opt.param_groups for p in group["params"]]
    with span("update/backward"):
        grads = list(torch.autograd.grad(total, params))
    if grad_reduce is not None:
        grad_reduce(grads)
    with span("update/optim"):
        clip_by_global_norm_(grads, cfg.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
    return LossAux(*(x.detach() for x in aux))
