"""Data-parallel PPO minibatch step (the counterpart of
cadre_tpu.parallel.train_step).

The reference's chief-and-N-workers protocol (ppo_agent/chief.py:8-27,
models.py:219-258): each rank computes the gradients of its shard of the
minibatch; they are SUMMED over the ranks (psum, not DDP's mean), the
sum is clipped at max_grad_norm and Adam steps the replicated banks on
every rank alike. The loss terms are mean-reduced, so every rank reports
the global value.
"""
from __future__ import annotations

from typing import Callable

from cadre_tpu_torch.models.policy import PolicyBank
from cadre_tpu_torch.parallel.mesh import Mesh, mean_reduce_, shard_rows, \
    sum_reduce_
from cadre_tpu_torch.rl.ppo import LossAux, PPOConfig, update_step
from cadre_tpu_torch.rl.rollout import Minibatch


def shard_minibatch(mesh: Mesh, mb: Minibatch) -> Minibatch:
    """This rank's rows of a minibatch (obs_seq's batch is its axis 1), on
    the mesh's device."""
    def rows(x, dim=0):
        return shard_rows(x, mesh, dim).to(mesh.device)

    return Minibatch(
        obs_seq=rows(mb.obs_seq, 1), action=rows(mb.action),
        old_value=rows(mb.old_value), returns=rows(mb.returns),
        mask=rows(mb.mask), old_log_prob=rows(mb.old_log_prob),
        advantage=rows(mb.advantage),
        hidden=(rows(mb.hidden[0]), rows(mb.hidden[1])),
        command=rows(mb.command))


def make_distributed_update(steer: PolicyBank, throttle: PolicyBank,
                            cfg: PPOConfig, mesh: Mesh) -> Callable:
    """Returns update(opt, steer_mb, throttle_mb) -> LossAux (mean over
    ranks): this rank's minibatch shards, gradients summed over the ranks,
    clipped, Adam; the banks and `opt` change in place, alike on every
    rank."""
    def update(opt, steer_mb: Minibatch, throttle_mb: Minibatch) -> LossAux:
        aux = update_step(steer, throttle, opt, steer_mb, throttle_mb, cfg,
                          grad_reduce=lambda g: sum_reduce_(g, mesh))
        aux = list(aux)
        mean_reduce_(aux, mesh)
        return LossAux(*aux)

    return update
