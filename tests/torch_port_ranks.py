"""Rank-side work of tests/test_torch_port_parallel.py: module-level
functions that `cadre_tpu_torch.parallel.dryrun.run_ranks` runs on each
gloo CPU rank (spawned processes import this module, which imports torch
and the port only). Inputs and results are numpy."""
import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import RolloutConfig, TrainConfig
from cadre_tpu_torch.configs.danet_config import (
    PerceptionTrainParams,
    danet_params,
)
from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv
from cadre_tpu_torch.envs.vec_env import VecDrivingEnv
from cadre_tpu_torch.models.danet import DropoutMasks
from cadre_tpu_torch.models.policy import PolicyBank
from cadre_tpu_torch.models.torch_compat import (
    BatchNorm2d,
    set_batch_norm_group,
)
from cadre_tpu_torch.parallel.mesh import make_mesh, shard_rows
from cadre_tpu_torch.parallel.perception_step import (
    make_distributed_perception_trainer,
)
from cadre_tpu_torch.parallel.train_step import (
    make_distributed_update,
    shard_minibatch,
)
from cadre_tpu_torch.rl import fused_update, ppo, rollout
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.vec_train import train_vec
from cadre_tpu_torch.utils.convert import danet_from_flax, policy_from_flax


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i"
                            else x.copy())


def _banks(pnp, outputs, f):
    banks = {}
    for s, a in outputs.items():
        banks[s] = PolicyBank(4, a, f)
        banks[s].load_state_dict(policy_from_flax(pnp[s]))
    return banks


def _state(banks):
    return {s: {k: v.numpy().copy() for k, v in b.state_dict().items()}
            for s, b in banks.items()}


def _minibatch(a):
    return rollout.Minibatch(**{k: (tuple(_t(x) for x in v)
                                    if k == "hidden" else _t(v))
                                for k, v in a.items()})


def distributed_update(mesh, pnp, outputs, f, mbs):
    """make_distributed_update on this rank's shards of the global
    minibatches `mbs` (steer, throttle)."""
    banks = _banks(pnp, outputs, f)
    cfg = ppo.PPOConfig()
    opt = ppo.make_optimizer([*banks["steer"].parameters(),
                              *banks["throttle"].parameters()], cfg)
    update = make_distributed_update(banks["steer"], banks["throttle"], cfg,
                                     mesh)
    aux = update(opt, *(shard_minibatch(mesh, _minibatch(m)) for m in mbs))
    return dict(aux=[float(x) for x in aux], state=_state(banks))


def plain_update(pnp, outputs, f, mbs):
    """The same minibatches through ppo.update_step on one process."""
    banks = _banks(pnp, outputs, f)
    cfg = ppo.PPOConfig()
    opt = ppo.make_optimizer([*banks["steer"].parameters(),
                              *banks["throttle"].parameters()], cfg)
    aux = ppo.update_step(banks["steer"], banks["throttle"], opt,
                          *(_minibatch(m) for m in mbs), cfg)
    return dict(aux=[float(x) for x in aux], state=_state(banks))


def _buffer(a, rows):
    return rollout.RolloutBuffer(**{k: _t(v)[:, rows] for k, v in a.items()})


def sharded_fused(mesh, pnp, outputs, f, arrays, nv, epochs, mini_batch_num,
                  perms):
    """The fused update of this rank's envs (its contiguous share of the
    buffers' env axis), with `perms[rank]` injected when given."""
    banks = _banks(pnp, outputs, f)
    n = nv.shape[1]
    rows = slice(mesh.rank * n // mesh.world,
                 (mesh.rank + 1) * n // mesh.world)
    t = arrays["steer"]["obs"].shape[0] - 1
    cfg = ppo.PPOConfig(ppo_epoch=epochs)
    update = fused_update.make_fused_iteration_update(
        banks["steer"], banks["throttle"], cfg,
        RolloutConfig(num_steps=t, mini_batch_num=mini_batch_num,
                      seq_length=arrays["steer"]["obs"].shape[2],
                      feature_dims=f), seed=3, mesh=mesh)
    opt = ppo.make_optimizer([*banks["steer"].parameters(),
                              *banks["throttle"].parameters()], cfg)
    aux = update(opt, _buffer(arrays["steer"], rows),
                 _buffer(arrays["throttle"], rows),
                 (_t(nv[0])[rows], _t(nv[1])[rows]),
                 None if perms is None else tuple(
                     _t(p) for p in perms[mesh.rank]))
    return dict(aux=[float(x) for x in aux], state=_state(banks))


def plain_fused(pnp, outputs, f, arrays, nv, epochs, mini_batch_num, perms):
    """The unsharded fused update of every env, `perms` injected."""
    banks = _banks(pnp, outputs, f)
    t = arrays["steer"]["obs"].shape[0] - 1
    cfg = ppo.PPOConfig(ppo_epoch=epochs)
    update = fused_update.make_fused_iteration_update(
        banks["steer"], banks["throttle"], cfg,
        RolloutConfig(num_steps=t, mini_batch_num=mini_batch_num,
                      seq_length=arrays["steer"]["obs"].shape[2],
                      feature_dims=f))
    opt = ppo.make_optimizer([*banks["steer"].parameters(),
                              *banks["throttle"].parameters()], cfg)
    all_rows = slice(None)
    aux = update(opt, _buffer(arrays["steer"], all_rows),
                 _buffer(arrays["throttle"], all_rows),
                 (_t(nv[0]), _t(nv[1])), tuple(_t(p) for p in perms))
    return dict(aux=[float(x) for x in aux], state=_state(banks))


def batch_norm(mesh, x, weight, bias, cotangent):
    """A cross-replica BatchNorm2d in float64 on this rank's rows of `x`:
    its output, running statistics, and the gradients of
    sum(y * cotangent) for the input rows, the weight and the bias."""
    bn = BatchNorm2d(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.copy_(_t(weight))
        bn.bias.copy_(_t(bias))
    if mesh is not None:
        set_batch_norm_group(bn, mesh.group)
        x, cotangent = (shard_rows(_t(a), mesh) for a in (x, cotangent))
    else:
        x, cotangent = _t(x), _t(cotangent)
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * cotangent).sum().backward()
    return dict(y=y.detach().numpy(), mean=bn.running_mean.numpy(),
                var=bn.running_var.numpy(), dx=x.grad.numpy(),
                dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy())


def _masks(masks):
    head, att_bc, att_visual = (_t(m) for m in masks)
    return DropoutMasks(head.reshape(head.shape[0], -1), att_bc, att_visual)


def perception_steps(mesh, cfg_kw, vnp, batches, masks, weights, steps=2):
    """`steps` float64 train steps of the DANet `cfg_kw` from the variables
    `vnp` on the global `batches`, each rank with the local `masks`: every
    step's losses and the final state_dict."""
    cfg = danet_params(**cfg_kw)
    tp = PerceptionTrainParams(max_epochs=2)
    kw = dict(seg_class_weight=weights[0], light_class_weight=weights[1])
    if mesh is None:
        from cadre_tpu_torch.perception.trainer import PerceptionTrainer

        trainer = PerceptionTrainer(cfg, tp, 2, device="cpu", **kw)
    else:
        trainer = make_distributed_perception_trainer(cfg, tp, 2, mesh, **kw)
    trainer.model.load_state_dict(danet_from_flax(vnp, cfg))
    trainer.model.double()
    losses = [trainer.train_step(b, masks=_masks(masks))
              for b in batches[:steps]]
    return dict(losses=losses, state={
        k: v.numpy().copy() for k, v in trainer.model.state_dict().items()
        if not k.endswith("num_batches_tracked")})


def train_loops(mesh, seed):
    """One train_vec iteration on two fake envs per rank, rank r > 0
    starting from banks moved off rank 0's: every bank parameter
    flattened, and the value loss."""
    agent = CadreAgent.create(
        danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16),
        seed=seed, device="cpu")
    with torch.no_grad():
        for p in agent.policy_parameters():
            p.add_(0.1 * mesh.rank)
    envs = VecDrivingEnv([lambda k=k: FakeDrivingEnv(
        episode_length=2, seq_length=8, seed=2 * mesh.rank + k)
        for k in range(2)])
    stats = train_vec(envs, agent, RolloutConfig(num_steps=2, seq_length=8,
                                                 feature_dims=agent.obs_dim),
                      TrainConfig(ppo_epoch=1, log_interval=100),
                      iterations=1, seed=seed, mesh=mesh)
    banks = torch.cat([p.detach().reshape(-1)
                       for p in agent.policy_parameters()])
    return dict(banks=banks.numpy(), value_loss=stats[0].value_loss)


def mesh_refusal(mesh):
    """make_mesh in a world of 2 asked for 4 ranks: its message."""
    try:
        make_mesh(4, device="cpu")
    except ValueError as exc:
        return str(exc)
    return None


def cases(mesh, inputs):
    """Every case of `inputs` (a dict of argument tuples by case name) on
    this rank: {name: result}."""
    fns = dict(distributed_update=distributed_update,
               sharded_fused=sharded_fused, sharded_fused_perms=sharded_fused,
               batch_norm=batch_norm, perception_steps=perception_steps,
               train_loops=train_loops, mesh_refusal=mesh_refusal)
    return {name: fns[name](mesh, *args) for name, args in inputs.items()}
