"""A multi-rank dry run on CPU processes: the twin of the JAX package's
`__graft_entry__.dryrun_multichip`.

`run_ranks(fn, n)` spawns n processes that form one gloo group over a
FileStore, runs `fn(mesh, *args)` on each (on the CPU, or on one card
that the ranks share) and returns the n results in rank order. Every group has a timeout and the parent joins with a
deadline, then kills what is left: a hung collective fails the run.

`dryrun_multigpu(n)` runs, on n ranks at tiny widths, the distributed PPO
minibatch update (gradients summed), one distributed perception step
(cross-replica BatchNorm) and one device iteration (rollout and the
sharded fused update), and checks each is finite and that the banks are
equal on every rank.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

RANK_TIMEOUT_S = 120.0


def _rank_main(fn, rank: int, world: int, store_path: str, args,
               timeout_s: float, device: str, out) -> None:
    import torch
    import torch.distributed as dist

    from cadre_tpu_torch.parallel.mesh import Mesh
    from cadre_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    try:
        dev = resolve_device(device)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = Mesh(dist.group.WORLD, rank, world, dev)
        out.put((rank, True, fn(mesh, *args)))
    except Exception:                 # reported to the parent, then exit 1
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, args: Sequence[Any] = (),
              timeout_s: float = RANK_TIMEOUT_S,
              store_dir: Optional[str] = None,
              device: str = "cpu") -> List[Any]:
    """fn(mesh, *args) on n spawned gloo ranks (fn and args must pickle: a
    module-level function), their FileStore in `store_dir` (a temporary
    directory by default), each mesh on `device` (gloo ranks may share
    one card); returns the results in rank order, or raises with the
    first rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="cadre_ranks_",
                                     dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, store, tuple(args), timeout_s,
                                   device, out), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < n and not errors:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:             # died before it could report
                        errors.append(f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result within {timeout_s:.0f} s")
                    continue
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("a rank failed: " + errors[0])
    return [results[r] for r in range(n)]


# --------------------------------------------------------------- the run

def _dryrun_rank(mesh) -> dict:
    import numpy as np
    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.models.policy import PolicyBank
    from cadre_tpu_torch.parallel.perception_step import (
        make_distributed_perception_trainer,
    )
    from cadre_tpu_torch.parallel.train_step import (
        make_distributed_update,
        shard_minibatch,
    )
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.device_rollout import train_device
    from cadre_tpu_torch.rl.ppo import PPOConfig, make_optimizer
    from cadre_tpu_torch.rl.rollout import Minibatch

    n, feature, seq = mesh.world, 32, 4
    batch = 2 * n
    torch.manual_seed(0)
    steer, throttle = PolicyBank(4, 33, feature), PolicyBank(4, 3, feature)
    cfg = PPOConfig(num_steps=batch, seq_length=seq)
    opt = make_optimizer([*steer.parameters(), *throttle.parameters()], cfg)
    gen = torch.Generator().manual_seed(2)

    def minibatch(outputs):
        return Minibatch(
            obs_seq=torch.randn(seq, batch, feature, generator=gen),
            action=torch.randint(0, outputs, (batch,), generator=gen),
            old_value=torch.randn(batch, generator=gen),
            returns=torch.randn(batch, generator=gen),
            mask=torch.ones(batch),
            old_log_prob=-torch.rand(batch, generator=gen),
            advantage=torch.randn(batch, generator=gen),
            hidden=(torch.zeros(batch, feature), torch.zeros(batch, feature)),
            command=torch.randint(0, 4, (batch,), generator=gen))

    update = make_distributed_update(steer, throttle, cfg, mesh)
    aux = update(opt, shard_minibatch(mesh, minibatch(33)),
                 shard_minibatch(mesh, minibatch(3)))

    pcfg = danet_params(image_height=64, image_width=96, feat_h=2, feat_w=3,
                        da_feature_channel=64, inter_att_dims=48, z_dims=32)
    trainer = make_distributed_perception_trainer(
        pcfg, PerceptionTrainParams(max_epochs=1, warmup_epochs=0), 1, mesh,
        seed=4)
    rng = np.random.RandomState(0)
    b = 2 * n
    losses = trainer.train_step({
        "x": rng.rand(b, 64, 96, 4).astype(np.float32),
        "camera_rgb": rng.rand(b, 64, 96, 3).astype(np.float32),
        "camera_seg": rng.randint(0, 8, (b, 64, 96)).astype(np.int64),
        "route_fig": rng.rand(b, 64, 96, 1).astype(np.float32),
        "speed": rng.rand(b, 1).astype(np.float32),
        "target_speed": rng.rand(b).astype(np.float32),
        "steer": rng.rand(b).astype(np.float32),
        "throttle": rng.rand(b).astype(np.float32),
        "command": rng.randint(0, 4, (b,)).astype(np.int64),
        "light_state": rng.randint(0, 4, (b,)).astype(np.int64),
        "light_dist": rng.rand(b).astype(np.float32)})

    agent = CadreAgent.create(
        danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16),
        seed=6, device="cpu")
    env = DrivingEnv(make_route_bank(2, seed=0, device="cpu"), num_envs=1,
                     seed=mesh.rank, device="cpu")
    rows = train_device(agent, env, iterations=1,
                        rollout_cfg=RolloutConfig(num_steps=4),
                        train_cfg=TrainConfig(ppo_epoch=1), log_fn=None,
                        mesh=mesh)
    banks = torch.cat([p.detach().reshape(-1) for p in
                       [*steer.parameters(), *throttle.parameters(),
                        *agent.policy_parameters()]])
    return dict(aux=[float(x) for x in aux],
                perception_total=float(losses["total"]),
                checksum=rows[0]["checksum"],
                banks=banks.numpy())


def dryrun_multigpu(n_devices: int) -> List[dict]:
    """The dry run on `n_devices` gloo CPU ranks; raises unless every
    figure is finite and the banks are equal on every rank. Returns each
    rank's figures."""
    import numpy as np

    out = run_ranks(_dryrun_rank, n_devices)
    for r, got in enumerate(out):
        figures = got["aux"] + [got["perception_total"], got["checksum"]]
        if not all(np.isfinite(figures)):
            raise RuntimeError(f"rank {r}: non-finite figures {figures}")
        if not np.array_equal(got["banks"], out[0]["banks"]):
            raise RuntimeError(f"rank {r}'s banks differ from rank 0's")
    return out
