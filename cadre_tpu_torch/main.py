"""Training entry point of the port: `python -m cadre_tpu_torch.main`.

The paths of the JAX package's `main.py`:
  - `--env sim` (the default) trains on the kinematic host simulator
    (`envs/sim_env.py`) and `--env fake` on the replay env: with
    `--num-envs 1`, `rl.train.train`, one env, snapshots every
    save_interval episodes to <work-dir>/0/models/ppo_model_<episode>.pt;
    with `--num-envs N`, `rl.vec_train.train_vec` over N in-process envs,
    or, with `--proc-envs`, N env worker processes behind shared-memory
    rings (`runtime/proc_vec_env.py`), snapshots every save_interval
    iterations to <work-dir>/models/ppo_model_<iteration>.pt. The envs are
    numpy on the host; the encoder, the banks, the buffers and the update
    live on the device. `--vehicles` / `--walkers` set the background
    traffic of each sim env, `--routes` drives it on a route XML's routes
    and `--scenarios` arms a scenario JSON's adversarial behaviours on
    them.
  - `--env carla` trains on CARLA servers (`envs/carla_env.py`, the
    `carla` package and a server per env, which this repository does not
    ship): env k connects to `--carla-host` at `--carla-port` + 10 k and
    loads `--town`, on `--routes` (required) with `--scenarios`, on the
    same three paths as `--env sim`. Without the `carla` package it raises
    ModuleNotFoundError.
  - `--env jax` runs the whole iteration (render, encode, act, step the
    batched device envs, then GAE and the PPO epochs) on the device
    through `rl.device_rollout.train_device`, and saves a snapshot at the
    end to <work-dir>/models/ppo_model_<iterations>.pt. There `--routes`
    banks a route XML's routes, `--hazards` arms that many crossing
    pedestrians per episode and `--priority-routes` turns on the route
    curriculum.
`--danet-checkpoint` freezes a trained encoder (a
`python -m cadre_tpu_torch.train_perception` checkpoint, a
reference-format .pt or a JAX package .msgpack) in the agent instead of a
random one: the cascade's second stage. `--config config_files/<x>.py`
takes the rollout and train configs from an experiment file
(`configs/loader.py`; feature_dims is the agent's), in place of
`--num-steps`, `--seq-length` and `--episodes`, on every `--env`.
`--mesh data` trains data-parallel over the ranks of `torchrun
--standalone --nproc-per-node G` (alone, a world of 1): each rank steps
N/G of the `--num-envs` envs (`--env jax`, or `--env sim|fake` with N >
1) on cuda:LOCAL_RANK, the banks stay equal on every rank, and rank 0
logs and writes the snapshots. It runs on the GPU unless given `--device
cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train the cadre_tpu_torch port on one device")
    p.add_argument("--env", default="sim",
                   choices=["sim", "fake", "carla", "jax"],
                   help="'sim': the kinematic host simulator; 'fake': the "
                        "replay env; 'carla': CARLA servers; 'jax': the "
                        "batched device env, the "
                        "whole iteration on the device "
                        "(rl/device_rollout.py)")
    p.add_argument("--episodes", type=int, default=3000,
                   help="episodes of --num-envs 1; iterations of the other "
                        "paths when --iterations is not given")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=1,
                   help="N > 1 trains N host envs behind one batched act")
    p.add_argument("--num-steps", type=int, default=200)
    p.add_argument("--seq-length", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--small", action="store_true",
                   help="small encoder (fast CPU runs)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--routes", default=None,
                   help="route XML: the sim env's routes, or the episode "
                        "bank of --env jax")
    p.add_argument("--vehicles", type=int, default=0,
                   help="background vehicles per sim episode")
    p.add_argument("--walkers", type=int, default=0,
                   help="walkers per sim episode")
    p.add_argument("--hazards", type=int, default=0,
                   help="--env jax: Scenario-3 crossing pedestrians per "
                        "episode")
    p.add_argument("--priority-routes", action="store_true",
                   help="--env jax: priority route curriculum (per-env "
                        "route table)")
    p.add_argument("--danet-checkpoint", default=None,
                   help="trained encoder (.pt or .msgpack) to freeze in "
                        "the agent")
    p.add_argument("--scenarios", default=None,
                   help="scenario JSON (or a directory of them) whose "
                        "triggers arm on the sim env's routes")
    p.add_argument("--proc-envs", action="store_true",
                   help="--num-envs N > 1: each env in a worker process "
                        "of its own, behind shared-memory rings")
    p.add_argument("--config", default=None,
                   help="config_files/*.py experiment (Config.fromfile): "
                        "its rollout_cfg and train_cfg")
    p.add_argument("--mesh", default=None, choices=[None, "data"],
                   help="'data': data-parallel over the torchrun ranks "
                        "(alone: one rank)")
    p.add_argument("--carla-host", default="localhost")
    p.add_argument("--carla-port", type=int, default=8010,
                   help="first server port; env k uses port+10*k "
                        "(reference main.py:63-70 / start_server.sh)")
    p.add_argument("--town", default="Town01", help="--env carla: the "
                   "town each server loads")
    return p.parse_args(argv)


def make_env(kind: str, rank: int, args, work_dir):
    """The host env of worker `rank`: its seed is offset by the rank, and a
    CARLA env's port by 10 * rank (start_server.sh). Picklable as a
    functools.partial, for the process envs."""
    if kind == "fake":
        from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv

        return FakeDrivingEnv(episode_length=args.num_steps,
                              seq_length=args.seq_length,
                              seed=args.seed + rank)
    if kind == "carla":
        from cadre_tpu_torch.envs.carla_env import CarlaDrivingEnv

        return CarlaDrivingEnv(
            host=args.carla_host, port=args.carla_port + 10 * rank,
            town=args.town, routes_file=args.routes,
            scenario_file=args.scenarios,
            vehicle_num=(args.vehicles, args.walkers),
            seq_length=args.seq_length, work_dir=work_dir, rank=rank)
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv

    return SimDrivingEnv(
        routes_file=args.routes, scenario_file=args.scenarios,
        vehicle_num=(args.vehicles, args.walkers), seed=args.seed + rank,
        seq_length=args.seq_length, work_dir=work_dir, rank=rank)


def build_env(args, work_dir):
    """The single env of `--num-envs 1` (the fake env at seed 0)."""
    if args.env == "fake":
        from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv

        return FakeDrivingEnv(episode_length=args.num_steps,
                              seq_length=args.seq_length)
    return make_env(args.env, 0, args, work_dir)


def main(argv=None) -> str:
    """Train; returns the path of the last snapshot written."""
    args = parse_args(argv)
    mesh, device, rank, world = None, args.device, 0, 1
    if args.mesh == "data":
        if args.env != "jax" and args.num_envs < 2:
            raise ValueError("--mesh data trains --env jax or --num-envs "
                             "N > 1; one env cannot be shared out")
        from cadre_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=args.device)
        device, rank, world = mesh.device, mesh.rank, mesh.world
        if args.num_envs % world:
            raise ValueError(f"--num-envs {args.num_envs} does not divide "
                             f"over {world} ranks")
    try:
        return _train(args, mesh, device, rank, world)
    finally:
        if mesh is not None:
            from cadre_tpu_torch.parallel.mesh import close_mesh

            close_mesh()


def _train(args, mesh, device, rank: int, world: int) -> str:
    """main() once the mesh, if any, is up: rank `rank` of `world`."""
    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.parallel.multihost import is_chief
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.utils.logger import logger, setup_logger

    now = datetime.datetime.now()
    work_dir = args.work_dir or os.path.join(
        "result", now.strftime("%Y-%m-%d"), now.strftime("%H-%M-%S"))
    danet_cfg = danet_params() if not args.small else danet_params(
        da_feature_channel=64, inter_att_dims=48, z_dims=32)
    encoder_state = None
    if args.danet_checkpoint:
        from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint

        encoder_state = load_danet_checkpoint(args.danet_checkpoint,
                                              danet_cfg)
    agent = CadreAgent.create(danet_cfg, seed=args.seed, device=device,
                              encoder_state=encoder_state)
    if args.config:
        from cadre_tpu_torch.configs.loader import load_experiment

        exp = load_experiment(args.config)
        rollout_cfg = dataclasses.replace(exp["rollout"],
                                          feature_dims=agent.obs_dim)
        train_cfg = exp["train"]
    else:
        rollout_cfg = RolloutConfig(num_steps=args.num_steps,
                                    seq_length=args.seq_length,
                                    feature_dims=agent.obs_dim)
        train_cfg = TrainConfig(max_episode=args.episodes)
    iterations = args.iterations if args.iterations is not None else \
        args.episodes
    n_local = args.num_envs // world          # this rank's envs
    chief = is_chief()

    if args.env == "jax":
        from cadre_tpu_torch.envs.torch_env import (
            DrivingEnv,
            EnvConfig,
            make_route_bank,
        )
        from cadre_tpu_torch.rl.device_rollout import train_device

        bank = make_route_bank(max(args.num_envs * 2, 16), seed=args.seed,
                               routes_file=args.routes, device=device)
        env = DrivingEnv(bank, num_envs=max(n_local, 1),
                         seed=args.seed + rank,
                         config=EnvConfig(n_hazards=args.hazards,
                                          priority_routes=args.priority_routes),
                         device=device)
        train_device(agent, env, iterations=iterations,
                     rollout_cfg=rollout_cfg, train_cfg=train_cfg,
                     seed=args.seed,
                     log_fn=lambda line: print(line, flush=True), mesh=mesh)
        path = os.path.join(work_dir, "models", f"ppo_model_{iterations}.pt")
        if chief:
            agent.save_snapshot(path)
    elif args.num_envs > 1:
        from cadre_tpu_torch.envs.vec_env import VecDrivingEnv
        from cadre_tpu_torch.rl.vec_train import train_vec

        setup_logger(work_dir, rank=rank)
        env_fns = [functools.partial(make_env, args.env, k, args, work_dir)
                   for k in range(rank * n_local, (rank + 1) * n_local)]
        if args.proc_envs:
            from cadre_tpu_torch.runtime.proc_vec_env import (
                ProcVecDrivingEnv,
            )

            vec = ProcVecDrivingEnv(env_fns, seq_length=args.seq_length)
        else:
            vec = VecDrivingEnv(env_fns)
        try:
            train_vec(vec, agent, rollout_cfg, train_cfg,
                      iterations=iterations, seed=args.seed,
                      work_dir=work_dir, mesh=mesh)
        finally:
            if args.proc_envs:
                vec.close()
        last = (iterations - 1) // train_cfg.save_interval \
            * train_cfg.save_interval
        path = os.path.join(work_dir, "models", f"ppo_model_{last}.pt")
    else:
        from cadre_tpu_torch.rl.train import train

        setup_logger(work_dir, rank=0)
        train(build_env(args, work_dir), agent, rollout_cfg, train_cfg,
              rank=0, work_dir=work_dir, seed=args.seed)
        last = (train_cfg.max_episode - 1) // train_cfg.save_interval \
            * train_cfg.save_interval
        path = os.path.join(work_dir, "0", "models", f"ppo_model_{last}.pt")
    logger.close()
    if chief:
        print(f"saved {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
