"""Training entry point of the port: `python -m cadre_tpu_torch.main`.

The `--env jax` path of the JAX package's `main.py`: the whole iteration
(render, encode, act, step the batched device envs, then GAE and the PPO
epochs) runs on one device through `rl.device_rollout.train_device`, and a
snapshot of both policy banks is saved at the end to
<work-dir>/models/ppo_model_<iterations>.pt. `--routes` banks the routes
of a route XML instead of synthetic ones, `--hazards` arms that many
crossing pedestrians per episode and `--priority-routes` turns on the
route curriculum. `--danet-checkpoint` freezes a trained encoder (a
`python -m cadre_tpu_torch.train_perception` checkpoint or a
reference-format .pt) in the agent instead of a random one: the cascade's
second stage. It runs on the GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import datetime
import os

# flags of the JAX CLI whose features the port does not have yet, by the
# ROADMAP.md queue A item that ports them
UNPORTED = {
    "config": "experiment config files, ROADMAP.md queue A item 15",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train the cadre_tpu_torch port on one device")
    p.add_argument("--env", default="jax", choices=["jax"],
                   help="'jax': the batched device env; the whole iteration "
                        "runs on the device (rl/device_rollout.py)")
    p.add_argument("--episodes", type=int, default=3000,
                   help="iteration count when --iterations is not given")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=1)
    p.add_argument("--num-steps", type=int, default=200)
    p.add_argument("--seq-length", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--small", action="store_true",
                   help="small encoder (fast CPU runs)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--routes", default=None,
                   help="route XML whose routes make the episode bank")
    p.add_argument("--hazards", type=int, default=0,
                   help="Scenario-3 crossing pedestrians per episode")
    p.add_argument("--priority-routes", action="store_true",
                   help="priority route curriculum (per-env route table)")
    p.add_argument("--danet-checkpoint", default=None,
                   help="trained encoder (.pt) to freeze in the agent")
    # not ported yet: raises (see UNPORTED)
    p.add_argument("--config", default=None)
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Train; returns the snapshot's path."""
    args = parse_args(argv)
    for name, what in UNPORTED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')}: {what}; not ported yet")

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import (
        DrivingEnv,
        EnvConfig,
        make_route_bank,
    )
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.device_rollout import train_device

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
    agent = CadreAgent.create(danet_cfg, seed=args.seed, device=args.device,
                              encoder_state=encoder_state)
    rollout_cfg = RolloutConfig(num_steps=args.num_steps,
                                seq_length=args.seq_length,
                                feature_dims=agent.obs_dim)
    train_cfg = TrainConfig(max_episode=args.episodes)
    bank = make_route_bank(max(args.num_envs * 2, 16), seed=args.seed,
                           routes_file=args.routes, device=args.device)
    env = DrivingEnv(bank, num_envs=max(args.num_envs, 1), seed=args.seed,
                     config=EnvConfig(n_hazards=args.hazards,
                                      priority_routes=args.priority_routes),
                     device=args.device)
    iterations = args.iterations if args.iterations is not None else \
        args.episodes
    train_device(agent, env, iterations=iterations, rollout_cfg=rollout_cfg,
                 train_cfg=train_cfg, seed=args.seed,
                 log_fn=lambda line: print(line, flush=True))
    path = os.path.join(work_dir, "models", f"ppo_model_{iterations}.pt")
    agent.save_snapshot(path)
    print(f"saved {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
