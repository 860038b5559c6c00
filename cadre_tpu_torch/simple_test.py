"""Smoke test of the port: `python -m cadre_tpu_torch.simple_test`.

The JAX package's root `simple_test.py` (the reference's `python
simple_test.py`): one env and one agent with random weights; scripted
throttle pulses drive the env while the agent acts on every tick; a line
per episode gives the last speed and rewards, and the last tick's 8-frame
RGB window is written side by side as one PNG (`--out`). `--env carla`
builds the kinematic simulator, as the JAX script's does. It runs on the
GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Smoke-test one env and agent")
    p.add_argument("--env", default="sim", choices=["sim", "fake", "carla"])
    p.add_argument("--episodes", type=int, default=2)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--out", default="simple_test_frames.png")
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run; returns the last tick, whose frames the PNG holds."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.perception.visualize import write_png
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.train import agent_gumbel

    danet_cfg = danet_params() if not args.small else danet_params(
        da_feature_channel=64, inter_att_dims=48, z_dims=32)
    agent = CadreAgent.create(danet_cfg, seed=0, device=args.device)
    gen = torch.Generator(device=agent.device)
    gen.manual_seed(0)

    if args.env == "fake":
        from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv

        env = FakeDrivingEnv(episode_length=args.steps)
    else:
        from cadre_tpu_torch.envs.sim_env import SimDrivingEnv

        env = SimDrivingEnv(seed=0)

    tick = env.reset()
    for ep in range(args.episodes):
        for i in range(args.steps):
            agent.act(tick, agent_gumbel(agent, 1, gen))
            throttle = 0.6 if (i // 10) % 2 == 0 else 0.0  # scripted pulses
            tick, rewards, done, info = env.step([0.0, throttle, 0.0])
            if done:
                tick = env.reset()
                break
        print(f"episode {ep}: speed={tick.get('speed', 0):.2f} "
              f"rewards={np.asarray(rewards).round(2).tolist()}", flush=True)

    write_png(args.out, np.concatenate(list(tick["rgb"]), axis=1))
    print(f"wrote {args.out}", flush=True)
    return tick


if __name__ == "__main__":
    main()
