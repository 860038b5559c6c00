"""Ensemble evaluation entry point of the port: `python -m cadre_tpu_torch.eval`.

The JAX package's root `eval.py` on host envs: K member snapshots (the
port's `save_snapshot` files, the JAX package's `.msgpack` snapshots or
the reference's ppo_model_<N>.pt files, mixed as they come; globs
allowed) drive `--episodes` episodes of
the kinematic simulator (`--env sim`, with `--routes`, `--scenarios`,
`--vehicles` and `--walkers`), a CARLA server (`--env carla`: the `carla`
package and a server at `--carla-host`:`--carla-port` that loads `--town`,
on the same four options; the routes are run in order) or the replay env
(`--env fake`) through
`rl.evaluate.evaluate`, one averaged control a tick. Per-criterion rows go
to <work-dir>/criteria_results.csv and the sim env's completion ratios to
<work-dir>/eval_completion_ratio.csv; the last line printed is the mean
completion ratio. `--danet-checkpoint` freezes a trained encoder in the
agent. It runs on the GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a cadre_tpu_torch snapshot ensemble")
    p.add_argument("--env", default="sim", choices=["sim", "fake", "carla"])
    p.add_argument("--snapshots", nargs="+", required=True,
                   help="member snapshot paths (.pt or .msgpack; globs "
                        "ok)")
    p.add_argument("--episodes", type=int, default=25)
    p.add_argument("--routes", default=None)
    p.add_argument("--scenarios", default=None)
    p.add_argument("--vehicles", type=int, default=20)
    p.add_argument("--walkers", type=int, default=50)
    p.add_argument("--seq-length", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--work-dir", default="result/eval")
    p.add_argument("--small", action="store_true",
                   help="small encoder (fast CPU runs)")
    p.add_argument("--danet-checkpoint", default=None,
                   help="trained encoder (.pt or .msgpack) to freeze in "
                        "the agent")
    p.add_argument("--device", default="cuda")
    p.add_argument("--carla-host", default="localhost")
    p.add_argument("--carla-port", type=int, default=8010)
    p.add_argument("--town", default="Town01")
    return p.parse_args(argv)


def main(argv=None):
    """Evaluate; returns the EvalEpisodeResults."""
    args = parse_args(argv)

    from cadre_tpu_torch.configs.agent_config import EvalConfig
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.evaluate import evaluate
    from cadre_tpu_torch.utils.logger import logger, setup_logger

    paths = []
    for pat in args.snapshots:
        paths.extend(sorted(glob.glob(pat)))
    if not paths:
        raise SystemExit("no snapshots matched")

    setup_logger(args.work_dir)
    danet_cfg = danet_params() if not args.small else danet_params(
        da_feature_channel=64, inter_att_dims=48, z_dims=32)
    encoder_state = None
    if args.danet_checkpoint:
        from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint

        encoder_state = load_danet_checkpoint(args.danet_checkpoint,
                                              danet_cfg)
    agent = CadreAgent.create(danet_cfg, seed=args.seed, device=args.device,
                              encoder_state=encoder_state)

    if args.env == "fake":
        from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv

        env = FakeDrivingEnv(seq_length=args.seq_length)
    elif args.env == "carla":
        from cadre_tpu_torch.envs.carla_env import CarlaDrivingEnv

        env = CarlaDrivingEnv(
            host=args.carla_host, port=args.carla_port, town=args.town,
            routes_file=args.routes, scenario_file=args.scenarios,
            vehicle_num=(args.vehicles, args.walkers), training=False,
            seq_length=args.seq_length, work_dir=args.work_dir)
    else:
        from cadre_tpu_torch.envs.sim_env import SimDrivingEnv

        env = SimDrivingEnv(
            routes_file=args.routes, scenario_file=args.scenarios,
            vehicle_num=(args.vehicles, args.walkers), training=False,
            seq_length=args.seq_length, work_dir=args.work_dir,
            seed=args.seed)

    results = evaluate(env, agent, paths,
                       EvalConfig(eval_episode=args.episodes),
                       seed=args.seed,
                       result_file=os.path.join(args.work_dir,
                                                "criteria_results.csv"))
    logger.close()
    mean_ratio = sum(r.completion_ratio for r in results) / len(results)
    print(f"mean completion ratio over {len(results)} episodes: "
          f"{mean_ratio:.2f}%", flush=True)
    return results


if __name__ == "__main__":
    main()
