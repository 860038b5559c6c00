"""Perception pretraining entry point of the port:
`python -m cadre_tpu_torch.train_perception --data-dir <shards>`.

The counterpart of the JAX package's root `train_perception.py` on one
device: `--collect N` first records N expert frames on the host
simulator into --data-dir; `--experiment NAME` trains a record of the
experiment zoo, `--model NAME` a zoo model (the DANet by default); class
weights from the training shards, an optional held-out tail of shards
with its per-class report, `net_epoch<N>.pt` checkpoints in --work-dir
(a DANet's is the encoder that `python -m cadre_tpu_torch.main
--danet-checkpoint` takes). `--mesh` trains the production DANet
data-parallel over the ranks of `torchrun --standalone --nproc-per-node
G` (alone, a world of 1; `--mesh-devices` must equal G): each rank trains
on its rows of every batch of `--batch-size`, which must divide by G,
with cross-replica BatchNorm and mean-reduced gradients
(parallel/perception_step.py); rank 0 writes the checkpoints and the
holdout report. It runs on the GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses


def collect(data_dir: str, n_frames: int, seed: int, vehicle_num,
            **env_options) -> None:
    """Record `n_frames` expert frames on the host simulator into
    `data_dir` (`collect_dataset`), with the env settings of the JAX
    CLI's --collect."""
    from cadre_tpu_torch.envs.expert import OracleExpert
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.perception.data import collect_dataset

    env = SimDrivingEnv(seed=seed, seq_length=2, vehicle_num=vehicle_num,
                        **env_options)
    collect_dataset(env, OracleExpert(), n_frames, data_dir)


def parse_args(argv=None):
    from cadre_tpu_torch.models.registry import ZOO_NAMES

    p = argparse.ArgumentParser(description="Train the DANet encoder")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=48)
    p.add_argument("--work-dir", default="result/perception")
    p.add_argument("--save-interval", type=int, default=5)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--small", action="store_true",
                   help="small encoder head (fast CPU runs)")
    p.add_argument("--augment", action="store_true",
                   help="noise and pixel dropout on the rgb input (on the "
                        "device with --packed, else on the host)")
    p.add_argument("--packed", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="uint8 batches, expanded on the device")
    p.add_argument("--cache", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="keep decompressed shards in host memory")
    p.add_argument("--balance", action="store_true",
                   help="oversample rare light states and walker frames")
    p.add_argument("--holdout", action="store_true",
                   help="hold out the last shard(s); report per-class "
                        "accuracies after training")
    p.add_argument("--holdout-shards", type=int, default=1)
    p.add_argument("--light-weight", type=float, default=0.1,
                   help="light-state cross-entropy weight")
    p.add_argument("--seg-boost", action="append", default=[],
                   metavar="CLS:FACTOR",
                   help="multiply the seg class weight of CLS by FACTOR")
    p.add_argument("--camroute", action="store_true",
                   help="blank the route-raster input plane")
    p.add_argument("--device", default="cuda")
    p.add_argument("--collect", type=int, default=0,
                   help="collect N expert frames into --data-dir first")
    p.add_argument("--model", default="danet",
                   help="zoo model: " + " | ".join(ZOO_NAMES))
    p.add_argument("--experiment", default=None,
                   help="a record of configs/experiments.py EXPERIMENTS "
                        "(e.g. auto_danet_exp50, the CoPM w/o attention "
                        "ablation); overrides --model and the modes")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over the torchrun ranks (the "
                        "production DANet only)")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="--mesh: the ranks expected (default: all)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Train; returns the path of the last checkpoint."""
    args = parse_args(argv)
    if args.mesh and (args.experiment or args.model != "danet"):
        raise SystemExit("--mesh supports the production DANet only")
    mesh = None
    if args.mesh:
        from cadre_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh_devices, device=args.device)
        if args.batch_size % mesh.world:
            raise SystemExit(f"--batch-size {args.batch_size} must be "
                             f"divisible by the {mesh.world}-rank mesh")
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            from cadre_tpu_torch.parallel.mesh import close_mesh

            close_mesh()


def _train(args, mesh) -> str:
    """main() once the mesh, if any, is up."""
    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.configs.experiments import build_experiment
    from cadre_tpu_torch.models.registry import adapt_config, build_model
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )
    from cadre_tpu_torch.perception.trainer import (
        PerceptionTrainer,
        check_input_width,
    )
    from cadre_tpu_torch.parallel.multihost import is_chief
    from cadre_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device if mesh is None else mesh.device)
    chief = is_chief()
    small = dict(da_feature_channel=64, inter_att_dims=48, z_dims=32) \
        if args.small else {}
    if args.camroute:
        small["in_route_blank"] = True
    if args.experiment:
        model, cfg = build_experiment(args.experiment, seed=args.seed,
                                      **small)
    else:
        cfg = adapt_config(args.model, danet_params(**small))
        cfg = dataclasses.replace(cfg, model_name=args.model)
        model = build_model(args.model, cfg, seed=args.seed)
    check_input_width(cfg)             # before collecting
    if args.collect > 0 and chief:
        # a phase-balanced light cycle, slow traffic and doubled walkers,
        # so that red lights, cars and walkers have support in the labels
        collect(args.data_dir, args.collect, args.seed, vehicle_num=(8, 8),
                randomize_weather=True, light_times=(3.0, 3.0, 3.0),
                npc_cruise=(1.5, 5.0))
    if args.collect > 0 and mesh is not None:
        import torch.distributed as dist

        dist.barrier()                 # the other ranks wait for the shards

    all_paths = PerceptionDataLoader(args.data_dir,
                                     batch_size=args.batch_size).paths
    # the holdout split comes first: class weights and the schedule's
    # steps_per_epoch come from the training shards only
    holdout_paths, train_paths = None, all_paths
    if args.holdout and len(all_paths) > 1:
        k = min(args.holdout_shards, len(all_paths) - 1)
        holdout_paths, train_paths = all_paths[-k:], all_paths[:-k]
    loader = PerceptionDataLoader(train_paths, batch_size=args.batch_size,
                                  seed=args.seed,
                                  augment=args.augment and not args.packed,
                                  packed=args.packed,
                                  cache_in_memory=args.cache,
                                  balance=args.balance)
    stats = compute_stats(loader.paths)
    for spec in args.seg_boost:
        cls_s, fac_s = spec.split(":")
        w = stats.seg_class_weight.copy()
        w[int(cls_s)] *= float(fac_s)
        stats = dataclasses.replace(stats, seg_class_weight=w)
    tp = PerceptionTrainParams(batch_size=args.batch_size,
                               max_epochs=args.epochs,
                               w_light_state=args.light_weight)
    trainer = PerceptionTrainer(
        cfg, tp, steps_per_epoch=max(1, len(loader)), seed=args.seed,
        seg_class_weight=stats.seg_class_weight,
        light_class_weight=stats.light_class_weight, device=device,
        device_augment=args.augment and args.packed, model=model, mesh=mesh)
    if args.resume:
        trainer.load(args.resume)

    def log(line):
        if chief:
            print(line, flush=True)

    trainer.solve(loader, epochs=args.epochs, work_dir=args.work_dir,
                  save_interval=args.save_interval, log_fn=log)
    if holdout_paths and chief:
        rep = trainer.evaluate_per_class(PerceptionDataLoader(
            holdout_paths, batch_size=args.batch_size, seed=args.seed))
        for key in ("seg_per_class", "light_per_class"):
            if key in rep:
                log(f"holdout {key}: " + " ".join(
                    f"{v:.3f}" for v in rep[key]))
        log("holdout summary: " + " ".join(
            f"{k}={rep[k]:.4f}" for k in sorted(rep)
            if isinstance(rep[k], float)))
    path = f"{args.work_dir}/net_epoch{args.epochs - 1}.pt"
    log(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
