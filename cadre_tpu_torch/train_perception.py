"""Perception pretraining entry point of the port:
`python -m cadre_tpu_torch.train_perception --data-dir <shards>`.

The counterpart of the JAX package's root `train_perception.py` for the
production DANet on one device: class weights from the training shards,
an optional held-out tail of shards with its per-class report,
`net_epoch<N>.pt` checkpoints in --work-dir (the encoder that
`python -m cadre_tpu_torch.main --danet-checkpoint` takes). It runs on
the GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses

# flags of the JAX CLI whose features the port does not have yet, by the
# ROADMAP.md queue A item that ports them
UNPORTED = {
    "collect": "collecting expert frames needs the host env, ROADMAP.md "
               "queue A item 12",
    "experiment": "named experiments belong to the model zoo, ROADMAP.md "
                  "queue A item 14",
    "mesh": "data-parallel training, ROADMAP.md queue A item 16",
    "mesh_devices": "data-parallel training, ROADMAP.md queue A item 16",
}


def parse_args(argv=None):
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
    p.add_argument("--model", default="danet",
                   help="only 'danet' is ported (the zoo is ROADMAP.md "
                        "queue A item 14)")
    # not ported yet: each raises (see UNPORTED)
    p.add_argument("--collect", type=int, default=0)
    p.add_argument("--experiment", default=None)
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Train; returns the path of the last checkpoint."""
    args = parse_args(argv)
    for name, what in UNPORTED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')}: {what}; not ported yet")
    if args.model != "danet":
        raise NotImplementedError(
            f"--model {args.model}: the model zoo, ROADMAP.md queue A item "
            "14; not ported yet")

    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

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
    small = dict(da_feature_channel=64, inter_att_dims=48, z_dims=32) \
        if args.small else {}
    cfg = danet_params(**small, in_route_blank=args.camroute)
    tp = PerceptionTrainParams(batch_size=args.batch_size,
                               max_epochs=args.epochs,
                               w_light_state=args.light_weight)
    trainer = PerceptionTrainer(
        cfg, tp, steps_per_epoch=max(1, len(loader)), seed=args.seed,
        seg_class_weight=stats.seg_class_weight,
        light_class_weight=stats.light_class_weight, device=args.device,
        device_augment=args.augment and args.packed)
    if args.resume:
        trainer.load(args.resume)

    def log(line):
        print(line, flush=True)

    trainer.solve(loader, epochs=args.epochs, work_dir=args.work_dir,
                  save_interval=args.save_interval, log_fn=log)
    if holdout_paths:
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
