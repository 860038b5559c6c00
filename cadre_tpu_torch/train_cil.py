"""CIL / CILRS baseline training entry point of the port:
`python -m cadre_tpu_torch.train_cil --data-dir <shards>`.

The counterpart of the JAX package's root `train_cil.py`: `--collect N`
first records N expert frames on the host simulator into --data-dir,
then `CILTrainer` trains a CilrsNet (a ResNet of `--arch`) or the
CarlaNet on the shards, writing `cil_epoch<N>.pt` into --work-dir. It
runs on the GPU unless given `--device cpu`.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a CIL/CILRS baseline")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--collect", type=int, default=0,
                   help="collect N expert frames into --data-dir first")
    p.add_argument("--model", default="cilrs", choices=["cilrs", "carla"])
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=48)
    p.add_argument("--work-dir", default="result/cil")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Train; returns the path of the last checkpoint."""
    args = parse_args(argv)

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.models.cil import CarlaNet, CilrsNet
    from cadre_tpu_torch.models.registry import seeded
    from cadre_tpu_torch.perception.cil_trainer import CILTrainer
    from cadre_tpu_torch.perception.data import PerceptionDataLoader
    from cadre_tpu_torch.train_perception import collect
    from cadre_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)        # no GPU: raise before collecting
    if args.collect > 0:
        collect(args.data_dir, args.collect, args.seed, vehicle_num=(8, 4))
    # the same batches as the JAX CLI's loader, moved as uint8 and kept
    # decompressed in host memory (the trainer expands them on the device)
    loader = PerceptionDataLoader(args.data_dir, batch_size=args.batch_size,
                                  seed=args.seed, packed=True,
                                  cache_in_memory=True)
    model = seeded(args.seed, lambda: CilrsNet(arch=args.arch)
                   if args.model == "cilrs" else CarlaNet())
    config = {"model_name": args.model}
    if args.model == "cilrs":
        config["arch"] = args.arch
    tp = PerceptionTrainParams(batch_size=args.batch_size,
                               max_epochs=args.epochs)
    trainer = CILTrainer(model, tp, steps_per_epoch=max(1, len(loader)),
                         seed=args.seed, device=args.device, config=config)

    def log(line):
        print(line, flush=True)

    trainer.solve(loader, epochs=args.epochs, work_dir=args.work_dir,
                  log_fn=log)
    path = f"{args.work_dir}/cil_epoch{args.epochs - 1}.pt"
    log(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
