"""Data-parallel perception pretraining (the counterpart of
cadre_tpu.parallel.perception_step).

The reference trains perception with DDP + SyncBatchNorm over NCCL
(Models/experiments_builder.py:81-101); the JAX package shards the batch
over its mesh with cross-replica BatchNorm and pmean-ed gradients. Here
it is the port's PerceptionTrainer with a mesh: each rank trains on its
rows of the global batch, BatchNorm statistics span every rank's rows,
and gradients and losses are mean-reduced (perception/trainer.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from cadre_tpu_torch.configs.danet_config import (
    DANetParams,
    PerceptionTrainParams,
)
from cadre_tpu_torch.parallel.mesh import Mesh
from cadre_tpu_torch.perception.trainer import PerceptionTrainer


def make_distributed_perception_trainer(
        cfg: DANetParams, tp: PerceptionTrainParams, steps_per_epoch: int,
        mesh: Mesh, seed: int = 0,
        seg_class_weight: Optional[np.ndarray] = None,
        light_class_weight: Optional[np.ndarray] = None
        ) -> PerceptionTrainer:
    """This rank's trainer of the DANet `cfg` on the mesh's device, its
    weights and dropout draws from `seed` (rank 0's weights on every
    rank). `train_step(global_batch)` is one data-parallel step."""
    return PerceptionTrainer(cfg, tp, steps_per_epoch, seed=seed,
                             seg_class_weight=seg_class_weight,
                             light_class_weight=light_class_weight,
                             mesh=mesh)
