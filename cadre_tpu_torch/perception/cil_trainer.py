"""Conditional imitation (CIL / CILRS) training (the counterpart of
cadre_tpu.perception.cil_trainer): a command-branched control regressor
(`models.cil.CilrsNet` or `CarlaNet`) on the perception shards.

- `cil_loss`: MSE of the command's steer, throttle and brake (brake
  target 0) and 0.05 x the MSE of the speed head against speed / 9.
- `CILTrainer`: Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8)
  with L2 weight decay added to the gradient before the moments, and the
  warm-up + cosine schedule of the perception trainer
  (`warmup_cosine_lr`); `train_step`
  takes CarlaNet's dropout keep mask as `masks` or draws it from the
  trainer's generator; `solve` writes `cil_epoch<N>.pt`, whose config
  names the net.
Entry points run on the card unless given device="cpu".
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
from cadre_tpu_torch.perception.data import unpack_batch
from cadre_tpu_torch.perception.trainer import warmup_cosine_lr
from cadre_tpu_torch.rl.pipeline import DevicePrefetcher
from cadre_tpu_torch.utils.checkpoint import save_checkpoint
from cadre_tpu_torch.utils.device import resolve_device


def cil_loss(controls_pred, speed_pred, batch, speed_weight: float = 0.05):
    """(total, terms) for the command-selected controls [B, 3] and the
    predicted speed [B]."""
    steer_l = torch.mean((controls_pred[:, 0] - batch["steer"]) ** 2)
    throttle_l = torch.mean((controls_pred[:, 1] - batch["throttle"]) ** 2)
    brake_l = torch.mean(controls_pred[:, 2] ** 2)
    speed_l = torch.mean((speed_pred - batch["speed"][:, 0] / 9.0) ** 2)
    total = steer_l + throttle_l + brake_l + speed_weight * speed_l
    return total, {"steer": steer_l, "throttle": throttle_l,
                   "brake": brake_l, "speed": speed_l}


class CILTrainer:
    """`model` (a CIL net with fresh or given weights), its optimizer and
    schedule on one device; `config` is what its checkpoints record (the
    net's `model_name` and settings)."""

    def __init__(self, model: torch.nn.Module, tp: PerceptionTrainParams,
                 steps_per_epoch: int, seed: int = 0, device="cuda",
                 config: Optional[Dict[str, Any]] = None):
        self.tp = tp
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.config = dict(config or {})
        # optax.adam's defaults, whatever tp.betas says, as the JAX trainer
        self.opt = torch.optim.Adam(self.model.parameters(), lr=0.0,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=tp.weight_decay)
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def train_step(self, batch, masks=None,
                   sync: bool = True) -> Dict[str, Any]:
        """One optimizer step on `batch` (the loader's numpy arrays or
        tensors, packed or not). Returns the losses at the weights before
        the step: floats, or device scalars with sync=False."""
        self.model.train()
        batch = unpack_batch({k: torch.as_tensor(v).to(self.device)
                              for k, v in batch.items()})
        image = batch["camera_rgb"]
        if masks is None:
            masks = self.model.draw_masks(image.shape[0], self.generator,
                                          self.device)
        for group in self.opt.param_groups:
            group["lr"] = warmup_cosine_lr(self.step, self.tp,
                                           self.steps_per_epoch)
        self.opt.zero_grad(set_to_none=True)
        controls, speed_pred = self.model(image, batch["speed"],
                                          batch["command"], masks=masks)[:2]
        total, losses = cil_loss(controls, speed_pred, batch)
        total.backward()
        self.opt.step()
        self.step += 1
        losses = {k: v.detach() for k, v in dict(losses, total=total).items()}
        return losses if not sync else {k: float(v) for k, v in
                                        losses.items()}

    def solve(self, loader, epochs: Optional[int] = None,
              work_dir: Optional[str] = None, save_interval: int = 5,
              log_fn: Callable[[str], None] = print) -> Dict[str, float]:
        """Train for `epochs` (default tp.max_epochs); returns the last
        epoch's mean losses."""
        epochs = epochs or self.tp.max_epochs
        last: Dict[str, float] = {}
        for epoch in range(epochs):
            t0 = time.perf_counter()
            agg: Dict[str, torch.Tensor] = {}
            n = 0
            for batch in DevicePrefetcher(loader, self.device):
                for k, v in self.train_step(batch, sync=False).items():
                    agg[k] = agg[k] + v if k in agg else v
                n += 1
            last = {k: float(v) / max(n, 1) for k, v in agg.items()}
            fps = n * loader.batch_size / max(time.perf_counter() - t0, 1e-9)
            log_fn(f"cil epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in last.items())
                + f" ({fps:.1f} frames/s)")
            if work_dir and (epoch % save_interval == 0
                             or epoch == epochs - 1):
                self.save(os.path.join(work_dir, f"cil_epoch{epoch}.pt"))
        return last

    def save(self, path: str) -> None:
        save_checkpoint(path, self.model.state_dict(), self.config)
