"""Perception pretraining of the CoPM encoder-decoder (the counterpart of
cadre_tpu.perception.trainer).

- Adam (lr, betas, eps 1e-8) with L2 weight decay added to every
  gradient before the moments, biases and BatchNorm scales included: the
  JAX package's optax.chain(add_decayed_weights, adam).
- The learning rate of step n is `warmup_cosine_lr(n)`, optax's
  warmup_cosine_decay_schedule(0, lr, warmup, decay, 0) read at the count
  before the update, as optax reads it: 0 at step 0, a linear rise over
  warmup_epochs x steps_per_epoch steps, then a cosine to 0 at
  max_epochs x steps_per_epoch.
- `train_step`: forward in train mode (flax BatchNorm statistics, dropout
  masks given or drawn from the trainer's generator), the multi-task loss,
  backward (through the dual-attention backward kernel on the card), the
  optimizer step; `sync=False` leaves the losses on the device.
- `eval_step` / `evaluate` / `evaluate_per_class`: eval-mode losses and
  seg / light accuracies, and the per-class tables of the reference's
  held-out protocol.
- `solve`: the epoch loop over a loader through `DevicePrefetcher`,
  writing `net_epoch<N>.pt` checkpoints.
Entry points run on the card unless given device="cpu". Not ported: the
recon visualisations (`_dump_recon`, which need matplotlib) and the model
zoo's `model=` argument (ROADMAP.md queue A item 14).
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from cadre_tpu_torch.configs.danet_config import (
    DANetParams,
    PerceptionTrainParams,
)
from cadre_tpu_torch.models.danet import DANet, DropoutMasks, draw_dropout_masks
from cadre_tpu_torch.perception.data import blank_route_plane, unpack_batch
from cadre_tpu_torch.perception.losses import total_danet_loss
from cadre_tpu_torch.perception.prefetch import DevicePrefetcher
from cadre_tpu_torch.utils.checkpoint import (
    load_danet_checkpoint,
    save_danet_checkpoint,
)
from cadre_tpu_torch.utils.device import resolve_device

Batch = Dict[str, Any]


def make_optimizer(params, tp: PerceptionTrainParams) -> torch.optim.Adam:
    """torch Adam with weight_decay is L2 on the gradient before the
    moments (not AdamW), optax's add_decayed_weights then adam."""
    return torch.optim.Adam(params, lr=0.0, betas=tuple(tp.betas), eps=1e-8,
                            weight_decay=tp.weight_decay)


def warmup_cosine_lr(step: int, tp: PerceptionTrainParams,
                     steps_per_epoch: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, tp.lr, warmup, decay, 0) at
    `step`, with the JAX trainer's warmup and decay step counts."""
    warmup = max(1, tp.warmup_epochs * steps_per_epoch)
    decay = max(warmup + 1, tp.max_epochs * steps_per_epoch)
    if step < warmup:
        return tp.lr * step / warmup
    t = min(step - warmup, decay - warmup)
    return tp.lr * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warmup)))


class PerceptionTrainer:
    """One DANet, its optimizer and schedule on one device. `state_dict`
    starts from given weights (else random ones from `seed`)."""

    def __init__(self, cfg: DANetParams, tp: PerceptionTrainParams,
                 steps_per_epoch: int, seed: int = 0,
                 seg_class_weight: Optional[np.ndarray] = None,
                 light_class_weight: Optional[np.ndarray] = None,
                 device="cuda", device_augment: bool = False,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg, self.tp = cfg, tp
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.device_augment = device_augment
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = DANet(cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).train()
        self.opt = make_optimizer(self.model.parameters(), tp)
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        def weight(w):
            return None if w is None else torch.as_tensor(
                np.asarray(w, np.float32), device=self.device)

        self.seg_w, self.light_w = weight(seg_class_weight), \
            weight(light_class_weight)

    # ---------------- steps ----------------

    def lr(self, step: int) -> float:
        return warmup_cosine_lr(step, self.tp, self.steps_per_epoch)

    def _to_device(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return unpack_batch({k: torch.as_tensor(v).to(self.device)
                             for k, v in batch.items()})

    def _apply(self, batch, masks: Optional[DropoutMasks] = None):
        x = batch["x"]
        if self.cfg.in_route_blank:
            x = blank_route_plane(x)
        return self.model(x, batch["speed"], masks=masks,
                          generator=self.generator)

    def _augment_on_device(self, batch):
        """Noise (std 4/255) and coarse pixel dropout (5% of pixels) on the
        rgb planes of x, drawn from the trainer's generator; the targets
        stay clean."""
        x = batch["x"]
        rgb = x[..., :3]
        noise = torch.randn(rgb.shape, generator=self.generator,
                            device=x.device)
        keep = torch.rand(rgb.shape[:3] + (1,), generator=self.generator,
                          device=x.device) > 0.05
        rgb = torch.clamp((rgb + noise * (4.0 / 255.0)) * keep, 0.0, 1.0)
        return dict(batch, x=torch.cat([rgb, x[..., 3:]], dim=-1))

    def _losses(self, outputs, batch):
        return total_danet_loss(outputs, batch, self.cfg, self.seg_w,
                                self.light_w,
                                light_weight=self.tp.w_light_state)

    def train_step(self, batch: Batch, masks: Optional[DropoutMasks] = None,
                   sync: bool = True) -> Dict[str, Any]:
        """One optimizer step on `batch` (numpy arrays or tensors, packed
        or not); `masks` fixes the dropout draws. Returns the losses at the
        weights before the step: floats, or device scalars with
        sync=False."""
        self.model.train()
        batch = self._to_device(batch)
        if self.device_augment:
            batch = self._augment_on_device(batch)
        if masks is None:
            masks = draw_dropout_masks(self.cfg, batch["x"].shape[0],
                                       self.generator, self.device)
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.step)
        self.opt.zero_grad(set_to_none=True)
        total, losses = self._losses(self._apply(batch, masks), batch)
        total.backward()
        self.opt.step()
        self.step += 1
        losses = {k: v.detach() for k, v in dict(losses, total=total).items()}
        return losses if not sync else {k: float(v) for k, v in
                                        losses.items()}

    @torch.no_grad()
    def _eval_outputs(self, batch: Batch):
        self.model.eval()
        batch = self._to_device(batch)
        return self._apply(batch), batch

    def eval_step(self, batch: Batch) -> Dict[str, float]:
        """Eval-mode losses, and the seg pixel and light accuracies."""
        outputs, batch = self._eval_outputs(batch)
        total, losses = self._losses(outputs, batch)
        metrics = dict(losses, total=total)
        if self.cfg.pred_camera_seg:
            pred = outputs["camera"].argmax(dim=-1)
            metrics["seg_accuracy"] = (pred == batch["camera_seg"]).float() \
                .mean()
        if self.cfg.pred_light_state:
            pred = outputs["light_state"].argmax(dim=-1)
            metrics["light_accuracy"] = (pred == batch["light_state"]) \
                .float().mean()
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, loader) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        n = 0
        for batch in loader:
            for k, v in self.eval_step(batch).items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
        return {k: v / max(n, 1) for k, v in agg.items()}

    def evaluate_per_class(self, loader, num_seg_classes: int = 8,
                           num_light_classes: int = 4) -> Dict[str, Any]:
        """Held-out per-class accuracies: {'seg_per_class', 'seg_counts',
        'light_per_class', 'light_counts', 'seg_mean_class_acc',
        'light_mean_class_acc', 'seg_pixel_acc', 'light_acc'} (and the
        route-geometry R^2 and MSE with that head)."""
        agg: Dict[str, np.ndarray] = {}

        def add(key, value):
            agg[key] = agg.get(key, 0.0) + value.double().cpu().numpy()

        for batch in loader:
            outputs, batch = self._eval_outputs(batch)
            if self.cfg.pred_camera_seg:
                pred = outputs["camera"].argmax(dim=-1)
                true = batch["camera_seg"].long()
                hit = (pred == true)
                add("seg_correct", torch.bincount(
                    true[hit], minlength=num_seg_classes))
                add("seg_total", torch.bincount(
                    true.flatten(), minlength=num_seg_classes))
            if self.cfg.pred_light_state:
                pred = outputs["light_state"].argmax(dim=-1)
                true = batch["light_state"].long()
                add("light_correct", torch.bincount(
                    true[pred == true], minlength=num_light_classes))
                add("light_total", torch.bincount(
                    true, minlength=num_light_classes))
            if self.cfg.pred_route_geom:
                true = torch.stack([batch["dis"], batch["theta"]], dim=-1)
                add("geom_se", ((outputs["route_geom"] - true) ** 2).sum(0))
                add("geom_sum", true.sum(0))
                add("geom_sumsq", (true ** 2).sum(0))
                add("geom_n", torch.tensor(float(true.shape[0])))
        report: Dict[str, Any] = {}
        for name in ("seg", "light"):
            if f"{name}_total" not in agg:
                continue
            total, correct = agg[f"{name}_total"], agg[f"{name}_correct"]
            per = correct / np.maximum(total, 1.0)
            seen = total > 0
            report[f"{name}_per_class"] = per
            report[f"{name}_counts"] = total
            report[f"{name}_mean_class_acc"] = float(per[seen].mean()) \
                if seen.any() else 0.0
            acc = float(correct.sum() / max(total.sum(), 1.0))
            report["seg_pixel_acc" if name == "seg" else "light_acc"] = acc
        if "geom_se" in agg:
            n = max(float(agg["geom_n"]), 1.0)
            var = agg["geom_sumsq"] - agg["geom_sum"] ** 2 / n
            r2 = 1.0 - agg["geom_se"] / np.maximum(var, 1e-9)
            report["geom_r2_dis"] = float(r2[0])
            report["geom_r2_theta"] = float(r2[1])
            report["geom_mse"] = (agg["geom_se"] / n).tolist()
        return report

    # ---------------- epoch loop ----------------

    def solve(self, loader, epochs: Optional[int] = None,
              work_dir: Optional[str] = None, save_interval: int = 5,
              log_fn: Callable[[str], None] = print) -> Dict[str, float]:
        """Train for `epochs` (default tp.max_epochs); returns the last
        epoch's mean losses. Losses stay on the device within an epoch
        and are read once at its end."""
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
            log_fn(f"perception epoch {epoch}: " + ", ".join(
                f"{k}={v:.3f}" for k, v in last.items())
                + f" ({fps:.1f} frames/s)")
            if work_dir and (epoch % save_interval == 0
                             or epoch == epochs - 1):
                self.save(os.path.join(work_dir, f"net_epoch{epoch}.pt"))
        return last

    # ---------------- checkpoints ----------------

    def save(self, path: str) -> None:
        save_danet_checkpoint(path, self.model.state_dict(), self.cfg)

    def load(self, path: str) -> None:
        self.model.load_state_dict(load_danet_checkpoint(path, self.cfg))
