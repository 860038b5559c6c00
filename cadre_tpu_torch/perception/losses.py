"""Multi-task perception losses (the counterpart of
cadre_tpu.perception.losses), on the JAX package's layouts: decoder maps
NHWC [B, H, W, K], class maps [B, H, W].

  seg: weighted cross entropy scaled by h*w (a 1-channel class target)
  image / route reconstruction: MSE scaled by c*h*w
  light state: weighted cross entropy; light dist: L1; bc: MSE; KLD
Total for output mode 12: seg + 0.5 route + light_weight * light state +
steer + throttle (+ light dist, route_geom_weight * route geometry, KLD
where those heads exist).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weight: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """torch CrossEntropyLoss(weight=w) semantics over the last axis: the
    mean per-sample NLL weighted by each label's class weight and divided
    by the sum of those weights."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if class_weight is None:
        return nll.mean()
    w = class_weight[labels.long()]
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-12)


def seg_loss(seg_logits: torch.Tensor, seg_target: torch.Tensor,
             class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """seg_logits [B, H, W, K], seg_target [B, H, W] class indices."""
    h, w = seg_target.shape[1], seg_target.shape[2]
    return weighted_cross_entropy(seg_logits, seg_target, class_weight) \
        * (h * w)


def recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE * c*h*w (NHWC)."""
    c, h, w = target.shape[-1], target.shape[1], target.shape[2]
    return torch.mean((pred - target) ** 2) * (c * h * w)


def light_state_loss(logits, labels, class_weight=None) -> torch.Tensor:
    return weighted_cross_entropy(logits, labels, class_weight)


def light_dist_loss(pred, target) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def bc_loss(pred, target) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def kld_loss(mu, logvar) -> torch.Tensor:
    return torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar),
                                       dim=1))


def total_danet_loss(outputs: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor], cfg,
                     seg_class_weight=None, light_class_weight=None,
                     light_weight: float = 0.1
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(weighted total, {term: unweighted value}) for the heads `cfg`
    turns on."""
    losses: Dict[str, torch.Tensor] = {}
    if cfg.pred_camera_seg:
        losses["seg"] = seg_loss(outputs["camera"], batch["camera_seg"],
                                 seg_class_weight)
        total = losses["seg"]
    else:
        losses["recon"] = recon_loss(outputs["camera"], batch["camera_rgb"])
        total = losses["recon"]
    if cfg.pred_route:
        losses["route"] = recon_loss(outputs["route"], batch["route_fig"])
        total = total + 0.5 * losses["route"]
    if cfg.pred_light_state:
        losses["light_state"] = light_state_loss(
            outputs["light_state"], batch["light_state"], light_class_weight)
        total = total + light_weight * losses["light_state"]
    if cfg.pred_light_dist:
        losses["light_dist"] = light_dist_loss(outputs["light_dist"][..., 0],
                                               batch["light_dist"])
        total = total + losses["light_dist"]
    if cfg.pred_bc:
        losses["steer"] = bc_loss(outputs["steer"], batch["steer"])
        losses["throttle"] = bc_loss(outputs["throttle"], batch["throttle"])
        total = total + losses["steer"] + losses["throttle"]
    if cfg.pred_route_geom:
        losses["route_geom"] = (
            bc_loss(outputs["route_geom"][:, 0], batch["dis"])
            + bc_loss(outputs["route_geom"][:, 1], batch["theta"]))
        total = total + cfg.route_geom_weight * losses["route_geom"]
    if "mu" in outputs:
        losses["visual_kld"] = kld_loss(outputs["mu"], outputs["logvar"])
        total = total + losses["visual_kld"]
    if "bc_mu" in outputs:
        losses["bc_kld"] = kld_loss(outputs["bc_mu"], outputs["bc_logvar"])
        total = total + losses["bc_kld"]
    return total, losses
