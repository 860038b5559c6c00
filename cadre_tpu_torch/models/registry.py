"""Model name -> perception module (the counterpart of
cadre_tpu.models.registry, the reference's `get_model` role).

`build_model(name, cfg)` gives a module under the perception trainer's
heads contract (`model(x, masks=None, generator=None)` -> a dict with
"camera" / "route" / "light_state" / "mu" / ... keys), or None for
"danet", which the trainer builds itself (it alone takes bc_speed).
`adapt_config` turns off the heads a model does not emit, so that the
multi-task loss scores only heads that exist.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, TypeVar

import torch
from torch import nn

from cadre_tpu_torch.configs.danet_config import DANetParams

ZOO_NAMES = ("danet", "vanilla_vae", "beta_vae", "da_beta_vae", "old_vae",
             "oldv2_vae", "unet", "att_unet", "r2_unet", "r2att_unet",
             "nested_unet")
_T = TypeVar("_T")
_UNETS = {
    "unet": dict(recurrent=False, attention=False),
    "att_unet": dict(recurrent=False, attention=True),
    "r2_unet": dict(recurrent=True, attention=False),
    "r2att_unet": dict(recurrent=True, attention=True),
}


def seeded(seed: Optional[int], build: Callable[[], _T]) -> _T:
    """`build()` with torch's global CPU generator seeded with `seed` for
    its duration (the caller's state is restored after), so that fresh
    weights depend on `seed` alone; unseeded when `seed` is None."""
    if seed is None:
        return build()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class SingleHeadAdapter(nn.Module):
    """An image-to-image module (the U-Net family) under the heads
    contract: its NHWC output under one key."""

    def __init__(self, inner: nn.Module, key: str = "camera"):
        super().__init__()
        self.inner = inner
        self.key = key

    def forward(self, x, masks=None, generator=None):
        return {self.key: self.inner(x)}


def adapt_config(name: str, cfg: DANetParams) -> DANetParams:
    name = name.lower()
    if name in tuple(_UNETS) + ("nested_unet",):
        return dataclasses.replace(cfg, pred_route=False,
                                   pred_light_state=False,
                                   pred_light_dist=False, pred_bc=False)
    if name == "old_vae":
        return dataclasses.replace(cfg, pred_camera_seg=False,
                                   pred_route=False, pred_light_state=False,
                                   pred_light_dist=False, pred_bc=False)
    if name == "oldv2_vae":
        return dataclasses.replace(cfg, pred_light_dist=False,
                                   pred_bc=False)
    return cfg


def build_model(name: str, cfg: DANetParams,
                seed: Optional[int] = None) -> Optional[nn.Module]:
    """A zoo module with fresh weights drawn from `seed` (torch's global
    generator as it stands when None), for one of ZOO_NAMES."""
    return seeded(seed, lambda: _fresh(name.lower(), cfg))


def _fresh(name: str, cfg: DANetParams) -> Optional[nn.Module]:
    from cadre_tpu_torch.models.unet import NestedUNet, UNet
    from cadre_tpu_torch.models.vae import (
        BetaVAE,
        DABetaVAE,
        OldV2VAE,
        OldVAE,
        VanillaVAE,
    )

    if name == "danet":
        return None
    vaes = {"vanilla_vae": VanillaVAE, "beta_vae": BetaVAE,
            "da_beta_vae": DABetaVAE, "old_vae": OldVAE,
            "oldv2_vae": OldV2VAE}
    if name in vaes:
        return vaes[name](cfg)
    out_ch = cfg.camera_output_channel
    if name in _UNETS:
        return SingleHeadAdapter(UNet(cfg.input_channel, out_ch,
                                      **_UNETS[name]))
    if name == "nested_unet":
        return SingleHeadAdapter(NestedUNet(cfg.input_channel, out_ch))
    raise ValueError(f"unknown model name {name!r}")
