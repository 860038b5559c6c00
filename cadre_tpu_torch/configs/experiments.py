"""The experiment zoo: one record per perception experiment file of the
reference (carla_perception/Config/*.py), as (model_name, input_mode,
output_mode, att_type) over the mode tables of configs/danet_config.py;
the port's copy of cadre_tpu.configs.experiments.

`experiment_params(name)` gives the expanded DANetParams and
`build_experiment(name)` the model through the port's registry (None for
the DANet, which the perception trainer builds itself; the CIL nets for
the CIL records, which perception/cil_trainer.py trains).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from cadre_tpu_torch.configs.danet_config import (
    DANetParams,
    params_for_modes,
)

# name -> (model_name, input_mode, output_mode, att_type); att_type None:
# no inter-task attention; modes None: the file predates the mode system
# (the UNet and old-VAE families, the CIL nets) and takes modes (1, 0)
EXPERIMENTS: Dict[str, Tuple[str, Optional[int], Optional[int],
                             Optional[str]]] = {
    # production + danet ablations (auto_danet*.py)
    "auto_danet": ("danet", 9, 12, "transformer"),
    "auto_danet_exp30": ("danet", 7, 12, "transformer"),
    "auto_danet_exp31": ("danet", 7, 12, "transformer"),
    "auto_danet_exp32": ("danet", 5, 9, "position"),
    "auto_danet_exp33": ("danet", 5, 9, "position"),
    "auto_danet_exp34": ("danet", 9, 12, "transformer"),
    "auto_danet_exp34_train": ("danet", 9, 12, "transformer"),
    "auto_danet_exp35": ("danet", 9, 12, "transformer"),
    "auto_danet_exp36": ("danet", 9, 12, "transformer"),
    "auto_danet_exp37": ("danet", 5, 9, "transformer"),
    "auto_danet_exp38": ("danet", 5, 9, "position"),
    "auto_danet_exp39": ("danet", 5, 9, "position"),
    "auto_danet_exp41": ("danet", 5, 9, "position"),
    "auto_danet_exp48": ("danet", 9, 12, "transformer"),
    "auto_danet_exp49": ("danet", 5, 9, "transformer"),
    # no reference twin: production config plus the route-geometry head
    "auto_danet_geom": ("danet", 9, 12, "transformer"),
    # no reference twin: the geometry head, and the route raster blanked
    # from the input (kept as a target)
    "auto_danet_camroute": ("danet", 9, 12, "transformer"),
    # CoPM w/o attention — the paper's 'invaild' ablation
    "auto_danet_exp50": ("danet", 9, 12, "invaild"),
    "auto_danet_exp51": ("danet", 9, 12, "invaild"),
    # DA-beta-VAE family (auto_da_beta_vae*.py)
    "auto_da_beta_vae": ("da_beta_vae", 5, 9, "position"),
    "auto_da_beta_vae_exp43": ("da_beta_vae", 5, 9, "position"),
    "auto_da_beta_vae_exp44": ("da_beta_vae", 5, 9, "position"),
    "auto_da_beta_vae_exp45": ("da_beta_vae", 1, 13, "position"),
    "auto_da_beta_vae_exp46": ("da_beta_vae", 10, 14, "transformer"),
    "auto_da_beta_vae_exp47": ("da_beta_vae", 10, 14, "transformer"),
    # vanilla/beta VAE baselines
    "auto_vanilla_vae": ("vanilla_vae", 7, 9, None),
    "auto_vanilla_vae_exp16": ("vanilla_vae", 5, 8, None),
    "auto_vanilla_vae_exp17": ("vanilla_vae", 5, 8, None),
    "auto_vanilla_vae_exp19": ("vanilla_vae", 5, 8, None),
    "auto_vanilla_vae_exp20": ("vanilla_vae", 5, 8, None),
    "auto_vanilla_vae_exp21": ("vanilla_vae", 5, 8, None),
    "auto_vanilla_vae_exp23": ("vanilla_vae", 5, 9, None),
    "auto_vanilla_vae_exp27": ("vanilla_vae", 7, 9, None),
    "auto_beta_vae": ("beta_vae", 3, 4, None),
    # UNet family (auto_unet.py sets beta-vae-style modes 3/4)
    "auto_unet": ("unet", 3, 4, None),
    "auto_att_unet": ("att_unet", None, None, None),
    "auto_rcnn_unet": ("r2_unet", None, None, None),
    "auto_rcnn_attunet": ("r2att_unet", None, None, None),
    # pre-mode-system VAEs
    "auto_old_vae": ("old_vae", None, None, None),
    "auto_oldv2_vae": ("oldv2_vae", None, None, None),
    # CIL baselines (cil_net_config.py / cilrs_net_config.py)
    "cil_net": ("cil", None, None, None),
    "cilrs_net": ("cilrs", None, None, None),
}


def distinct_combos():
    """The unique (model, input_mode, output_mode, att_type) points of the
    grid."""
    return sorted({v for v in EXPERIMENTS.values()},
                  key=lambda v: (v[0], v[1] or 0, v[2] or 0, v[3] or ""))


def experiment_params(name: str, **overrides) -> DANetParams:
    model, in_mode, out_mode, att = EXPERIMENTS[name]
    if in_mode is None:
        in_mode, out_mode = 1, 0
    extra = dict(overrides)
    if name in ("auto_danet_geom", "auto_danet_camroute"):
        extra.setdefault("pred_route_geom", True)
        # a unit weight drowns beside the c*h*w-scaled recon losses
        extra.setdefault("route_geom_weight", 20000.0)
    if name == "auto_danet_camroute":
        extra.setdefault("in_route_blank", True)
    if att is not None:
        extra.setdefault("att_type", att)
    cfg = params_for_modes(in_mode, out_mode, **extra)
    return dataclasses.replace(cfg, model_name=model)


def build_experiment(name: str, seed: Optional[int] = None, **overrides):
    """(model or None for the DANet, cfg) of a named experiment; fresh
    weights are drawn from `seed` (see registry.build_model)."""
    from cadre_tpu_torch.models.registry import (
        adapt_config,
        build_model,
        seeded,
    )

    cfg = experiment_params(name, **overrides)
    model = cfg.model_name
    if model in ("cil", "cilrs"):
        from cadre_tpu_torch.models.cil import CarlaNet, CilrsNet

        return seeded(seed, CarlaNet if model == "cil" else CilrsNet), cfg
    cfg = adapt_config(model, cfg)
    return build_model(model, cfg, seed), cfg
