"""Perception checkpoints: the port's `torch.save` files and the
reference's.

A port checkpoint (`PerceptionTrainer.save`, `net_epoch<N>.pt`;
`CILTrainer`'s `cil_epoch<N>.pt`) holds {"state_dict": the model's
state_dict, "config": its DANetParams fields, or the CIL net's settings},
and the config names the model (`model_name`: "danet", a zoo name, or
"cilrs" / "carla"; a checkpoint without one is a DANet's). A checkpoint
is refused by a model of another name or other widths.
A reference-format checkpoint holds the state_dict under "autoencoder"
(cadre_tpu.utils.checkpoint.load_danet_pt reads the same key); the port's
module names are the reference's, so either loads with load_state_dict.
The JAX package's flax `.msgpack` snapshots are not read yet (ROADMAP.md
queue A item 15): this machine's torch has no msgpack reader.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from cadre_tpu_torch.configs.danet_config import DANetParams

StateDict = Dict[str, torch.Tensor]
# fields that decide the shape of some weight
_SHAPE_FIELDS = ("backbone", "input_channel", "da_feature_channel",
                 "inter_att_dims", "z_dims", "att_type")


def save_checkpoint(path: str, state_dict: StateDict,
                    config: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": state_dict, "config": config}, path)


def save_danet_checkpoint(path: str, state_dict: StateDict,
                          cfg: DANetParams) -> None:
    """A perception checkpoint: the DANet's, or a zoo model's (the
    config's `model_name` says which)."""
    save_checkpoint(path, state_dict, dataclasses.asdict(cfg))


def load_danet_checkpoint(path: str, cfg: DANetParams) -> StateDict:
    """The state_dict (CPU tensors) in a port or reference-format
    checkpoint at `path` for the model `cfg.model_name` describes. Raises
    on a JAX `.msgpack` snapshot, and on a port checkpoint of another
    model or made for another width than `cfg`."""
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: a JAX package .msgpack snapshot; the port reads its "
            "own .pt checkpoints and reference-format .pt files only "
            "(reading msgpack is ROADMAP.md queue A item 15)")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "autoencoder" in blob:
        return blob["autoencoder"]
    if "state_dict" not in blob:
        return blob                    # a bare state_dict
    saved = dict(blob.get("config", {}))
    saved.setdefault("model_name", "danet")   # written before the zoo
    wrong = {k: (saved[k], getattr(cfg, k))
             for k in ("model_name",) + _SHAPE_FIELDS
             if k in saved and saved[k] != getattr(cfg, k)}
    if wrong:
        raise ValueError(f"{path} was trained as another model or with "
                         f"other widths (saved, asked): {wrong}")
    return blob["state_dict"]
