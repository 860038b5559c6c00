"""Encoder checkpoints: the port's `torch.save` files and the reference's.

A port checkpoint (`PerceptionTrainer.save`, `net_epoch<N>.pt`) holds
{"state_dict": the DANet state_dict, "config": the DANetParams fields}.
A reference-format checkpoint holds the state_dict under "autoencoder"
(cadre_tpu.utils.checkpoint.load_danet_pt reads the same key); the port's
module names are the reference's, so either loads with load_state_dict.
The JAX package's flax `.msgpack` snapshots are not read yet (ROADMAP.md
queue A item 15): this machine's torch has no msgpack reader.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from cadre_tpu_torch.configs.danet_config import DANetParams

StateDict = Dict[str, torch.Tensor]
# fields that decide the shape of some weight
_SHAPE_FIELDS = ("backbone", "input_channel", "da_feature_channel",
                 "inter_att_dims", "z_dims", "att_type")


def save_danet_checkpoint(path: str, state_dict: StateDict,
                          cfg: DANetParams) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": state_dict, "config": dataclasses.asdict(cfg)},
               path)


def load_danet_checkpoint(path: str, cfg: DANetParams) -> StateDict:
    """The DANet state_dict (CPU tensors) in a port or reference-format
    checkpoint at `path`. Raises on a JAX `.msgpack` snapshot, and on a
    port checkpoint made for another width than `cfg`."""
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
    saved = blob.get("config", {})
    wrong = {k: (saved[k], getattr(cfg, k)) for k in _SHAPE_FIELDS
             if k in saved and saved[k] != getattr(cfg, k)}
    if wrong:
        raise ValueError(f"{path} was trained with other widths "
                         f"(saved, asked): {wrong}")
    return blob["state_dict"]
