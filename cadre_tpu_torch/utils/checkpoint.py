"""Checkpoints: the port's `torch.save` files, the reference's `.pt`
files and the JAX package's flax `.msgpack` files.

A port checkpoint (`PerceptionTrainer.save`, `net_epoch<N>.pt`;
`CILTrainer`'s `cil_epoch<N>.pt`) holds {"state_dict": the model's
state_dict, "config": its DANetParams fields, or the CIL net's settings},
and the config names the model (`model_name`: "danet", a zoo name, or
"cilrs" / "carla"; a checkpoint without one is a DANet's). A checkpoint
is refused by a model of another name or other widths.
A reference-format checkpoint holds the state_dict under "autoencoder"
(cadre_tpu.utils.checkpoint.load_danet_pt reads the same key); the port's
module names are the reference's, so either loads with load_state_dict.
A `.msgpack` file is the JAX package's (`save_pytree` / `load_pytree`,
flax's format through the pure-Python `utils/msgpack.py`): a perception
checkpoint holds the DANet's {'params', 'batch_stats'}, which
`utils.convert.danet_from_flax` turns into the port's state_dict.

The rest of the JAX module, on numpy trees in flax's layout:
  import_danet_torch   a reference- or port-format DANet state_dict ->
                       the flax variable tree (the inverse of
                       danet_from_flax);
  import_policy_torch  a reference policy snapshot
                       ('{steer,throttle}_{ppo,lstm}_{k}' state_dicts) ->
                       stacked flax command banks, and the banks missing
                       from it;
  load_danet_pt, load_policy_pt  the same from files. A `.pt` file is
                       read with weights_only=True: a file of pickled
                       reference modules is refused, since unpickling it
                       needs the reference's classes.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.models.resnet import RESNET_SPECS, Bottleneck
from cadre_tpu_torch.utils import msgpack

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
    """The state_dict (CPU tensors) in a port, reference-format or JAX
    `.msgpack` checkpoint at `path` for the model `cfg.model_name`
    describes. Raises on a port checkpoint of another model or made for
    another width than `cfg`."""
    if path.endswith(".msgpack"):
        from cadre_tpu_torch.utils.convert import danet_from_flax

        tree = load_pytree(path)
        return danet_from_flax({"params": tree["params"],
                                "batch_stats": tree.get("batch_stats", {})},
                               cfg)
    blob = load_pt(path)
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


# ------------------------------------------------ flax .msgpack pytrees

def save_pytree(path: str, tree: Any) -> None:
    """`tree` (dicts, lists, tuples; numpy arrays, tensors, scalars) as
    `flax.serialization.to_bytes` writes it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        msgpack.dump(tree, f)


def load_pytree(path: str) -> Dict[str, Any]:
    """A flax `.msgpack` file as nested dicts of numpy arrays (bfloat16
    leaves as torch.bfloat16 tensors), read in one piece."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return msgpack.unpackb(buf)


def load_pt(path: str) -> Any:
    """A `.pt` file of tensors and containers (weights_only=True): a file
    of pickled modules raises a ValueError saying so."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(
            f"{path} holds pickled modules, which only the reference's "
            "classes can unpickle; save their state_dicts instead") from exc


# ------------------------------------- torch state_dicts -> flax layout

def _t(x) -> np.ndarray:
    return np.array(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _conv_w(sd, key):
    """torch Conv2d weight [O, I, kh, kw] -> HWIO."""
    return _t(sd[key]).transpose(2, 3, 1, 0)


def _convT_w(sd, key):
    """torch ConvTranspose2d weight [I, O, kh, kw] -> HWIO (the JAX
    package flips it at apply time)."""
    return _t(sd[key]).transpose(2, 3, 0, 1)


def _dense(sd, key_w, key_b):
    """torch Linear weight [O, I] -> flax kernel [I, O]."""
    return {"kernel": _t(sd[key_w]).T, "bias": _t(sd[key_b])}


def _bn(sd, prefix) -> Tuple[dict, dict]:
    return ({"scale": _t(sd[prefix + ".weight"]),
             "bias": _t(sd[prefix + ".bias"])},
            {"mean": _t(sd[prefix + ".running_mean"]),
             "var": _t(sd[prefix + ".running_var"])})


def _conv_b(sd, key):
    return {"kernel": _conv_w(sd, key + ".weight"),
            "bias": _t(sd[key + ".bias"])}


def import_danet_torch(state_dict: Mapping[str, Any],
                       cfg: DANetParams) -> Dict[str, Any]:
    """A reference- or port-format DANet state_dict (the reference's
    carla_perception/Networks/danet.py module names) -> the JAX DANet's
    {'params', 'batch_stats'} as numpy: the JAX importer's modules (the
    backbone, the head, the task convs, InterTaskAtt's 'transformer'
    MLPs, the bc and in_bc_speed branches, the visual branch's feature
    MLP, image / route decoders and light-state MLP), the backbone's
    Bottleneck blocks included."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    bb_p: Dict[str, Any] = {"conv1": _conv_b(sd, "backbone.conv1")}
    bb_s: Dict[str, Any] = {}
    bb_p["bn1"], bb_s["bn1"] = _bn(sd, "backbone.bn1")
    block, depths = RESNET_SPECS[cfg.backbone]
    convs = 3 if block is Bottleneck else 2
    for stage, blocks in enumerate(depths):
        for b in range(blocks):
            tp = f"backbone.layer{stage + 1}.{b}"
            blk_p: Dict[str, Any] = {}
            blk_s: Dict[str, Any] = {}
            for i in range(1, convs + 1):
                blk_p[f"conv{i}"] = {"kernel": _conv_w(sd, f"{tp}.conv{i}"
                                                           ".weight")}
                blk_p[f"bn{i}"], blk_s[f"bn{i}"] = _bn(sd, f"{tp}.bn{i}")
            if tp + ".downsample.0.weight" in sd:
                blk_p["downsample_conv"] = {
                    "kernel": _conv_w(sd, tp + ".downsample.0.weight")}
                blk_p["downsample_bn"], blk_s["downsample_bn"] = _bn(
                    sd, tp + ".downsample.1")
            bb_p[f"layer{stage + 1}_{b}"] = blk_p
            bb_s[f"layer{stage + 1}_{b}"] = blk_s
    params["backbone"], stats["backbone"] = bb_p, bb_s

    dh_p: Dict[str, Any] = {}
    dh_s: Dict[str, Any] = {}
    for name in ("conv5a", "conv5c", "conv51", "conv52"):
        dh_p[name + "_conv"] = {"kernel": _conv_w(sd, f"da_head.{name}.0"
                                                      ".weight")}
        dh_p[name + "_bn"], dh_s[name + "_bn"] = _bn(sd, f"da_head.{name}.1")
    dh_p["sa"] = {name: _conv_b(sd, f"da_head.sa.{name}")
                  for name in ("query_conv", "key_conv", "value_conv")}
    dh_p["sa"]["gamma"] = _t(sd["da_head.sa.gamma"])
    dh_p["sc"] = {"gamma": _t(sd["da_head.sc.gamma"])}
    dh_p["conv8_conv"] = _conv_b(sd, "da_head.conv8.1")
    params["da_head"], stats["da_head"] = dh_p, dh_s

    params["visual_conv"] = _conv_b(sd, "visual_conv")
    if cfg.pred_bc:
        params["bc_conv"] = _conv_b(sd, "bc_conv")
        mlp = {}
        for name in ("visual_query", "visual_key", "visual_value",
                     "bc_query", "bc_key", "bc_value"):
            key = f"inter_task_att.{name}_layer"
            mlp[name] = {"fc1": _dense(sd, f"{key}.1.weight", f"{key}.1.bias"),
                         "fc2": _dense(sd, f"{key}.3.weight", f"{key}.3.bias")}
        params["inter_task_att"] = mlp
        params["bc_branch"] = {
            "fc1": _dense(sd, "bc_branch.bc_model.1.weight",
                          "bc_branch.bc_model.1.bias"),
            "fc2": _dense(sd, "bc_branch.bc_model.3.weight",
                          "bc_branch.bc_model.3.bias")}
        if cfg.in_bc_speed and "in_bc_speed_fc.1.weight" in sd:
            params["in_bc_speed_fc1"] = _dense(sd, "in_bc_speed_fc.1.weight",
                                               "in_bc_speed_fc.1.bias")
            params["in_bc_speed_fc2"] = _dense(sd, "in_bc_speed_fc.3.weight",
                                               "in_bc_speed_fc.3.bias")

    vb_p: Dict[str, Any] = {
        "reverse_feature_fc1": _dense(
            sd, "visual_branch.reverse_feature.0.weight",
            "visual_branch.reverse_feature.0.bias"),
        "reverse_feature_fc2": _dense(
            sd, "visual_branch.reverse_feature.2.weight",
            "visual_branch.reverse_feature.2.bias")}
    vb_s: Dict[str, Any] = {}

    def decoder(prefix):
        """Sequential stages 0, 3, 6, 9 (ConvTranspose2d) with BatchNorm at
        1, 4, 7, 10, and the output ConvTranspose2d at 12."""
        dec_p: Dict[str, Any] = {}
        dec_s: Dict[str, Any] = {}
        for i in range(4):
            dec_p[f"up{i}_conv"] = {
                "kernel": _convT_w(sd, f"{prefix}.{3 * i}.weight"),
                "bias": _t(sd[f"{prefix}.{3 * i}.bias"])}
            dec_p[f"up{i}_bn"], dec_s[f"up{i}_bn"] = _bn(
                sd, f"{prefix}.{3 * i + 1}")
        dec_p["out_conv"] = {"kernel": _convT_w(sd, f"{prefix}.12.weight"),
                             "bias": _t(sd[f"{prefix}.12.bias"])}
        return dec_p, dec_s

    if "visual_branch.reverse_image.0.weight" in sd:
        vb_p["reverse_image"], vb_s["reverse_image"] = decoder(
            "visual_branch.reverse_image")
    if cfg.pred_route and "visual_branch.reverse_route.0.weight" in sd:
        vb_p["reverse_route"], vb_s["reverse_route"] = decoder(
            "visual_branch.reverse_route")
    if cfg.pred_light_state and \
            "visual_branch.reverse_lightState.1.weight" in sd:
        for i, idx in enumerate((1, 3, 5), start=1):
            vb_p[f"reverse_lightState_fc{i}"] = _dense(
                sd, f"visual_branch.reverse_lightState.{idx}.weight",
                f"visual_branch.reverse_lightState.{idx}.bias")
    params["visual_branch"], stats["visual_branch"] = vb_p, vb_s
    return {"params": params, "batch_stats": stats}


def load_danet_pt(path: str, cfg: DANetParams,
                  key: str = "autoencoder") -> Dict[str, Any]:
    """A reference-format (or port) perception checkpoint -> the JAX
    DANet's variables, as import_danet_torch gives them."""
    blob = load_pt(path)
    if isinstance(blob, dict) and key in blob:
        blob = blob[key]
    elif isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return import_danet_torch(blob, cfg)


def _policy_banks(snapshot: Mapping[str, Any], signal: str, k: int):
    """The (actor-critic, LSTM) flax trees of `signal`'s command k in a
    reference snapshot, None for a bank it does not hold."""
    def sd(key):
        v = snapshot.get(key)
        return v.state_dict() if hasattr(v, "state_dict") else v

    ac, lstm = sd(f"{signal}_ppo_{k}"), sd(f"{signal}_lstm_{k}")
    if ac is not None:
        def layer(prefix, i):          # Sequential Linear at index 2i
            return _dense(ac, f"{prefix}.{2 * i}.weight",
                          f"{prefix}.{2 * i}.bias")

        ac = {"control": {f"fc{i + 1}": layer("control.linear", i)
                          for i in range(3)},
              **{f"critic_fc{i + 1}": layer("critic", i) for i in range(3)}}
    if lstm is not None:
        lstm = {"rnn": {name: _t(lstm[f"rnn.{name}"]) for name in
                        ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}}
    return ac, lstm


def _assign(dst: Dict[str, Any], src: Mapping[str, Any], k: int) -> None:
    for key, val in src.items():
        if isinstance(val, Mapping):
            _assign(dst[key], val, k)
        else:
            dst[key][k] = val


def import_policy_torch(snapshot: Mapping[str, Any], steer_params,
                        throttle_params, num_commands: int = 4
                        ) -> Tuple[Dict[str, Any], List[str]]:
    """A reference policy snapshot (ppo_agent/agent.py:245-260:
    '{steer,throttle}_{ppo,lstm}_{k}' modules or state_dicts) -> the
    stacked flax command banks {'steer', 'throttle'} as numpy, and the
    keys it lacks. A missing bank keeps its value in `steer_params` /
    `throttle_params` (flax-layout banks): the reference's own
    save_snapshot omits throttle_lstm and saves steer_ppo twice."""
    out = {"steer": msgpack.map_leaves(np.array, steer_params),
           "throttle": msgpack.map_leaves(np.array, throttle_params)}
    missing = []
    for signal in ("steer", "throttle"):
        for k in range(num_commands):
            ac, lstm = _policy_banks(snapshot, signal, k)
            for kind, tree, key in (("ac", ac, f"{signal}_ppo_{k}"),
                                    ("lstm", lstm, f"{signal}_lstm_{k}")):
                if tree is None:
                    missing.append(key)
                else:
                    _assign(out[signal][kind], tree, k)
    return out, missing


def load_policy_pt(path: str, steer_params, throttle_params,
                   num_commands: int = 4):
    """A reference ppo_model_<N>.pt snapshot of state_dicts ->
    import_policy_torch's (banks, missing keys)."""
    return import_policy_torch(load_pt(path), steer_params, throttle_params,
                               num_commands)
