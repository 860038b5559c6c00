"""Weights and state from the JAX package's layouts into the port's.

Every function takes plain numpy data (nested dicts of arrays, as
`jax.tree.map(np.asarray, ...)` gives) and imports nothing of JAX:
  danet_from_flax       DANet flax variables -> DANet state_dict
  zoo_from_flax         any zoo module's flax variables -> its state_dict
  policy_from_flax      one stacked policy bank (LSTM, transformer or no
                        memory) -> PolicyBank state_dict
  policy_to_flax        its inverse, as numpy in the JAX bank's layout
  env_state_from_numpy  a JaxEnvState's fields -> EnvState
  route_bank_from_numpy a RouteBank's fields -> RouteBank
Layouts: conv HWIO -> OIHW, ConvTranspose HWIO -> torch's [I, O, kh, kw]
by transpose(2, 3, 0, 1) with no flip (the JAX `conv_transpose_torch`
flips at apply time; `checkpoint._convT_w` is the inverse), Dense
[in, out] -> Linear [out, in], BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var. Every flax Dense that reads a map
reads it `flatten_nchw`-ordered, as the port's flatten of an NCHW map is,
so none needs a permutation.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.envs.torch_env import EnvState, RouteBank
from cadre_tpu_torch.models.danet import BCBranch, DANetHead, VisualBranch
from cadre_tpu_torch.models.resnet import (
    RESNET_SPECS,
    Bottleneck,
    ResNetBackbone,
)

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(out: StateDict, key: str, p: Mapping[str, Any]) -> None:
    out[key + ".weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        out[key + ".bias"] = _t(p["bias"])


def _dense(out: StateDict, key: str, p: Mapping[str, Any]) -> None:
    out[key + ".weight"] = _t(np.transpose(p["kernel"]))
    out[key + ".bias"] = _t(p["bias"])


def _bn(out: StateDict, key: str, p: Mapping[str, Any],
        s: Mapping[str, Any]) -> None:
    out[key + ".weight"] = _t(p["scale"])
    out[key + ".bias"] = _t(p["bias"])
    out[key + ".running_mean"] = _t(s["mean"])
    out[key + ".running_var"] = _t(s["var"])
    out[key + ".num_batches_tracked"] = torch.tensor(0)


def _conv_transpose(out: StateDict, key: str, p: Mapping[str, Any]) -> None:
    out[key + ".weight"] = _t(np.transpose(p["kernel"], (2, 3, 0, 1)))
    out[key + ".bias"] = _t(p["bias"])


def _decoder(out: StateDict, key: str, p: Mapping[str, Any],
             s: Mapping[str, Any]) -> None:
    """A ReverseDecoder: up{i}_conv / up{i}_bn -> Sequential indices 3i and
    3i + 1, out_conv -> 12."""
    for i in range(4):
        _conv_transpose(out, f"{key}.{3 * i}", p[f"up{i}_conv"])
        _bn(out, f"{key}.{3 * i + 1}", p[f"up{i}_bn"], s[f"up{i}_bn"])
    _conv_transpose(out, f"{key}.12", p["out_conv"])


def _mlp(out: StateDict, key: str, p: Mapping[str, Any], names,
         indices) -> None:
    for name, i in zip(names, indices):
        _dense(out, f"{key}.{i}", p[name])


def _k(key: str, name: str) -> str:
    return f"{key}.{name}" if key else name


def _resnet(out: StateDict, key: str, p: Mapping[str, Any],
            s: Mapping[str, Any], arch: str) -> None:
    """A ResNetBackbone: flax layer{stage}_{b} / downsample_conv /
    downsample_bn -> torchvision's layer{stage}.{b} / downsample.0 / .1."""
    _conv(out, _k(key, "conv1"), p["conv1"])
    _bn(out, _k(key, "bn1"), p["bn1"], s["bn1"])
    block, depths = RESNET_SPECS[arch]
    convs = 3 if block is Bottleneck else 2
    for stage, blocks in enumerate(depths):
        for b in range(blocks):
            src, ss = p[f"layer{stage + 1}_{b}"], s[f"layer{stage + 1}_{b}"]
            dst = _k(key, f"layer{stage + 1}.{b}")
            for i in range(1, convs + 1):
                _conv(out, f"{dst}.conv{i}", src[f"conv{i}"])
                _bn(out, f"{dst}.bn{i}", src[f"bn{i}"], ss[f"bn{i}"])
            if "downsample_conv" in src:
                _conv(out, f"{dst}.downsample.0", src["downsample_conv"])
                _bn(out, f"{dst}.downsample.1", src["downsample_bn"],
                    ss["downsample_bn"])


def _da_head(out: StateDict, key: str, dh: Mapping[str, Any],
             dhs: Mapping[str, Any]) -> None:
    for name in ("conv5a", "conv5c", "conv51", "conv52"):
        _conv(out, _k(key, f"{name}.0"), dh[f"{name}_conv"])
        _bn(out, _k(key, f"{name}.1"), dh[f"{name}_bn"], dhs[f"{name}_bn"])
    for name in ("query_conv", "key_conv", "value_conv"):
        _conv(out, _k(key, f"sa.{name}"), dh["sa"][name])
    out[_k(key, "sa.gamma")] = _t(dh["sa"]["gamma"])
    out[_k(key, "sc.gamma")] = _t(dh["sc"]["gamma"])
    _conv(out, _k(key, "conv8.1"), dh["conv8_conv"])


def _visual_branch(out: StateDict, key: str, vb: Mapping[str, Any],
                   vbs: Mapping[str, Any]) -> None:
    _mlp(out, _k(key, "reverse_feature"), vb,
         ("reverse_feature_fc1", "reverse_feature_fc2"), (0, 2))
    for name, sub in vb.items():
        if name.startswith("reverse_") and "out_conv" in sub:
            _decoder(out, _k(key, name), sub, vbs[name])
    for head in ("reverse_lightState", "reverse_lightDist"):
        if f"{head}_fc1" in vb:
            _mlp(out, _k(key, head), vb,
                 tuple(f"{head}_fc{i}" for i in (1, 2, 3)), (1, 3, 5))


def _bc_branch(out: StateDict, key: str, p: Mapping[str, Any]) -> None:
    _mlp(out, _k(key, "bc_model"), p, ("fc1", "fc2"), (1, 3))


def danet_from_flax(variables: Mapping[str, Any],
                    cfg: DANetParams) -> StateDict:
    """Flax DANet variables {'params', 'batch_stats'} -> the state_dict of
    the port's DANet: every module the variables hold (those of
    `DANet.latent` alone give a `latent_only` DANet's)."""
    p, s = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    _resnet(out, "backbone", p["backbone"], s["backbone"], cfg.backbone)
    _da_head(out, "da_head", p["da_head"], s["da_head"])
    _conv(out, "visual_conv", p["visual_conv"])
    if "bc_conv" in p:
        _conv(out, "bc_conv", p["bc_conv"])
    for name, sub in p.get("inter_task_att", {}).items():
        key = f"inter_task_att.{name}"
        if name.endswith("_gamma"):                      # 'position'
            out[key] = _t(sub)
        elif "fc1" in sub:                 # 'transformer' / 'invaild' MLPs
            _mlp(out, key + "_layer", sub, ("fc1", "fc2"), (1, 3))
        else:                                            # 'position' conv
            _conv(out, key, sub)
    if "visual_branch" in p:
        _visual_branch(out, "visual_branch", p["visual_branch"],
                       s.get("visual_branch", {}))
    if "bc_branch" in p:
        _bc_branch(out, "bc_branch", p["bc_branch"])
    if "in_bc_speed_fc1" in p:
        _mlp(out, "in_bc_speed_fc", p, ("in_bc_speed_fc1",
                                        "in_bc_speed_fc2"), (1, 3))
    for name in ("visual_fc1", "visual_fc2"):
        if name in p:
            _dense(out, name, p[name])
    if "route_geom_branch" in p:
        for name in ("fc1", "fc2"):
            _dense(out, f"route_geom_branch.{name}",
                   p["route_geom_branch"][name])
    return out


def _zoo(out: StateDict, key: str, module: nn.Module, p: Mapping[str, Any],
         s: Mapping[str, Any]) -> None:
    """`module`'s weights from the flax variables of the module of the same
    name: a layer by its type, the DANet parts by their own rules, any
    other module child by child (a child with parameters must have its
    flax twin)."""
    if isinstance(module, ResNetBackbone):
        _resnet(out, key, p, s, module.arch)
    elif isinstance(module, DANetHead):
        _da_head(out, key, p, s)
    elif isinstance(module, VisualBranch):
        _visual_branch(out, key, p, s)
    elif isinstance(module, BCBranch):
        _bc_branch(out, key, p)
    elif isinstance(module, nn.ConvTranspose2d):
        _conv_transpose(out, key, p)
    elif isinstance(module, nn.Conv2d):
        _conv(out, key, p)
    elif isinstance(module, nn.Linear):
        _dense(out, key, p)
    elif isinstance(module, nn.modules.batchnorm._BatchNorm):
        _bn(out, key, p, s)
    else:
        for name, _ in module.named_parameters(recurse=False):
            out[_k(key, name)] = _t(p[name])
        for name, child in module.named_children():
            if name in p:
                _zoo(out, _k(key, name), child, p[name], s.get(name, {}))
            elif any(True for _ in child.parameters()):
                raise KeyError(f"no flax variables for {_k(key, name)}")


def zoo_from_flax(model: nn.Module,
                  variables: Mapping[str, Any]) -> StateDict:
    """Flax variables {'params'[, 'batch_stats']} of a zoo module (the
    VAEs, U-Nets, CIL and LBC nets, a ResNetBackbone) -> the state_dict of
    the port's `model` of the same configuration. Every module of the port
    takes its flax twin's name, except the DANet parts (ResNet, DANetHead,
    VisualBranch, BCBranch), which keep the reference's checkpoint names
    and convert as in `danet_from_flax`."""
    out: StateDict = {}
    _zoo(out, "", model, variables["params"],
         variables.get("batch_stats", {}))
    return out


def _transformer_from_flax(out: StateDict, p: Mapping[str, Any]) -> None:
    """A stacked flax TransformerMemory -> `lstm.*` of a BankedTransformer:
    Dense kernels [C, in, out] -> [C, out, in], DenseGeneral kernels
    [C, F, H, D] -> [C, H, D, F] and [C, H, D, F] -> [C, F, H, D],
    LayerNorm scale -> weight."""
    for name, sub in p.items():
        key = f"lstm.{name}"
        if name == "pos_embed":
            out[key] = _t(sub)
        elif name.startswith("ln"):
            out[key + ".weight"] = _t(sub["scale"])
            out[key + ".bias"] = _t(sub["bias"])
        elif name.startswith("attn_"):
            for proj in ("query", "key", "value"):
                out[f"{key}.{proj}.weight"] = _t(np.transpose(
                    sub[proj]["kernel"], (0, 2, 3, 1)))
                out[f"{key}.{proj}.bias"] = _t(sub[proj]["bias"])
            out[f"{key}.out.weight"] = _t(np.transpose(
                sub["out"]["kernel"], (0, 3, 1, 2)))
            out[f"{key}.out.bias"] = _t(sub["out"]["bias"])
        else:                                   # in_proj, mlp1_i, mlp2_i
            out[key + ".weight"] = _t(np.transpose(sub["kernel"], (0, 2, 1)))
            out[key + ".bias"] = _t(sub["bias"])


def policy_from_flax(bank: Mapping[str, Any]) -> StateDict:
    """One stacked flax policy bank (leading command axis) -> the
    state_dict of the port's PolicyBank. Its memory is what `bank` holds
    under 'lstm': the LSTM's 'rnn', the TransformerMemory's modules, or,
    with memory 'none', no 'lstm' key at all."""
    out: StateDict = {}
    mem = bank.get("lstm")
    if mem is not None and "rnn" in mem:
        for k, v in mem["rnn"].items():
            out[f"lstm.{k}"] = _t(v)
    elif mem is not None:
        _transformer_from_flax(out, mem)
    ac = bank["ac"]

    def banked(key, p):
        out[key + ".weight"] = _t(np.transpose(p["kernel"], (0, 2, 1)))
        out[key + ".bias"] = _t(p["bias"])

    for name in ("fc1", "fc2", "fc3"):
        banked(f"control.{name}", ac["control"][name])
    for name in ("critic_fc1", "critic_fc2", "critic_fc3"):
        banked(name, ac[name])
    return out


def _sorted(tree):
    """Dict keys in sorted order at every level, as flax lays them out."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def policy_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A PolicyBank state_dict (or any mapping of its names to tensors,
    e.g. Adam's moments) -> the stacked flax bank {'ac'[, 'lstm']} as
    float32 numpy, keys sorted as flax sorts them: the inverse of
    `policy_from_flax` for each memory."""
    def a(name):
        return np.array(state_dict[name].detach().cpu().float().numpy())

    def perm(name, axes):
        return np.ascontiguousarray(np.transpose(a(name), axes))

    def banked(key):
        return {"bias": a(key + ".bias"), "kernel": perm(key + ".weight",
                                                         (0, 2, 1))}

    ac = {"control": {name: banked(f"control.{name}")
                      for name in ("fc1", "fc2", "fc3")}}
    ac.update({name: banked(name)
               for name in ("critic_fc1", "critic_fc2", "critic_fc3")})
    out: Dict[str, Any] = {"ac": ac}
    if "lstm.weight_ih" in state_dict:
        out["lstm"] = {"rnn": {k: a(f"lstm.{k}") for k in
                               ("bias_hh", "bias_ih", "weight_hh",
                                "weight_ih")}}
    elif "lstm.pos_embed" in state_dict:
        mem: Dict[str, Any] = {"pos_embed": a("lstm.pos_embed")}
        for name in state_dict:
            parts = name.split(".")
            if parts[0] != "lstm" or len(parts) < 3:
                continue
            mod = parts[1]
            if mod.startswith("ln"):
                mem[mod] = {"bias": a(f"lstm.{mod}.bias"),
                            "scale": a(f"lstm.{mod}.weight")}
            elif mod.startswith("attn_"):
                key = f"lstm.{mod}"
                attn = {proj: {"bias": a(f"{key}.{proj}.bias"),
                               "kernel": perm(f"{key}.{proj}.weight",
                                              (0, 3, 1, 2))}
                        for proj in ("query", "key", "value")}
                attn["out"] = {"bias": a(f"{key}.out.bias"),
                               "kernel": perm(f"{key}.out.weight",
                                              (0, 2, 3, 1))}
                mem[mod] = attn
            else:
                mem[mod] = banked(f"lstm.{mod}")
        out["lstm"] = mem
    return _sorted(out)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def env_state_from_numpy(state: Mapping[str, Any], device="cpu") -> EnvState:
    """Fields of a batched JaxEnvState (as a dict, e.g. `_asdict()` after
    np.asarray) -> EnvState; fields the port does not keep are dropped."""
    return EnvState(**{k: _tensor(state[k], device)
                       for k in EnvState._fields})


def route_bank_from_numpy(bank: Mapping[str, Any], device="cpu") -> RouteBank:
    return RouteBank(**{k: _tensor(bank[k], device)
                        for k in RouteBank._fields})
