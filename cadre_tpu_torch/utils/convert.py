"""Weights and state from the JAX package's layouts into the port's.

Every function takes plain numpy data (nested dicts of arrays, as
`jax.tree.map(np.asarray, ...)` gives) and imports nothing of JAX:
  danet_from_flax       DANet flax variables -> DANet state_dict
  policy_from_flax      one stacked policy bank -> PolicyBank state_dict
  env_state_from_numpy  a JaxEnvState's fields -> EnvState
  route_bank_from_numpy a RouteBank's fields -> RouteBank
Layouts: conv HWIO -> OIHW, Dense [in, out] -> Linear [out, in], BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. The flax
InterTaskAtt flattens NCHW-first (`flatten_nchw`), as the port's
`nn.Flatten` on NCHW does, so its fc1 needs no permutation.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.envs.torch_env import EnvState, RouteBank
from cadre_tpu_torch.models.resnet import RESNET_SPECS

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


def danet_from_flax(variables: Mapping[str, Any],
                    cfg: DANetParams) -> StateDict:
    """Flax DANet variables {'params', 'batch_stats'} -> the state_dict of
    the port's DANet (latent path; decoder heads are skipped)."""
    p, s = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    bb, bbs = p["backbone"], s["backbone"]
    _conv(out, "backbone.conv1", bb["conv1"])
    _bn(out, "backbone.bn1", bb["bn1"], bbs["bn1"])
    for stage, blocks in enumerate(RESNET_SPECS[cfg.backbone]):
        for b in range(blocks):
            src, ss = bb[f"layer{stage + 1}_{b}"], bbs[f"layer{stage + 1}_{b}"]
            dst = f"backbone.layer{stage + 1}.{b}"
            for i in (1, 2):
                _conv(out, f"{dst}.conv{i}", src[f"conv{i}"])
                _bn(out, f"{dst}.bn{i}", src[f"bn{i}"], ss[f"bn{i}"])
            if "downsample_conv" in src:
                _conv(out, f"{dst}.downsample.0", src["downsample_conv"])
                _bn(out, f"{dst}.downsample.1", src["downsample_bn"],
                    ss["downsample_bn"])
    dh, dhs = p["da_head"], s["da_head"]
    for name in ("conv5a", "conv5c", "conv51", "conv52"):
        _conv(out, f"da_head.{name}.0", dh[f"{name}_conv"])
        _bn(out, f"da_head.{name}.1", dh[f"{name}_bn"], dhs[f"{name}_bn"])
    for name in ("query_conv", "key_conv", "value_conv"):
        _conv(out, f"da_head.sa.{name}", dh["sa"][name])
    out["da_head.sa.gamma"] = _t(dh["sa"]["gamma"])
    out["da_head.sc.gamma"] = _t(dh["sc"]["gamma"])
    _conv(out, "da_head.conv8.1", dh["conv8_conv"])
    _conv(out, "visual_conv", p["visual_conv"])
    _conv(out, "bc_conv", p["bc_conv"])
    for name, mlp in p["inter_task_att"].items():
        _dense(out, f"inter_task_att.{name}_layer.1", mlp["fc1"])
        _dense(out, f"inter_task_att.{name}_layer.3", mlp["fc2"])
    return out


def policy_from_flax(bank: Mapping[str, Any]) -> StateDict:
    """One stacked flax policy bank {'ac', 'lstm'} (leading command axis)
    -> the state_dict of the port's PolicyBank."""
    out: StateDict = {}
    for k, v in bank["lstm"]["rnn"].items():
        out[f"lstm.{k}"] = _t(v)
    ac = bank["ac"]

    def banked(key, p):
        out[key + ".weight"] = _t(np.transpose(p["kernel"], (0, 2, 1)))
        out[key + ".bias"] = _t(p["bias"])

    for name in ("fc1", "fc2", "fc3"):
        banked(f"control.{name}", ac["control"][name])
    for name in ("critic_fc1", "critic_fc2", "critic_fc3"):
        banked(name, ac[name])
    return out


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
