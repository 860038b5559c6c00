"""Config.fromfile python configs -> the port's typed dataclass configs
(the counterpart of cadre_tpu.configs.loader): each dataclass takes the
keys of its config dict that it has a field for."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from cadre_tpu_torch.configs.agent_config import (
    AgentConfig,
    EvalConfig,
    RolloutConfig,
    TrainConfig,
)
from cadre_tpu_torch.utils.config import Config


def _fill(dc_cls, src: Dict[str, Any]):
    """A dataclass from the keys of `src` it has a field for."""
    names = {f.name for f in dataclasses.fields(dc_cls)}
    return dc_cls(**{k: v for k, v in src.items() if k in names})


def load_experiment(path: str) -> Dict[str, Any]:
    """A config_files/*.py experiment as typed configs:
    {'rollout': RolloutConfig, 'agent': AgentConfig, 'train':
    TrainConfig, 'env': dict, 'eval': EvalConfig or None, 'raw':
    ConfigDict}. The agent's use_lstm, command_num, measurement_dim,
    vae_params and ordinal come from agent_cfg.model_cfg, its frame and
    PPO coefficients from agent_cfg itself, as the JAX loader reads them
    (`memory` is not read: the reference's configs have no such key);
    train_cfg.num_processes defaults to env_cfg.num_processes; eval_cfg's
    `load_episode` list is the EvalConfig's `load_episodes`."""
    cfg = Config.fromfile(path)
    agent_src = dict(cfg.get("agent_cfg", {}))
    model_cfg = dict(agent_src.get("model_cfg", {}))
    agent = AgentConfig(
        use_lstm=model_cfg.get("use_lstm", True),
        command_num=model_cfg.get("command_num", 4),
        measurement_dim=model_cfg.get("measurement_dim", 18),
        frame=agent_src.get("frame", 8),
        ent_coeff=agent_src.get("ent_coeff", 0.01),
        value_coeff=agent_src.get("value_coeff", 0.1),
        clip_coeff=agent_src.get("clip_coeff", 1.0),
        clip=agent_src.get("clip", 0.1),
        vae_params=model_cfg.get("vae_params", "CoPM"),
        ordinal=model_cfg.get("ordinal", False))
    train_src = dict(cfg.get("train_cfg", {}))
    env = dict(cfg.get("env_cfg", {}))
    if "num_processes" in env:
        train_src.setdefault("num_processes", env["num_processes"])
    eval_cfg = None
    if "eval_cfg" in cfg:
        src = dict(cfg.eval_cfg)
        if "load_episode" in src:
            src["load_episodes"] = tuple(src.pop("load_episode"))
        eval_cfg = _fill(EvalConfig, src)
    return {"rollout": _fill(RolloutConfig, dict(cfg.get("rollout_cfg", {}))),
            "agent": agent,
            "train": _fill(TrainConfig, train_src), "env": env,
            "eval": eval_cfg, "raw": cfg}
