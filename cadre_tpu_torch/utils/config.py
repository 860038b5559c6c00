"""Python-file config engine (a copy of cadre_tpu.utils.config).

Replaces the reference's mmcv/ManiSkill-style `Config.fromfile`
(ppo_agent/meta/config.py:60+): executes a python config file, collects its
top-level names into an attribute-accessible dict, supports `_base_`
inheritance with `_delete_`, and merging CLI overrides.
"""
from __future__ import annotations

import copy
import importlib.util
import os
import types
from typing import Any, Dict


class ConfigDict(dict):
    """dict with attribute access (addict-style, read side only)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            v = ConfigDict(v)
            self[name] = v
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo)
                           for k, v in self.items()})


def _exec_pyfile(path: str) -> Dict[str, Any]:
    spec = importlib.util.spec_from_file_location(
        "cadre_cfg_" + os.path.basename(path).replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(
                v, (types.ModuleType, types.FunctionType, type))}


def _merge(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict) and v.pop("_delete_", False):
            out[k] = {kk: vv for kk, vv in v.items()}
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    @staticmethod
    def fromfile(path: str) -> ConfigDict:
        cfg = _exec_pyfile(path)
        bases = cfg.pop("_base_", None)
        if bases:
            if isinstance(bases, str):
                bases = [bases]
            merged: Dict[str, Any] = {}
            for b in bases:
                bpath = os.path.join(os.path.dirname(path), b)
                merged = _merge(merged, Config.fromfile(bpath))
            cfg = _merge(merged, cfg)
        return ConfigDict(cfg)

    @staticmethod
    def merge_args(cfg: ConfigDict, overrides: Dict[str, Any]) -> ConfigDict:
        """Dotted-key CLI overrides: {'train_cfg.lr': 1e-4}."""
        for key, val in overrides.items():
            parts = key.split(".")
            node: Any = cfg
            for p in parts[:-1]:
                node = node.setdefault(p, ConfigDict()) if isinstance(
                    node, dict) else getattr(node, p)
            node[parts[-1]] = val
        return cfg
