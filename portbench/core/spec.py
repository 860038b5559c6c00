"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root
names the cell, its configuration file and its traffic mix; the mix names
its generator (`generators/<generator>.py`); `limits/<cell>.json` holds the limits
of the numbers that decide `correct`; each per-layer metric is read by
`metrics/<metric name>.py`. Nothing here names a cell, a mix or a metric:
a later change adds files and BENCHMARK.json entries, and edits none."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "config")
    with open(root / entry["file"]) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str, pb: Path = PB) -> dict:
    return _json(pb / "traffic" / f"{name}.json")


def limits(cell_name: str, pb: Path = PB) -> dict:
    return _json(pb / "limits" / f"{cell_name}.json")


def _load(path: Path, prefix: str) -> ModuleType:
    name = prefix + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def generator(name: str, pb: Path = PB) -> ModuleType:
    """`generators/<name>.py`: the general generator of one kind of
    traffic."""
    return _load(pb / "generators" / f"{name}.py", "portbench_generator_")


def metric_reader(name: str, pb: Path = PB) -> Optional[ModuleType]:
    path = pb / "metrics" / f"{name}.py"
    return _load(path, "portbench_metric_") if path.exists() else None


def cell_metrics(bench: dict, cell_name: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metric entries this cell reports: a
    metric with `workloads` where it lists the cell; one without, where
    the cell reports every end-to-end metric it names (per-layer: the one
    it `moves`)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell_name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per_layer}
