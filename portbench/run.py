"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It builds the cell's program from the benchmark's own weights and inputs
(made from --seed), warms it up, measures it for --seconds, then checks
what the timed path produced against the plain reference, and prints one
JSON line last: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and `checks` (each number that
decided `correct` beside its limit). It runs on the machine it is started
on and needs the cell's number of CUDA devices; it imports neither JAX nor
the JAX package."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "cadre_tpu")


def fixed_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot, compared whole)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a generator is handed: the cell's files, its seed and
    device."""

    def __init__(self, cell, config, traffic, seed, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, device
        self.sizes = config["sizes"]

    def check_sizes(self, program_cfg) -> None:
        """The program's configuration holds the file's sizes."""
        for k, v in self.sizes.items():
            if hasattr(program_cfg, k) and getattr(program_cfg, k) != v:
                raise ValueError(f"{self.config['name']}: the program has "
                                 f"{k}={getattr(program_cfg, k)!r}, the "
                                 f"configuration file {v!r}")


def card(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(argv=None, device: str = "cuda", root: Path = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches(root)
    if not (root / "cadre_tpu_torch").is_dir():
        print(f"portbench: no cadre_tpu_torch beside {root / 'portbench'}; "
              f"the benchmark measures the checkout's program",
              file=sys.stderr)
        return 2
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.core import spec
    from portbench.core.trace import Tracer

    import torch

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.cuda.reset_peak_memory_stats()
    pb = root / "portbench"
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], pb)
    limits = spec.limits(cell["name"], pb)
    metrics = spec.cell_metrics(bench, cell["name"])
    ctx = Context(cell, config, traffic, args.seed, device)
    drv = spec.generator(traffic["generator"], pb).Run(ctx)

    parts: dict = {}
    drv.setup(parts)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    setup_s = time.perf_counter() - T_START
    print("setup parts (s): " + json.dumps(
        {k: round(v, 3) for k, v in parts.items()}), file=sys.stderr)
    tracer = Tracer(args.trace == 1, root / "build" / "portbench" / "trace")
    e2e = drv.window(args.seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    observed = drv.observations(tracer)
    drv.release()
    checks = drv.check()
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; the benchmark may "
              f"load neither JAX nor the JAX package", file=sys.stderr)
        return 3

    out_metrics = {}
    if args.trace == 0:
        values = dict(e2e, setup_s=setup_s)
        for m in metrics["end_to_end"]:
            out_metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in metrics["per_layer"]:
            reader = spec.metric_reader(m["name"], pb)
            value = None if reader is None else reader.read(observed)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card(cell["chips"]) if device == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = peak
    result = {"correct": None, "attempted": e2e["_attempted"], "failed": 0,
              "metrics": out_metrics, "device": dev}
    if tracer.summary is not None:
        s = tracer.summary
        dev["busy_s"], dev["window_s"] = s.busy_s(), s.window_s()
        result["breakdown"] = drv.breakdown(s) if hasattr(drv, "breakdown") \
            else {"device_ops": s.top_device_ops([]),
                  "idle_gaps": s.idle_gaps()}
    verdicts = {}
    correct = True
    for name, limit in limits.items():
        value = checks[name]
        ok = limit is not None and value == value and value <= limit
        correct = correct and ok
        verdicts[name] = {"value": value, "limit": limit}
    for name in checks.keys() - limits.keys():
        print(f"read, not compared: {name} {checks[name]!r}",
              file=sys.stderr)
    result["correct"] = correct
    result["failed"] = 0 if correct else 1
    print(f"card: {power_limit()}; precision flags as found: cudnn "
          f"allow_tf32={flags[0]}, matmul allow_tf32={flags[1]}, matmul "
          f"precision {flags[2]}; setup_s {setup_s:.3f}; window "
          f"{e2e['_window_s']:.3f} s", file=sys.stderr)
    for name, v in verdicts.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result["checks"] = verdicts
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
