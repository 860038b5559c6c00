"""Readings for the limits of `correct`: for each seed, the cell's set-up
(which runs the first steps the check follows), then the numbers of the
program against the reference and of the control (the reference a
precision step lower, in the program's place) against the reference.
No measured window: training readings need none.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...

One JSON line per seed and side on standard output."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, device: str = "cuda", root: Path = ROOT,
             control: int = 10 ** 9, out=sys.stdout, fault: str = "none"):
    """`control`: how many of the seeds, the first, also read the
    control; `fault` (portbench/faults.py) is planted in the program."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.core import spec
    from portbench.faults import planted
    from portbench.run import Context, fixed_caches

    import torch

    fixed_caches(root)
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    config = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root / "portbench")
    rows = []
    for i, seed in enumerate(seeds):
        ctx = Context(cell, config, traffic, seed, device)
        drv = spec.generator(traffic["generator"], root / "portbench").Run(ctx)
        with planted(fault, traffic["generator"]):
            drv.setup({})
        if hasattr(drv, "stop_feed"):
            drv.stop_feed()
        drv.release()
        side = "program" if fault == "none" else f"fault_{fault}"
        sides = {side: drv.check()}
        if i < control:
            sides["control"] = drv.check(control=True)
        for side, numbers in sides.items():
            row = dict(workload=workload, seed=seed, side=side, **numbers)
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
        del drv
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="read the control on the first this many seeds")
    p.add_argument("--fault", default="none",
                   help="plant a fault of portbench/faults.py")
    a = p.parse_args()
    readings(a.workload, a.seeds, control=a.control, fault=a.fault)
