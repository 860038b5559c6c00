"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark
(small widths, a few envs and frames) that runs on the CPU with the
port's plain kernel versions, and the `card` marker for tests that need
an NVIDIA GPU (decided inside the fixture, never at import)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = {"da_feature_channel": 64, "inter_att_dims": 48, "z_dims": 32}
# A pretraining cell added as a later change would add it: an entry and
# its metrics in BENCHMARK.json and a limits file; BENCHMARK.json has no
# pretraining cell yet (PERF.md, Open questions).
PRETRAIN = "pretrain.r18"
PRETRAIN_LIMITS = {"output": 0.026, "loss": 0.0022, "grad": 0.56,
                   "change": 0.42}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def add_pretrain_cell(root: Path) -> None:
    """The pretraining cell `PRETRAIN` (copm_r18_144x256 under
    pretrain_b48) in the checkout's BENCHMARK.json, with its metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": PRETRAIN, "config": "copm_r18_144x256",
        "traffic": "pretrain_b48", "chips": 1, "why": "a test"})
    bench["end_to_end"] += [
        {"name": "pretrain_frames_per_s", "unit": "frames/s",
         "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": [PRETRAIN]},
        {"name": "pretrain_step_ms_p95", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "device_trace", "workloads": [PRETRAIN]}]
    for name, unit, better in (
            ("pretrain_ops_per_step", "ops", "lower"),
            ("k2_roofline_pct.pretrain", "%", "higher"),
            ("k3_roofline_pct.pretrain", "%", "higher"),
            ("pretrain_mfu", "%", "higher"),
            ("pretrain_idle_pct", "%", "lower")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": better,
            "source": "device_trace", "layer": "train step",
            "moves": "pretrain_frames_per_s", "workloads": [PRETRAIN]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "limits" / f"{PRETRAIN}.json").write_text(
        json.dumps(PRETRAIN_LIMITS))


def make_small(root: Path) -> Path:
    """A checkout-like directory: the benchmark at tiny sizes, with the
    pretraining cell added, and the port beside it (a link)."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "cadre_tpu_torch").symlink_to(REPO / "cadre_tpu_torch")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    pb = root / "portbench"
    for p in (pb / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["danet"].update(SMALL)
        cfg["sizes"].update(SMALL)
        p.write_text(json.dumps(cfg))
    for name, small in (("ppo_n2048_t25", dict(num_envs=4, num_steps=3,
                                               check_envs=2, check_chunk=4)),
                        ("pretrain_b48", dict(batch_size=2, pool_batches=3,
                                              train={"batch_size": 2},
                                              trace_after=1,
                                              trace_steps=1))):
        p = pb / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(small)
        p.write_text(json.dumps(t))
    # a tiny minibatch (6 rows) sums its step-1 loss over few terms: the
    # CPU's f32 reads up to 3e-5 there, against the cells' 1e-6 and 2.8e-6
    # at 25,600 rows on the card; every other limit is the cell's own
    for p in (pb / "limits").glob("ppo.*.json"):
        lim = json.loads(p.read_text())
        lim["loss"] = 1e-4
        p.write_text(json.dumps(lim))
    add_pretrain_cell(root)
    return root


@pytest.fixture
def small(tmp_path) -> Path:
    return make_small(tmp_path / "checkout")


def run_small(root: Path, cell: str, seed: int = 2147483999,
              trace: int = 0, seconds: float = 0.5, capsys=None) -> dict:
    """One CPU run of a tiny cell; returns its result line."""
    from portbench.run import run

    rc = run(["--workload", cell, "--seed", str(seed), "--seconds",
              str(seconds), "--trace", str(trace)], device="cpu", root=root)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
