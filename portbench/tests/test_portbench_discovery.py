"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and BENCHMARK.json entries, and edits no
file: the harness finds each by its name."""
import json

from conftest import PRETRAIN, run_small

from portbench.core import spec


def test_added_files_are_found_by_name(small, capsys):
    pb = small / "portbench"
    cfg = json.loads((pb / "configs/copm_r18_144x256.json").read_text())
    cfg["name"] = "copm_r18_wide_pool"
    (pb / "configs/copm_r18_wide_pool.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic/pretrain_b48.json").read_text())
    mix["pool_batches"] = 4
    (pb / "traffic/pretrain_pool4.json").write_text(json.dumps(mix))
    (pb / "limits/pretrain.extra.json").write_text(
        (pb / f"limits/{PRETRAIN}.json").read_text())
    (pb / "metrics/extra_steps_seen.py").write_text(
        "def read(obs):\n"
        "    ms = obs.get('step_ms')\n"
        "    return None if not ms else float(len(ms))\n")
    bench = json.loads((small / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "copm_r18_wide_pool", "source": "https://example.org",
        "file": "portbench/configs/copm_r18_wide_pool.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "pretrain.extra", "config": "copm_r18_wide_pool",
        "traffic": "pretrain_pool4", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and PRETRAIN in m["workloads"]:
            m["workloads"].append("pretrain.extra")
    bench["per_layer"].append({
        "name": "extra_steps_seen", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "train step",
        "moves": "pretrain_frames_per_s", "workloads": ["pretrain.extra"]})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.load_benchmark(small)
    got = spec.cell_metrics(b, "pretrain.extra")
    assert {m["name"] for m in got["end_to_end"]} == {
        "pretrain_frames_per_s", "pretrain_step_ms_p95", "setup_s"}
    assert "extra_steps_seen" in {m["name"] for m in got["per_layer"]}
    assert spec.traffic("pretrain_pool4", pb)["pool_batches"] == 4
    line = run_small(small, "pretrain.extra", trace=1, capsys=capsys)
    assert line["metrics"]["extra_steps_seen"]["value"] >= 1
    assert line["correct"] is True
    # the cells that were there see nothing of the new metric
    assert "extra_steps_seen" not in {
        m["name"] for m in spec.cell_metrics(b, PRETRAIN)["per_layer"]}


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory with BENCHMARK.json and portbench/ only: no result, a
    non-zero exit."""
    import shutil
    import subprocess
    import sys

    from conftest import REPO

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, %r); from pathlib import Path; "
            "from portbench.run import run; sys.exit(run(['--workload', "
            "'ppo.r18.n2048', '--seed', '5', '--seconds', '1'], "
            "device='cpu', root=Path(%r)))") % (str(tmp_path), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
