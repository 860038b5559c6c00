"""Nothing the benchmark imports is JAX or the JAX package: top-level
module names compared whole (`cadre_tpu_torch` begins with `cadre_tpu`)."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN, forbidden_modules

PB = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_top_level_names_are_compared_whole():
    mods = {"cadre_tpu_torch": 1, "cadre_tpu_torch.rl.agent": 1,
            "jaxtyping": 1, "portbench": 1}
    assert forbidden_modules(mods) == []
    assert forbidden_modules(dict(mods, **{"cadre_tpu.rl": 1})) == \
        ["cadre_tpu"]
    assert forbidden_modules({"jax._src": 1, "flax": 1}) == ["flax", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.run, portbench.control; "
            "from portbench.core import spec; "
            "[spec.generator(d) for d in ('ppo_iteration', 'pretrain_step')]; "
            "import cadre_tpu_torch.rl.device_rollout, "
            "cadre_tpu_torch.perception.trainer; "
            "print(portbench.run.forbidden_modules())") % str(PB.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
