"""Nothing a run loads is JAX or the JAX package, compared by whole top-level
names; the reference imports nothing of the port."""

import ast
import subprocess
import sys

from portbench import guard, spec

RUN_CPU = """
import sys, time, torch
sys.path[0] = {root!r}
from portbench import guard, harness
from portbench.tests.tiny import tiny_cell
for name in ('euler12-score', 'quat13-score', 'euler12-rollout', 'euler12-solve'):
    r = harness.run_cell(tiny_cell(name), 11, 0.1, False, torch.device('cpu'), time.perf_counter())
    assert r['correct'], name
print('LOADED', guard.forbidden_loaded())
print('PORT', 'bluerov2_dynamics_tpu_torch' in sys.modules)
"""


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["bluerov2_dynamics_tpu_torch", "bluerov2_dynamics_tpu_torch.ops",
                                   "jaxtyping", "flaxen.x", "numpy"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen",
                                   "bluerov2_dynamics_tpu.models"]) == [
        "bluerov2_dynamics_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax_and_no_jax_package():
    p = subprocess.run([sys.executable, "-c", RUN_CPU.format(root=str(spec.ROOT))],
                       capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "LOADED []" in p.stdout and "PORT True" in p.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    files = sorted((spec.HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".", 1)[0]
            assert top not in {"bluerov2_dynamics_tpu_torch"} | guard.FORBIDDEN, (f.name, mod)


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path[0] = {r!r}; import portbench.reference.tasks, "
            "portbench.reference.fossen; print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('bluerov2')))").format(r=str(spec.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stdout + p.stderr
