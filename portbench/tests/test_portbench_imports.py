"""Nothing the benchmark imports has ``jax``, ``jaxlib``, ``flax`` or the
JAX package (``svdfeature_tpu``) as its whole top-level name, and the
references import nothing of the port."""

import ast
import pathlib
import subprocess
import sys

from portbench.harness import guard, spec

PB = spec.ROOT / "portbench"

PROBE = """
import sys, time
sys.path.insert(0, {root!r})
from portbench.harness import cell, guard
from portbench.tests import tiny
from portbench import control
cell.run(tiny.kdd(), 3, 0.02, True, time.perf_counter(), device_name="cpu")
for name in ("device_idle_pct", "train_mfu_pct", "trainer_host_ms_per_round", "warm_round_s",
             "k5_roofline_pct", "k2_roofline_pct"):
    __import__("portbench.metrics." + name)
found = guard.forbidden_modules()
print("FOUND", found)
assert "svdfeature_tpu_torch" in sys.modules
sys.exit(1 if found else 0)
"""


def test_a_run_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", PROBE.format(root=str(spec.ROOT))],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_forbidden_module():
    for path in PB.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in guard.FORBIDDEN, (path, name)


def test_references_import_nothing_of_the_port():
    for path in (PB / "reference").glob("*.py"):
        for name in _imports(path):
            assert not name.startswith("svdfeature_tpu"), (path, name)


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "svdfeature_tpu_torch_fake", object())
    assert "svdfeature_tpu_torch_fake" not in guard.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in guard.forbidden_modules()
