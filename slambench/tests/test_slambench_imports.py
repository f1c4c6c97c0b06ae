"""Nothing the benchmark loads imports JAX or the JAX package: no module
under ``slambench/`` names them, and a process that imports every module of
the benchmark and the program entries it drives has none of them loaded.
Top-level module names are compared whole: ``lidar_slam_tpu_torch`` is not
``lidar_slam_tpu``."""

import ast
import pathlib
import subprocess
import sys

from slambench import harness

BENCH = pathlib.Path(harness.BENCH_DIR)


def _imported_tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_names_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imported_tops(f) & set(harness.FORBIDDEN_MODULES)
        assert not bad, (f, bad)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lidar_slam_tpu_torch_x", sys)
    assert "lidar_slam_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()


def test_a_run_process_loads_no_jax():
    code = """
import pathlib, sys
sys.path.insert(0, {root!r})
from slambench import control, harness, roofline, run, trace
from slambench.frozen import server, simulate
from slambench.reference import fidelity, graph
for kind in ("kinds", "systems", "metrics"):
    for f in sorted(pathlib.Path({bench!r}, kind).glob("*.py")):
        if f.stem != "__init__":
            harness._module(kind, f.stem)
from lidar_slam_tpu_torch.io import server as s
from lidar_slam_tpu_torch.models import graph_slam, scan_matcher
print(harness.forbidden_loaded())
""".format(root=harness.ROOT, bench=str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
