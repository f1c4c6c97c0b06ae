"""The port stands alone: its configuration and metrics equal the JAX
package's, and nothing in it imports the JAX package or JAX."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import lidar_slam_tpu.config as jcfg
import lidar_slam_tpu.utils.metrics as jmetrics
import lidar_slam_tpu_torch
import lidar_slam_tpu_torch.config as tcfg
import lidar_slam_tpu_torch.utils.metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(lidar_slam_tpu_torch.__file__)

_PRESETS = ("DEFAULT_CONFIG", "BUILDING_CONFIG", "BUILDING_WIDE_CONFIG")
_CLASSES = ("LidarConfig", "GridConfig", "MatcherConfig", "MapConfig",
            "ParticleConfig", "SubmapConfig", "SlamConfig")


@pytest.mark.parametrize("name", _PRESETS + _CLASSES)
def test_config_equals_jax_package(name):
    """Every preset and every default-constructed dataclass, field for
    field; the port's are its own classes, not the JAX package's."""
    theirs, ours = getattr(jcfg, name), getattr(tcfg, name)
    if name in _CLASSES:
        assert ours is not theirs
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)]
        theirs, ours = theirs(), ours()
    assert type(ours).__module__ == "lidar_slam_tpu_torch.config"
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_config_json_round_trip():
    cfg = tcfg.BUILDING_WIDE_CONFIG
    assert tcfg.SlamConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_json() == jcfg.BUILDING_WIDE_CONFIG.to_json()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax_package(seed):
    rng = np.random.default_rng(seed)
    est = rng.normal(size=(120, 3)).astype(np.float32)
    ref = est + rng.normal(scale=0.1, size=est.shape).astype(np.float32)
    for align in (False, True):
        assert tmetrics.ate(est, ref, align=align) == \
            jmetrics.ate(est, ref, align=align)
    for delta in (1, 10):
        assert tmetrics.rpe(est, ref, delta) == jmetrics.rpe(est, ref, delta)
    assert tmetrics.max_abs_err(est, ref) == jmetrics.max_abs_err(est, ref)


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "lidar_slam_tpu")


def test_no_import_of_jax_package_in_sources():
    """An AST scan of every module of the port and of chip_smoke.py: no
    ``import lidar_slam_tpu``, ``from lidar_slam_tpu.``, or ``jax``."""
    found = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if _forbidden(n)]
    assert len(_port_sources()) > 20
    names = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"models/ba.py", "io/server.py", "utils/checkpoint.py",
            "utils/watchdog.py", "utils/debug.py", "utils/tree.py",
            "parallel/mesh.py", "parallel/multihost.py",
            "parallel/resampling.py", "parallel/sharded.py",
            "parallel/sharded_edt.py", "parallel/sharded_ekf.py",
            "parallel/sharded_ba.py", "parallel/dryrun.py"} <= names
    assert found == []


_IMPORT_ALL = """
import importlib, json, os, pkgutil, sys
before = set(sys.modules)
import lidar_slam_tpu_torch
names = ["lidar_slam_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(lidar_slam_tpu_torch.__path__,
                                          "lidar_slam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, os.getcwd())
import chip_smoke
print(json.dumps({"imported": names,
                  "new": sorted(set(sys.modules) - before)}))
"""


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for mod in ("ops.cuda_match", "utils.viz", "models.ba", "io.server",
                "utils.checkpoint", "utils.watchdog", "utils.debug",
                "utils.profiling", "utils.tree", "parallel.mesh",
                "parallel.multihost", "parallel.resampling",
                "parallel.sharded", "parallel.sharded_edt",
                "parallel.sharded_ekf", "parallel.sharded_ba",
                "parallel.dryrun"):
        assert f"lidar_slam_tpu_torch.{mod}" in got["imported"], mod
    assert [m for m in got["new"] if _forbidden(m)] == []
