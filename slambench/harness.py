"""The benchmark's data-driven parts: ``BENCHMARK.json`` read and checked,
and each cell's configuration, traffic mix, traffic kind, system and
per-layer metric readers found by name.

- ``slambench/configs/<config>.json``: a deployment, with its ``system``;
- ``slambench/traffic/<traffic>.json``: a traffic mix, with its ``kind``;
- ``slambench/kinds/<kind>.py``: the generator of one kind of traffic;
- ``slambench/systems/<system>.py``: how the program runs a deployment,
  its plain reference and the comparison that decides ``correct``;
- ``slambench/metrics/<metric>.py``: one per-layer metric's reader.

A new cell, configuration, traffic mix, kind, system or metric is a new file
and a new entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lidar_slam_tpu")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names breaks the benchmark's rules."""


def _line(text, what: str) -> None:
    if (not isinstance(text, str) or not 1 <= len(text) <= 200
            or "\n" in text or "\t" in text):
        raise SpecError(f"{what}: 1 to 200 characters on one line")


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not NAME_RE.match(text):
        raise SpecError(f"{what} {text!r} is not a valid name")


def check_spec(spec: dict) -> None:
    """Raise ``SpecError`` where ``spec`` breaks the rules on names, units,
    keys and references between entries."""
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    if set(spec) != top:
        raise SpecError(f"top-level keys {sorted(spec)}")
    if not 1 <= int(spec["run_seconds"]) <= 51:
        raise SpecError("run_seconds outside 1..51")
    configs = {}
    for c in spec["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise SpecError(f"config keys {sorted(c)}")
        _name(c["name"], "config")
        _line(c["source"], "source")
        _line(c["why"], "why")
        for k in c["reduced"]:
            _name(k, "reduced key")
        configs[c["name"]] = c
    if len(configs) != len(spec["configs"]):
        raise SpecError("two configs share a name")
    cells = set()
    for w in spec["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise SpecError(f"workload keys {sorted(w)}")
        for key in ("name", "config", "traffic"):
            _name(w[key], key)
        _line(w["why"], "why")
        if w["config"] not in configs or w["chips"] not in (1, 4):
            raise SpecError(f"cell {w['name']}: unknown config or chips")
        cells.add(w["name"])
    if len(cells) != len(spec["workloads"]):
        raise SpecError("two cells share a name")
    metrics = set()
    for m in spec["end_to_end"] + spec["per_layer"]:
        _name(m["name"], "metric")
        if not UNIT_RE.match(m["unit"]) or m["better"] not in ("lower",
                                                               "higher"):
            raise SpecError(f"metric {m['name']}: unit or better")
        for c in m.get("workloads", []):
            if c not in cells:
                raise SpecError(f"metric {m['name']}: unknown cell {c}")
        metrics.add(m["name"])
    if len(metrics) != len(spec["end_to_end"]) + len(spec["per_layer"]):
        raise SpecError("two metrics share a name")
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound",
                                      "source"}:
            raise SpecError(f"end-to-end keys {sorted(m)}")
        if m["source"] not in ("host_clock", "device_trace"):
            raise SpecError(f"{m['name']}: source")
    for m in spec["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source",
                                      "layer", "moves"}:
            raise SpecError(f"per-layer keys {sorted(m)}")
        _line(m["layer"], "layer")
        if m["moves"] not in e2e:
            raise SpecError(f"{m['name']} moves an unknown metric")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    check_spec(spec)
    return spec


@dataclass
class Cell:
    """One cell with everything it names, found by name."""
    name: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic mix's file
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``spec``, its files read."""
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(root, "slambench", "traffic",
                                 w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    layer = [m for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name, w["chips"], config, traffic, e2e, layer)


def _module(kind: str, name: str, root: str = ROOT):
    """``slambench/<kind>/<name>.py`` loaded as a module."""
    path = os.path.join(root, "slambench", kind, name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no {kind} module {name!r} ({path})")
    mod_name = f"slambench.{kind}.{name}"
    if root != ROOT or "." in name:
        # a file outside this checkout, or a name that is no identifier
        mod_name = f"slambench_{kind}_{abs(hash(path))}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def kind_module(name: str, root: str = ROOT):
    return _module("kinds", name, root)


def system_module(name: str, root: str = ROOT):
    return _module("systems", name, root)


def metric_reader(name: str, root: str = ROOT):
    """The per-layer metric's ``read(data) -> float | None``."""
    return _module("metrics", name, root).read


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that a run must not load, each
    compared whole (``lidar_slam_tpu_torch`` is not ``lidar_slam_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


# -- statistics ----------------------------------------------------------------
def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between ranks
    (numpy's default), in plain Python."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# -- a run's window --------------------------------------------------------
@dataclass
class Window:
    """What a traffic kind's run hands back to ``run.py``."""
    e2e: dict                    # end-to-end metric name -> value
    attempted: int
    failed: int
    # the sessions held to the reference: (the rows the reference takes,
    # the outputs on the host of the sessions that mapped them; None for a
    # session that failed)
    groups: list
    memory_peak_bytes: int
    trace: object = None         # trace.TraceSummary of the traced stretch
    data: dict = field(default_factory=dict)   # for the per-layer readers
    traced_group: int | None = None  # the group whose session was traced
    errors: list = field(default_factory=list)  # tracebacks of failures


def sync(device: str) -> None:
    """Wait for the device (nothing on the CPU)."""
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    if str(device).startswith("cuda"):
        import torch

        return int(torch.cuda.max_memory_allocated())
    return 0


def make_tour(config: dict, seed: int):
    """The configuration's tour, one log, from ``seed`` (the frozen
    synthesiser): (ranges, ground truth)."""
    from slambench.frozen import simulate

    # any whole number seeds a generator: a negative one wraps
    return simulate.generate_tour(seed=seed % 2 ** 64, **config["tour"])


def make_logs(config: dict, seed: int, count: int):
    """``count`` logs of the configuration's tour from ``seed``: (list of
    ranges, ground truth)."""
    from slambench.frozen import simulate

    return simulate.tour_logs(seed=seed % 2 ** 64, count=count,
                              **config["tour"])
