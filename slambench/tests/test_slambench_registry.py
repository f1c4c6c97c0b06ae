"""A new cell, configuration, traffic mix, traffic kind, system and
per-layer metric are found from files and entries alone: a throwaway of
each, written into a copy of the benchmark's files in a temporary directory,
runs without an edit to any file that is there."""

import json
import os
import shutil

from slambench import harness
from slambench.run import run_cell

SYSTEM = '''
"""A throwaway system: each session returns the log's row count."""
import numpy as np


class Program:
    def __init__(self, config, device):
        self.scale = config["scale"]

    def replay(self, ranges):
        return {"n": np.asarray([len(ranges) * self.scale])}


def to_host(out):
    return out


def reference(config, rows, device, dtype=None, outputs=()):
    return {"n": np.asarray([len(rows) * config["scale"]]),
            "work": {"fields": [], "volumes": []}}


def compare(config, outs, ref):
    gap = max(float(abs(o["n"] - ref["n"]).max()) for o in outs)
    return [("n_gap", gap, config["limits"]["n_gap"])]
'''

KIND = '''
"""A throwaway traffic kind: ``sessions`` sessions of the whole log."""
import time

from slambench import harness


def reference_rows(config, traffic, ranges, seconds):
    return ranges


def run(system, config, traffic, seed, seconds, trace, device, t_start):
    ranges, _ = harness.make_tour(config, seed)
    program = system.Program(config, device)
    t0 = time.perf_counter()
    outs = [program.replay(ranges) for _ in range(traffic["sessions"])]
    t1 = time.perf_counter()
    return harness.Window(
        e2e={"scans_per_s": len(outs) * len(ranges) / (t1 - t0),
             "setup_s": t0 - t_start},
        attempted=len(outs), failed=0, groups=[(ranges, outs)],
        memory_peak_bytes=0, data={"scans_traced": len(ranges)})
'''

METRIC = '''
"""A throwaway per-layer metric: the scans of the traced stretch."""


def read(data):
    return float(data.get("scans_traced") or 0) or None
'''


def test_throwaway_cell_is_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (root / "slambench").rglob("*") if p.is_file()}
    spec = harness.load_spec()
    (root / "slambench" / "systems" / "toy_sys.py").write_text(SYSTEM)
    (root / "slambench" / "metrics" / "toy.scans_traced.py").write_text(
        METRIC)
    (root / "slambench" / "kinds" / "toy_kind.py").write_text(KIND)
    (root / "slambench" / "traffic" / "toy_mix.json").write_text(
        json.dumps({"kind": "toy_kind", "sessions": 2}))
    conf = dict(json.load(open(os.path.join(
        harness.ROOT, "slambench/configs/museum-fidelity.json"))),
        name="toy-conf", system="toy_sys", scale=3,
        limits={"n_gap": 0.0})
    conf["tour"] = dict(conf["tour"], n_scans=4)
    (root / "slambench" / "configs" / "toy-conf.json").write_text(
        json.dumps(conf))
    spec["configs"].append({"name": "toy-conf", "source": "a test",
                            "file": "slambench/configs/toy-conf.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy-conf.toy_mix",
                              "config": "toy-conf", "traffic": "toy_mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "toy.scans_traced", "unit": "scans",
                              "better": "higher", "source": "program_counter",
                              "layer": "a test", "moves": "scans_per_s",
                              "workloads": ["toy-conf.toy_mix"]})
    for m in spec["end_to_end"]:
        if m["name"] == "scans_per_s":
            m["workloads"].append("toy-conf.toy_mix")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.cell(harness.load_spec(str(root)), "toy-conf.toy_mix",
                        str(root))
    assert cell.config["system"] == "toy_sys"
    assert [m["name"] for m in cell.per_layer] == ["toy.scans_traced"]
    system = harness.system_module("toy_sys", str(root))
    reader = harness.metric_reader("toy.scans_traced", str(root))
    assert reader({"scans_traced": 4}) == 4.0
    assert system.Program(cell.config, "cpu").replay([0] * 4)["n"][0] == 12
    # the whole run, through the existing replay kind, finds them too
    mods = (harness.system_module, harness.kind_module,
            harness.metric_reader)
    for name, fn in zip(("system_module", "kind_module", "metric_reader"),
                        mods):
        monkeypatch.setattr(harness, name,
                            lambda n, fn=fn: fn(n, str(root)))
    line, _ = run_cell(cell, 5, 1.0, False, "cpu", 0.0)
    assert line["correct"] and line["attempted"] == 2
    assert line["metrics"]["scans_per_s"]["value"] > 0
    line, _ = run_cell(cell, 5, 1.0, True, "cpu", 0.0)
    assert line["metrics"] == {"toy.scans_traced": {"value": 4.0,
                                                    "unit": "scans"}}
    assert line["compared"] == {"n_gap": {"value": 0.0, "limit": 0.0}}
    # no file that was there changed
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
