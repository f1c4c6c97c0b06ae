"""BENCHMARK.json parses, keeps the benchmark's rules, and names only files
that exist."""

import json
import os

import pytest

from slambench import harness


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_spec_keeps_the_rules(spec):
    harness.check_spec(spec)
    assert spec["command"] == ["python3", "slambench/run.py"]
    assert spec["paths"] == ["slambench"]
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    for n in names + [w["traffic"] for w in spec["workloads"]]:
        assert harness.NAME_RE.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert harness.UNIT_RE.match(m["unit"]), m
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


@pytest.mark.parametrize("bad", [
    {"configs": [{"name": "a b"}]},
    {"end_to_end": [{"name": "x", "unit": "tokens per second"}]},
    {"run_seconds": 52},
])
def test_check_refuses(spec, bad):
    broken = json.loads(json.dumps(spec))
    for key, value in bad.items():
        if isinstance(value, list):
            broken[key] = [dict(broken[key][0], **value[0])] + broken[key][1:]
        else:
            broken[key] = value
    with pytest.raises(harness.SpecError):
        harness.check_spec(broken)


def test_every_cell_finds_its_files(spec):
    for w in spec["workloads"]:
        cell = harness.cell(spec, w["name"])
        assert cell.config["name"] == w["config"]
        assert harness.system_module(cell.config["system"])
        assert harness.kind_module(cell.traffic["kind"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))


def test_config_files_state_the_source(spec):
    for c in spec["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
        assert conf["assumed"] and conf["limits"]
