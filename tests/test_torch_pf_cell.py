"""The benchmark's particle-filter cell (``museum-pf1024.replay``) at a small
size on the CPU: its configuration with 64 particles and a 60-scan tour.

``run_pf`` equals the plain reference (``slambench/reference/pf.py``) on
every number ``compare`` holds it to, over a run with refreshes and
resamples; the bfloat16 control fails the same comparison; a whole run of
the cell is correct, and comes out not correct with the timed path broken
underneath; under the profiler ``run_pf`` records one ``session``, a
``pf.draw`` span a replayed scan and the ``pf.refreshes`` counter; the cell's
two new readers read a hand-made log."""

import ast
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidar_slam_tpu_torch.models import fastslam
from lidar_slam_tpu_torch.utils import profiling
from lidar_slam_tpu_torch.utils.profiling import SPANS, Span, SpanLog
from slambench import control, harness, roofline
from slambench.run import run_cell
from slambench.tests._small import small_cell

torch.set_num_threads(2)

CELL = "museum-pf1024.replay"
PARTICLES = 64
SCANS = 60
SEED = 7


def _cell():
    """The cell's configuration and traffic, copied and cut to 64
    particles and a 60-scan tour."""
    cell = small_cell(CELL, scans=SCANS)
    cell.config["slam"]["particles"]["n_particles"] = PARTICLES
    return cell


@pytest.fixture(scope="module")
def session():
    """One program session and the reference on the same log: (the cell,
    the log, the session's outputs on the host, the reference's)."""
    cell = _cell()
    system = harness.system_module("pf")
    ranges, _ = harness.make_tour(cell.config, SEED)
    out = system.to_host(system.Program(cell.config, "cpu").replay(ranges))
    ref = system.reference(cell.config, ranges, "cpu", outputs=[out])
    return cell, ranges, out, ref


def test_configuration_is_the_readme_filter_at_its_sizes():
    cell = harness.cell(harness.load_spec(), CELL)
    pc = cell.config["slam"]["particles"]
    assert cell.chips == 1 and cell.traffic["kind"] == "replay"
    assert cell.config["system"] == "pf" and cell.config["reduced"] == []
    assert (pc["n_particles"], pc["vol_theta_bins"], pc["vol_half"]) == (
        1024, 7, 6)
    assert cell.config["slam"]["grid"]["fine_size"] == 400
    assert cell.config["tour"]["n_scans"] == 1000
    assert cell.config["pf_seed"] == 0
    assert set(cell.config["limits"]) == {
        "path_gap_m", "heading_gap_rad", "particles_gap_m",
        "map_points_gap", "field_gap"}


def test_run_pf_equals_the_reference(session):
    cell, _, out, ref = session
    system = harness.system_module("pf")
    checks = system.compare(cell.config, [out], ref)
    assert [n for n, _, _ in checks] == list(cell.config["limits"])
    assert all(v <= lim for _, v, lim in checks), checks
    assert ref["refreshes"] >= 3 and ref["resamples"] >= 1
    assert np.array_equal(out["path"], ref["path"])
    assert np.array_equal(out["logw"], ref["logw"])
    assert np.array_equal(out["map_xy"], ref["map_xy"])


def test_reference_counts_the_sessions_kernel_work(session):
    cell, ranges, _, ref = session
    g = cell.config["slam"]["grid"]
    work = ref["work"]
    assert work["fields"] == [(g["fine_size"], g["fine_size"],
                               ref["refreshes"])]
    assert len(work["volumes"]) == len(ranges) - 1
    assert all(t == 7 and half == 6 and s == g["fine_size"] and 0 < n <= 1079
               for t, n, half, s in work["volumes"])
    least = roofline.least_seconds(work, roofline.PEAKS[
        "NVIDIA H100 80GB HBM3"])
    assert least["k1"] > 0 and least["k2"] > 0


def test_bfloat16_control_fails_and_the_program_passes():
    r = control.readings(_cell(), 5, 2.0, "cpu", program=True)
    assert any(v > lim for _, v, lim in r["control"]), r["control"]
    assert all(v <= lim for _, v, lim in r["program"]), r["program"]


def _unchanged_step(monkeypatch):
    """The step computes its pose but hands its input state back."""
    advance = fastslam.PfStepFn.advance
    monkeypatch.setattr(
        fastslam.PfStepFn, "advance",
        lambda self, st, r, draws=None: (advance(self, st, r, draws), st)[1])


def _half_log(monkeypatch):
    run_pf = fastslam.run_pf
    monkeypatch.setattr(fastslam, "run_pf",
                        lambda r, *a, **k: run_pf(r[: len(r) // 2], *a, **k))


def _altered_answer(monkeypatch):
    run_pf = fastslam.run_pf

    def altered(*a, **k):
        path, state = run_pf(*a, **k)
        path[len(path) // 2, 0] += 1e-4
        return path, state

    monkeypatch.setattr(fastslam, "run_pf", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_log": _half_log,
          "altered_answer": _altered_answer}


def _run():
    return run_cell(_cell(), 21, 1.0, False, "cpu", 0.0)


def test_sound_run_of_the_cell_is_correct():
    line, err = _run()
    assert line["correct"], line["compared"]
    assert all(v["value"] == 0.0 for v in line["compared"].values())
    assert err[-1].startswith("compared ")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line, err = _run()
    assert not line["correct"], line
    assert err[-1].startswith("compared ")


def test_run_pf_records_session_draws_and_refreshes(session):
    cell, ranges, _, ref = session
    system = harness.system_module("pf")
    program = system.Program(cell.config, "cpu")
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        program.replay(ranges)
    spans, counters = list(SPANS.spans), dict(SPANS.counters)
    SPANS.clear()
    sessions = [i for i, s in enumerate(spans) if s.name == "session"]
    assert [spans[i].tag for i in sessions] == ["run_pf"]
    draws = [s for s in spans if s.name == "pf.draw"]
    assert len(draws) == len(ranges) - 2       # scan 1 runs eagerly
    assert all(s.parent == sessions[0] and s.end_ns >= s.start_ns
               for s in draws)
    assert counters == {"pf.refreshes": ref["refreshes"]}
    # no span opens inside the captured body
    bodies = {i for i, s in enumerate(spans) if s.name == "graphs.replay"}
    assert len(bodies) == len(ranges) - 2
    assert not [s.name for s in spans if s.parent in bodies
                and s.name != "python.gc"]


def test_unprofiled_run_pf_records_nothing():
    cell = _cell()
    ranges, _ = harness.make_tour(cell.config, SEED)
    SPANS.clear()
    harness.system_module("pf").Program(cell.config, "cpu").replay(
        ranges[:12])
    assert SPANS.spans == [] and SPANS.counters == {}


def _log() -> SpanLog:
    """A session (0-10 ms) with three draws of 20, 40 and 60 µs and 4
    refreshes counted."""
    log = SpanLog()
    log.spans.append(Span("session", "run_pf", None, 0, 10_000_000, None, 1))
    for k, us in enumerate((20, 40, 60)):
        start = (k + 1) * 1_000_000
        log.spans.append(Span("pf.draw", None, None, start,
                              start + us * 1000, 0, 1))
    log.spans.append(Span("pf.draw", None, None, 9_000_000, None, 0, 1))
    log.counters["pf.refreshes"] = 4
    return log


@pytest.mark.parametrize("metric,value", [("pf.draw_us_per_step", 40.0),
                                          ("pf.refreshes_per_scan", 0.1)])
def test_pf_readers_read_a_hand_made_log(metric, value, monkeypatch):
    read = harness.metric_reader(metric)
    data = {"scans_traced": 40}
    monkeypatch.setattr(profiling, "SPANS", _log())
    assert read(data) == pytest.approx(value, rel=1e-12)
    monkeypatch.setattr(profiling, "SPANS", SpanLog())
    assert read(data) is None
    monkeypatch.delattr(profiling, "SPANS")    # a program with no log
    assert read(data) is None


def test_reference_imports_nothing_of_the_program():
    path = pathlib.Path(harness.BENCH_DIR, "reference", "pf.py")
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "numpy", "torch", "slambench"}
