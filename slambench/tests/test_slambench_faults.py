"""The rest of a run, with the timed path broken underneath, comes out not
correct: a step that returns its state unchanged, half of the log left
out, and an answer altered where it is produced. (The cells run on one
card, so no exchange between cards can be left out.) The look for a card
is skipped: the runs are on the CPU at small sizes."""

import pytest

from lidar_slam_tpu_torch.io import server
from lidar_slam_tpu_torch.models import graph_slam, scan_matcher
from slambench.run import run_cell
from _small import small_cell


def _unchanged_step(monkeypatch):
    """The step computes its pose but hands its input state back."""
    advance, call = scan_matcher.StepFn.advance, scan_matcher.StepFn.__call__
    monkeypatch.setattr(scan_matcher.StepFn, "advance",
                        lambda self, st, r: (advance(self, st, r), st)[1])
    monkeypatch.setattr(scan_matcher.StepFn, "__call__",
                        lambda self, st, r: (st, call(self, st, r)[1]))


def _half_log(monkeypatch):
    run_scan, stream = scan_matcher.run_scan, server.run_streaming_slam
    run = graph_slam.GraphSlam.run
    monkeypatch.setattr(scan_matcher, "run_scan",
                        lambda r, *a, **k: run_scan(r[: len(r) // 2], *a, **k))
    monkeypatch.setattr(server, "run_streaming_slam",
                        lambda url, n, *a, **k: stream(url, n // 2, *a, **k))
    monkeypatch.setattr(graph_slam.GraphSlam, "run",
                        lambda self, r, **k: run(self, r[: len(r) // 2], **k))


def _altered_answer(monkeypatch):
    run_scan, stream = scan_matcher.run_scan, server.run_streaming_slam
    run = graph_slam.GraphSlam.run

    def scan(*a, **k):
        path, state = run_scan(*a, **k)
        path[len(path) // 2, 0] += 1e-4
        return path, state

    def streamed(*a, **k):
        path, state = stream(*a, **k)
        path[len(path) // 2, 1] += 1e-4
        return path, state

    def graph(self, *a, **k):
        path, kf = run(self, *a, **k)
        self.closures = self.closures[:-1]
        return path, kf

    monkeypatch.setattr(scan_matcher, "run_scan", scan)
    monkeypatch.setattr(server, "run_streaming_slam", streamed)
    monkeypatch.setattr(graph_slam.GraphSlam, "run", graph)


FAULTS = {"unchanged_step": _unchanged_step, "half_log": _half_log,
          "altered_answer": _altered_answer}


CELLS = ["museum-fidelity.replay", "museum-fidelity.stream10hz",
         "loop-graph.replay"]
_sound: dict = {}


def _run(name):
    return run_cell(small_cell(name), 21, 1.0, False, "cpu", 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_path_is_correct(name):
    line, err = _sound.setdefault(name, _run(name))
    assert line["correct"], line["compared"]
    assert err[-1].startswith("compared ")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line, err = _run(name)
    assert not line["correct"], line
    assert err[-1].startswith("compared ")
