"""The port's span log (``utils/profiling``: ``span``, ``session``,
``SPANS``) and the benchmark's readers of it.

With no profiler running a span records nothing and enters no profiler
range. Under ``torch.profiler`` on the CPU: nested spans carry their
parent, request id and self time; a ``host=True`` span lies inside the
kineto event of its name, and no other span has one; ``run_scan``,
``GraphSlam.run`` and ``run_streaming_slam`` each record one ``session``
with the spans of their layers, and none from inside a body that
``Graphs.run`` runs. The six ``program_span`` readers of
``slambench/metrics/`` read a hand-made log."""

import gc
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
from lidar_slam_tpu_torch.io import server, simulate
from lidar_slam_tpu_torch.models import graph_slam, scan_matcher
from lidar_slam_tpu_torch.utils import profiling
from lidar_slam_tpu_torch.utils.profiling import SPANS, Span, SpanLog, span


def _profiled(fn, collect: bool = True):
    """``fn()`` under ``torch.profiler`` on the CPU with an empty log:
    (the spans recorded, the counters, kineto's events as (name, start_ns,
    end_ns)). ``collect=False`` holds Python's automatic garbage
    collections off meanwhile, so that no ``python.gc`` span enters the
    log unasked."""
    SPANS.clear()
    if not collect:
        gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
    finally:
        gc.enable()
    events = [(ev.name(), ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()]
    spans, counters = list(SPANS.spans), dict(SPANS.counters)
    SPANS.clear()
    return spans, counters, events


def test_span_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    SPANS.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    for host in (False, True):
        with span("x", tag="t", req=1, host=host) as rec:
            assert rec is None
            gc.collect()
    with profiling.session("entry", "cpu") as rec:
        assert rec is None
    SPANS.count("c", 3)
    assert SPANS.spans == [] and SPANS.counters == {}
    # one shared no-op object, whatever the arguments
    assert span("a") is span("b", host=True) is profiling.session("c", "cpu")


def test_nested_spans_record_parent_req_and_self_time():
    other = {}

    def on_a_thread():
        with span("thread", req=9) as rec:
            other["rec"] = rec

    def work():
        with span("outer", tag="t", req=7):
            time.sleep(0.002)
            with span("inner", req=7):
                time.sleep(0.003)
            t = threading.Thread(target=on_a_thread)
            t.start()
            t.join(10)
            with span("inner2"):
                time.sleep(0.001)
        SPANS.count("c", 2)
        SPANS.count("c")

    spans, counters, _ = _profiled(work, collect=False)
    outer, inner, thread, inner2 = spans
    assert [s.name for s in spans] == ["outer", "inner", "thread", "inner2"]
    assert outer.parent is None and inner.parent == 0 and inner2.parent == 0
    # another thread's span has its own stack
    assert thread.parent is None and thread is other["rec"]
    assert thread.thread != outer.thread == threading.get_ident()
    assert (outer.tag, outer.req, inner.req, inner2.req) == ("t", 7, 7, None)
    assert (outer.start_ns <= inner.start_ns < inner.end_ns <= inner2.start_ns
            < inner2.end_ns <= outer.end_ns)
    log = SpanLog()
    log.spans.extend(spans)
    assert log.self_ns(0) == outer.ns - inner.ns - inner2.ns
    assert log.self_ns(1) == inner.ns >= 3_000_000
    assert counters == {"c": 3}


def _toy_work():
    with span("toy.device"):                 # encloses device work: no range
        with span("toy.host", host=True, req=3):
            sum(range(10_000))
        torch.ones(64) + 1
        with span("toy.host", host=True, req=4):
            time.sleep(0.001)
        gc.collect()


@pytest.fixture(scope="module")
def toy_trace():
    return _profiled(_toy_work, collect=False)


def _kineto_event_around(rec, events):
    return [e for e in events if e[0] == rec.name
            and e[1] <= rec.start_ns and rec.end_ns <= e[2]]


def test_host_spans_lie_inside_their_kineto_events(toy_trace):
    spans, _, events = toy_trace
    host = [s for s in spans if s.name == "toy.host"]
    assert [s.req for s in host] == [3, 4]
    # a garbage collection is a host span of its own, tagged with its
    # generation, under the span it interrupted
    collections = [s for s in spans if s.name == "python.gc" and s.tag == 2]
    assert collections and collections[-1].parent == 0
    for rec in host + collections:
        assert len(_kineto_event_around(rec, events)) == 1


def test_spans_without_host_have_no_kineto_event(toy_trace):
    spans, _, events = toy_trace
    assert spans[0].name == "toy.device"
    assert not [e for e in events if e[0] == "toy.device"]


# -- the entry points ---------------------------------------------------------
N_SCAN, N_LOOP, N_STREAM = 12, 160, 12


def _run_scan():
    ranges, _ = simulate.generate_dataset(N_SCAN, seed=3)
    scan_matcher.run_scan(ranges, DEFAULT_CONFIG, device="cpu")


def _graph_run():
    """160 loop-tour scans in chunks of 32 with closures after 3 keyframes:
    closures, an optimize and a feedback happen."""
    ranges, _ = simulate.generate_dataset(N_LOOP, seed=1,
                                          waypoints=simulate.LOOP_WAYPOINTS)
    gs = graph_slam.GraphSlam(DEFAULT_CONFIG,
                              graph_slam.LoopClosureConfig(min_gap=3),
                              device="cpu")
    gs.run(ranges, chunk_size=32)
    assert gs.closures and gs._epoch >= 1


def _stream():
    ranges, _ = simulate.generate_dataset(N_STREAM, seed=3)
    srv = server.ScanServer(ranges).start()
    try:
        server.run_streaming_slam(srv.url, N_STREAM, DEFAULT_CONFIG,
                                  device="cpu")
    finally:
        srv.stop()


ENTRIES = {"run_scan": _run_scan, "GraphSlam.run": _graph_run,
           "run_streaming_slam": _stream}

# the spans each entry records (name, tag); None: any tag
EXPECTED = {
    "run_scan": {("graphs.replay", "step"), ("sync", "fetch")},
    "GraphSlam.run": {
        ("graphs.replay", "step"), ("graphs.replay", ("match", 2)),
        ("stage", "frontend_chunk"), ("stage", "kf_fetch"),
        ("stage", "kf_raster_edt"), ("stage", "closure_match"),
        ("stage", "optimize"), ("stage", "feedback"),
        ("graph.keyframes", None), ("graph.candidates", None),
        ("graph.closure_gate", None), ("graph.graph_arrays", None),
        ("graph.rebuild_map", None), ("sync", "keyframe0"),
        ("sync", "step"), ("sync", "fetch"), ("sync", "kf_fetch"),
        ("sync", "closure_match"), ("sync", "refine"), ("sync", "optimize"),
        ("sync", "error"), ("sync", "feedback")},
    "run_streaming_slam": {("graphs.replay", "step"), ("sync", "step"),
                           ("sync", "fetch"), ("io.wait_row", None)},
}


HOST_SPANS = ("io.wait_row", "graph.keyframes", "graph.candidates",
              "graph.closure_gate", "graph.graph_arrays", "graph.rebuild_map")


@pytest.fixture(scope="module")
def entry_traces():
    return {name: _profiled(fn) for name, fn in ENTRIES.items()}


def _inside(rec, spans, i):
    """Whether span ``rec``'s parent chain reaches span ``i``."""
    p = rec.parent
    while p is not None:
        if p == i:
            return True
        p = spans[p].parent
    return False


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_point_records_one_session_with_its_spans(entry_traces,
                                                        entry):
    spans, counters, events = entry_traces[entry]
    sessions = [i for i, s in enumerate(spans) if s.name == "session"]
    assert len(sessions) == 1 and spans[sessions[0]].tag == entry
    i = sessions[0]
    assert spans[i].parent is None
    main = spans[i].thread
    # a garbage collection runs wherever an allocation sets it off: on the
    # test server's threads too
    for s in spans:
        if s.name not in ("session", "python.gc"):
            assert s.thread == main and _inside(s, spans, i), s.name
    got = {(s.name, s.tag) for s in spans}
    for name, tag in EXPECTED[entry]:
        assert any(n == name and (tag is None or t == tag)
                   for n, t in got), (name, tag)
    assert {s.name for s in spans} <= {n for n, _ in EXPECTED[entry]} | {
        "session", "python.gc"}
    assert counters == {}             # segments are counted on the card
    # every host span of a real run lies inside its kineto event
    for s in spans:
        if s.name in HOST_SPANS:
            assert _kineto_event_around(s, events), s.name
    replays = [s for s in spans if s.name == "graphs.replay"
               and s.tag == "step"]
    if entry == "run_scan":
        assert len(replays) == N_SCAN - 2     # scan 1 runs eagerly
    if entry == "run_streaming_slam":
        # one id a row: the wait for row N and the step's wait for its pose
        waits = [s.req for s in spans if s.name == "io.wait_row"]
        assert waits == list(range(N_STREAM + 1))   # and the stream's end
        steps = [s.req for s in spans if s.name == "sync" and s.tag == "step"]
        assert steps == list(range(1, N_STREAM))
        assert len(replays) == N_STREAM - 2


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_no_span_opens_inside_a_graphs_body(entry_traces, entry):
    spans = entry_traces[entry][0]
    bodies = {i for i, s in enumerate(spans)
              if s.name in ("graphs.replay", "graphs.capture")}
    assert bodies
    # a garbage collection may interrupt a body: it launches nothing
    assert not [s.name for s in spans if s.parent in bodies
                and s.name != "python.gc"]


# -- the benchmark's readers ----------------------------------------------------
MS = 1_000_000


def _hand_made_log() -> SpanLog:
    """Two sessions on thread 1 (0-10 ms, 20-30 ms) with captures, replays,
    device waits and chunks, a wait on another thread, an open replay and
    7 segments."""
    log = SpanLog()
    rows = [
        ("session", "GraphSlam.run", None, 0, 10, None, 1),
        ("stage", "frontend_chunk", None, 0.5, 9, 0, 1),
        ("graphs.capture", "step", None, 1, 3, 1, 1),
        ("graphs.replay", "step", None, 4, 4.01, 1, 1),
        ("sync", "fetch", None, 4.005, 4.5, 1, 1),
        ("graphs.replay", "step", None, 5, 5.03, 1, 1),
        ("sync", "step", 2, 6, 8, 1, 1),
        ("sync", "fetch", None, 1, 9, None, 2),      # another thread
        ("session", "GraphSlam.run", None, 20, 30, None, 1),
        ("stage", "frontend_chunk", None, 20.5, 24, 8, 1),
        ("stage", "frontend_chunk", None, 24, 29, 8, 1),
        ("graphs.capture", ("match", 8), None, 21, 22, 9, 1),
        ("graphs.replay", ("match", 8), None, 23, 23.02, 9, 1),
        ("sync", "step", 3, 25, 26, 10, 1),
        ("sync", "step", 4, 27, 27.5, 10, 1),
        ("graphs.replay", "step", None, 28, None, 10, 1),   # still open
    ]
    for name, tag, req, s, e, parent, thread in rows:
        log.spans.append(Span(name, tag, req, int(s * MS),
                              None if e is None else int(e * MS), parent,
                              thread))
    log.counters["alloc.segments"] = 7
    return log


SCANS = 6   # the scans of the traced stretch (``data["scans_traced"]``)

# host: session 1 is 10 ms less 2 + 0.5 + 0.03 + 2 of waits, replays and
# captures; session 2 is 10 ms less 1 + 0.02 + 1 + 0.5; over 3 chunks
READINGS = {
    "graphs.capture_ms_per_session": (2 + 1) / 2,
    "graphs.launch_us_per_replay": (10 + 30 + 20) / 3,
    "graph.host_ms_per_chunk": ((10 - 4.53) + (10 - 2.52)) / 3,
    "stream.sync_wait_p50_ms": 1.0,
    "alloc.segments_per_session": 7 / 2,
    "graphs.replays_per_scan": 3 / SCANS,
}


@pytest.mark.parametrize("metric", list(READINGS))
def test_span_readers_read_a_hand_made_log(metric, monkeypatch):
    from slambench import harness

    read = harness.metric_reader(metric)
    monkeypatch.setattr(profiling, "SPANS", _hand_made_log())
    data = {"scans_traced": SCANS}
    assert read(data) == pytest.approx(READINGS[metric], rel=1e-9)
    monkeypatch.setattr(profiling, "SPANS", SpanLog())
    assert read(data) is None
    monkeypatch.delattr(profiling, "SPANS")    # a program with no log
    assert read(data) is None


def test_unprofiled_runs_record_nothing():
    SPANS.clear()
    _run_scan()
    _stream()
    assert SPANS.spans == [] and SPANS.counters == {}
