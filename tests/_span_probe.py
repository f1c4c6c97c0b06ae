"""Where a replay session's host time goes, from the port's span log
(``utils/profiling.SPANS``), on the card:

    PYTHONPATH=. python tests/_span_probe.py [--cell loop-graph.replay]
        [--seed N] [--sessions 2] [--ab off,on]

Makes one log of the benchmark cell's tour from the seed and maps it once
(the kernel build and first uses). Then, with no profiler running: one
more session, with the host time of its graph captures
(``Graphs.capture_seconds`` of every ``Graphs`` it made), and the host time
of one replay of the fidelity step's graph and of one ``StepFn.advance``,
each launched onto an idle card (medians of 200). Then ``--sessions``
sessions under ``torch.profiler`` (host and CUDA activities, as a
``--trace 1`` run profiles its first session), each printed as: every span
name and tag with its count, total and self milliseconds
(``SpanLog.self_ns``); the benchmark's ``program_span`` readers on its log;
and the device's idle seconds as the benchmark's breakdown names them
(``slambench/trace.reduce_events``) from kineto's events alone, with every
span of the log added to them as a host event, and under the spans of each
name. Last, the cost of one span (its call, entry and exit, 10^4 of them)
with no profiler, and with one running, without and with ``host=True``.
``--ab off,on`` (or ``on,off``) instead maps the log twice under the
profiler, with the spans held off (``span`` sees no profiler) or on, in
that order, and prints each session's traced window and device idle
share: the spans' on-cost, one pair a process.

Profile at most two sessions a process: from the third on, kineto loses
device events and a later one crashed in ``CUDAGraph.replay``, with the
spans held off as with them on (torch 2.11, CUPTI on the H100).

Prints the card's name and power limit first. Needs a CUDA device and
``nvcc``; imports nothing of JAX.
"""

import argparse
import statistics
import subprocess
import sys
import time
import types
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from lidar_slam_tpu_torch.models import scan_matcher
from lidar_slam_tpu_torch.utils import graphs
from lidar_slam_tpu_torch.utils import profiling
from lidar_slam_tpu_torch.utils.profiling import SPANS, span
from slambench import harness
from slambench.trace import reduce_events

READERS = ("graphs.capture_ms_per_session", "graphs.launch_us_per_replay",
           "graphs.replays_per_scan", "graph.host_ms_per_chunk",
           "alloc.segments_per_session")
REPS = 200


def _untraced(program, log) -> None:
    """One session with no profiler: its wall and its captures' host time;
    then one replay of the fidelity step's graph, and one ``advance``, on
    an idle card."""
    made, init = [], graphs.Graphs.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    graphs.Graphs.__init__ = keep
    try:
        t0 = time.perf_counter()
        program.replay(log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        graphs.Graphs.__init__ = init
    captures = sum(len(g) for g in made)
    print(f"untraced session {wall * 1e3:.3f} ms: {captures} captures, "
          f"{sum(g.capture_seconds for g in made) * 1e3:.3f} ms")

    spec = harness.load_spec()
    fid = harness.cell(spec, "museum-fidelity.replay")
    cfg = harness.system_module("fidelity").program_config(fid.config)
    ranges = torch.as_tensor(log, device="cuda")
    step = scan_matcher.make_step_fn(cfg, "cuda")
    state = scan_matcher.init_state(ranges[0], cfg)
    state = step.advance(step.advance(state, ranges[1]), ranges[2])
    graph = step.graphs._graphs["step"][0]

    def idle_card(fn) -> float:
        ns = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            fn()
            ns.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
        return statistics.median(ns) / 1e3

    launch = idle_card(graph.replay)
    t, held = iter(range(3, 3 + REPS)), [state]

    def advance_one():
        held[0] = step.advance(held[0], ranges[next(t)])

    advance = idle_card(advance_one)
    print(f"untraced, onto an idle card: one step graph replay {launch:.2f} "
          f"us, one StepFn.advance {advance:.2f} us (medians of {REPS})")


def _report(spans: list, events: list, t0: int, t1: int, scans: int) -> None:
    log = type(SPANS)()
    log.spans.extend(spans)
    rows = defaultdict(lambda: [0, 0, 0])   # (name, tag) -> count, ns, self
    for i, s in enumerate(spans):
        tag = s.tag if s.name in ("session", "sync", "stage",
                                  "python.gc") else None
        r = rows[(s.name, str(tag))]
        r[0] += 1
        r[1] += s.ns
        r[2] += log.self_ns(i)
    print(f"{'span':28s} {'tag':22s} {'count':>6s} {'total ms':>10s} "
          f"{'self ms':>10s}")
    for (name, tag), (n, ns, own) in sorted(rows.items(),
                                            key=lambda kv: -kv[1][2]):
        print(f"{name:28s} {tag:22s} {n:6d} {ns / 1e6:10.3f} "
              f"{own / 1e6:10.3f}")
    data = {"scans_traced": scans}
    print("  readers:", {m: harness.metric_reader(m)(data)
                         for m in READERS})

    def top(idle: dict) -> dict:
        return {k: round(v, 4) for k, v in
                sorted(idle.items(), key=lambda kv: -kv[1])[:8]}

    closed = [(s.name, False, s.start_ns, s.end_ns) for s in spans]
    device = [e for e in events if e[1]]
    print("  idle s, the breakdown:", top(reduce_events(events, t0, t1)
                                         .idle_by_host))
    print("  idle s, the breakdown with every span a host event:",
          top(reduce_events(events + closed, t0, t1).idle_by_host))
    under = {name: reduce_events(device + [e for e in closed
                                           if e[0] == name], t0, t1)
             .idle_by_host.get(name, 0.0) for name in {s.name for s in spans}}
    print("  idle s under the spans of each name:", top(under))


def _traced(program, log, spans_on: bool = True):
    """One session under the profiler: (kineto's events, t0_ns, t1_ns).
    ``spans_on=False`` hides the running profiler from ``span`` alone."""
    flag = profiling.autograd_profiler
    if not spans_on:
        profiling.autograd_profiler = types.SimpleNamespace(
            _is_profiler_enabled=False)
    torch.cuda.synchronize()
    SPANS.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            program.replay(log)
            torch.cuda.synchronize()
            t1 = time.time_ns()
    finally:
        profiling.autograd_profiler = flag
    events = [(ev.name(), ev.device_type() == DeviceType.CUDA,
               ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()]
    return events, t0, t1


def _ab(program, log, order: str) -> None:
    for side in order.split(","):
        events, t0, t1 = _traced(program, log, side == "on")
        tr = reduce_events(events, t0, t1)
        print(f"spans {side}: window {tr.window_s:.4f} s, idle "
              f"{100 * (1 - tr.busy_s / tr.window_s):.2f}%, "
              f"{len(SPANS.spans)} spans")
    SPANS.clear()


def _span_cost(n: int = 10_000) -> None:
    def rounds(host: bool) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            with span("probe.cost", tag="t", req=i, host=host):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = rounds(False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        rounds(False)           # the profiler's first buffers
        on, on_host = rounds(False), rounds(True)
    SPANS.clear()
    print(f"one span: {off:.3f} us with no profiler; with one running "
          f"{on:.3f} us, {on_host:.3f} us with host=True")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="loop-graph.replay")
    ap.add_argument("--seed", type=int, default=3170000001)
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--ab", default=None)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cell = harness.cell(harness.load_spec(), args.cell)
    system = harness.system_module(cell.config["system"])
    logs, _ = harness.make_logs(cell.config, args.seed, 1)
    program = system.Program(cell.config, "cuda")
    program.replay(logs[0])
    if args.ab:
        _ab(program, logs[0], args.ab)
        return 0
    _untraced(program, logs[0])
    for k in range(args.sessions):
        events, t0, t1 = _traced(program, logs[0])
        print(f"-- {args.cell} traced session {k + 1}: "
              f"{(t1 - t0) / 1e6:.3f} ms, {dict(SPANS.counters)}")
        _report(list(SPANS.spans), events, t0, t1, logs[0].shape[0])
    _span_cost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
