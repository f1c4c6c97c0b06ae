"""Profiling and cost accounting (counterpart of
``lidar_slam_tpu.utils.profiling``).

- ``span``, ``session`` and ``SPANS``: the port's span log. While a
  ``torch.profiler`` runs, ``span(name, ...)`` records a host-clock
  interval (``time.time_ns()``, the clock kineto stamps host events on) at
  a layer boundary, with its tag, request id, thread and enclosing span,
  in the process-wide ``SPANS``; a ``host=True`` span, which encloses no
  device work, is also a ``record_function`` range in the profiler's
  trace; so is each of Python's garbage collections (``python.gc``). With
  no profiler running ``span`` returns a shared no-op object and records
  nothing. ``session`` is the span of one entry-point call, with the
  caching allocator's new segments counted over it.
- ``StageTimer``: wall time per named stage; on a CUDA device each stage
  ends with a device synchronize (where the JAX package calls
  ``jax.effects_barrier()``), so a stage's time includes the device work it
  queued. Its device defaults to the card, like every entry point.
- ``trace``: a ``torch.profiler`` context writing a Chrome trace.
- ``device_time_ms``: a call's time, by CUDA events on the card (a wall
  clock on the CPU): warm-up, then the median of a few timed reps. The JAX
  package's ``scan_slope_ms`` exists because a remote-attached TPU dedupes
  repeated dispatches; on the card CUDA events time the call directly.
- ``pf_stage_profile``: the particle filter step's stages, one by one, on
  the state of a run ``n_scans`` into the museum tour.
- ``tensor_shapes``: the shape of every tensor the aten ops of a call
  produce (a ``TorchDispatchMode``), so a test can pin what a call never
  materialises.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import threading
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as autograd_profiler

from lidar_slam_tpu_torch.device import resolve_device


class Span:
    """One record of a ``SpanLog``: ``name``; ``tag`` (a graph key, a batch
    width, an entry point, a wait's site); ``req``, the scan or row the
    work is for; ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s clock
    (``end_ns`` None while the span is open); ``parent``, the index of the
    enclosing span on the same thread (None at the top); ``thread``, the
    thread's ``threading.get_ident()``."""

    __slots__ = ("name", "tag", "req", "start_ns", "end_ns", "parent",
                 "thread")

    def __init__(self, name: str, tag=None, req=None, start_ns: int = 0,
                 end_ns: int | None = None, parent: int | None = None,
                 thread: int = 0):
        self.name, self.tag, self.req = name, tag, req
        self.start_ns, self.end_ns = start_ns, end_ns
        self.parent, self.thread = parent, thread

    @property
    def ns(self) -> int:
        """The span's duration (ns)."""
        return self.end_ns - self.start_ns


def covered_ns(intervals) -> int:
    """The length (ns) of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is not None and s < end:
            s = end
        if e > s:
            total += e - s
            end = e
    return total


class SpanLog:
    """The spans (``spans``, in the order they opened) and the counters
    (``counters``) recorded while a profiler ran. The process has one,
    ``SPANS``; each thread keeps its own stack of open spans, so a span's
    parent is the innermost span open on its thread."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def clear(self) -> None:
        """Empty the log: spans and counters."""
        with self._lock:
            self.spans.clear()
            self.counters.clear()

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``, while a profiler runs."""
        if not autograd_profiler._is_profiler_enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def self_ns(self, i: int) -> int:
        """Span ``i``'s duration less the part of it that its child spans
        cover."""
        sp = self.spans[i]
        kids = [(max(c.start_ns, sp.start_ns), min(c.end_ns, sp.end_ns))
                for c in self.spans if c.parent == i and c.end_ns is not None]
        return sp.ns - covered_ns(kids)

    def _open(self, name: str, tag, req, start_ns: int) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rec = Span(name, tag, req, start_ns, None,
                   stack[-1] if stack else None, threading.get_ident())
        with self._lock:
            stack.append(len(self.spans))
            self.spans.append(rec)
        return rec

    def _close(self) -> None:
        self._local.stack.pop()


SPANS = SpanLog()


class _NoSpan:
    """What ``span`` returns with no profiler running: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_NO_SPAN = _NoSpan()


class _Collections:
    """Python's garbage collections as ``python.gc`` host spans, tagged
    with the generation, while a profiler runs: a ``gc.callbacks`` entry,
    added at the first span recorded. A collection runs on whichever
    thread allocates, one at a time, and frees what it finds (a finished
    session's CUDA graphs among it) without launching device work."""

    def __init__(self):
        self.hooked, self.open = False, None

    def hook(self) -> None:
        gc.callbacks.append(self)
        self.hooked = True

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if autograd_profiler._is_profiler_enabled:
                self.open = _Open("python.gc", info["generation"], None, True)
                self.open.__enter__()
        elif self.open is not None:
            opened, self.open = self.open, None
            opened.__exit__(None, None, None)


_COLLECTIONS = _Collections()


class _Open:
    """One span being recorded into ``SPANS`` (``span``)."""

    __slots__ = ("name", "tag", "req", "host", "rec", "range")

    def __init__(self, name: str, tag, req, host: bool):
        self.name, self.tag, self.req, self.host = name, tag, req, host
        self.rec = self.range = None

    def __enter__(self) -> Span:
        if not _COLLECTIONS.hooked:
            _COLLECTIONS.hook()
        if self.host:
            # the record's stamps are taken inside the profiler's range
            # (torch's ``record_function`` in its C form), so its interval
            # lies within the kineto event's
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        # stamped first: the record's allocation (and any collection it
        # sets off) comes after
        start = time.time_ns()
        self.rec = SPANS._open(self.name, self.tag, self.req, start)
        return self.rec

    def __exit__(self, *exc):
        # stamped first, then the range closes: the record's interval ends
        # as close to the kineto event's end as it can
        self.rec.end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        SPANS._close()
        return False


def span(name: str, tag=None, req=None, host: bool = False):
    """A context manager recording the block as a span of ``SPANS`` while a
    profiler runs (``Span`` for the fields); with none running, a shared
    no-op object (no clock read, no allocation).

    ``host=True`` marks a block that encloses no device work (no kernel,
    copy, memset or graph launch): only such a span is also a
    ``record_function`` range, so it names the host's activity in the
    profiler's trace. Python's garbage collections are ``python.gc`` host
    spans of their own. A range around device work would become a device
    annotation there and count as device time. No span opens inside a body
    that ``utils.graphs.Graphs.run`` captures."""
    # whether a profiler runs: a module attribute that torch sets at the
    # profiler's start and clears at its stop
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open(name, tag, req, host)


def _segments(device: torch.device) -> int | None:
    """The caching allocator's segments made so far on the card (its
    ``cudaMalloc`` calls); None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device).get("segment.all.allocated")


@contextlib.contextmanager
def _session(entry: str, device: torch.device):
    before = _segments(device)
    try:
        with _Open("session", entry, None, False):
            yield
    finally:
        if before is not None:
            SPANS.count("alloc.segments", _segments(device) - before)


def session(entry: str, device: str | torch.device):
    """The span of one entry-point call (``session``, tagged ``entry``),
    with the caching allocator's segments made over it added to the
    counter ``alloc.segments`` on the card (read at the span's two ends);
    with no profiler running, the shared no-op object."""
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _session(entry, resolve_device(device))


class StageTimer:
    """Accumulates wall time per named stage. While a profiler runs each
    stage is also a ``stage`` span tagged with the stage's name, and on the
    card its closing synchronize a ``sync`` span (``host=True``) tagged
    ``stage`` inside it."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("stage", tag=name):
                try:
                    yield
                finally:
                    if self.device.type == "cuda":
                        with span("sync", tag="stage", host=True):
                            torch.cuda.synchronize(self.device)
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = [f"{'stage':24s} {'total s':>9s} {'calls':>7s} {'share':>7s}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:9.3f} {self.counts[name]:7d} "
                         f"{100 * t / total:6.1f}%")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (host ops, and the card's kernels
    and copies when there is a card); writes ``log_dir/trace.json``, a
    Chrome trace (chrome://tracing or Perfetto). Yields the profiler.

    ``SPANS`` is emptied at entry, so afterwards it holds the block's spans
    alone. The trace carries the program's ``host=True`` spans (waits for
    rows, the graph backend's bookkeeping, the stages' synchronizes) as
    host ranges on the device's clock; ``SPANS`` holds every span,
    those around device work too (sessions, graph captures and replays,
    device waits), on the same clock (``time.time_ns()``)."""
    from torch.profiler import ProfilerActivity, profile

    SPANS.clear()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


TIMING_REPS, TIMING_CALLS, TIMING_WARMUP = 5, 10, 2


def device_time_ms(fn, make_args) -> float:
    """Median ms of one ``fn(*make_args(k))`` call over ``TIMING_REPS``
    reps of ``TIMING_CALLS`` back-to-back calls, after ``TIMING_WARMUP``
    calls. Where ``make_args`` gives CUDA tensors the reps are timed with
    CUDA events (the time the stream took, the host's enqueue included
    where it is the slower); otherwise with a wall clock. Arguments are
    made outside the timed window."""
    reps, calls, warmup = TIMING_REPS, TIMING_CALLS, TIMING_WARMUP
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda
                  for a in make_args(0))
    for k in range(warmup):
        fn(*make_args(k))
    times = []
    for r in range(reps):
        args = [make_args(warmup + r * calls + i) for i in range(calls)]
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for a in args:
                fn(*a)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / calls)
        else:
            t0 = time.perf_counter()
            for a in args:
                fn(*a)
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


PF_STAGES = ("raster_crop", "edt", "volume_build", "lookup_1024",
             "resample_1024", "whole_step")


def pf_stage_profile(cfg=None, n_scans: int = 120, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """ms of each stage of one particle-filter step (the analog of the
    reference's profile that justified accelerating the EDT), on the state
    of a run ``n_scans`` into the museum tour: the keyframe path's raster
    and local-map crop and its EDT (K1 on the card), the correlation-volume
    cascade (K2), the particles' cascade lookups, systematic resampling, and
    the whole step. ``cfg`` defaults to ``DEFAULT_CONFIG`` with 1024
    particles (the ``_1024`` names keep the JAX package's keys whatever the
    count). Returns {stage: ms}."""
    import dataclasses

    import numpy as np

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.core import gridmap, se2, sensor
    from lidar_slam_tpu_torch.io import dataset
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
    from lidar_slam_tpu_torch.ops import correlative
    from lidar_slam_tpu_torch.ops import edt as edt_ops

    dev = resolve_device(device)
    if cfg is None:
        cfg = dataclasses.replace(
            DEFAULT_CONFIG, particles=ParticleConfig(n_particles=1024))
    pc, g, mc = cfg.particles, cfg.grid, cfg.matcher
    p = pc.n_particles

    ranges, _ = dataset.ensure_dataset(n_scans=n_scans, seed=seed)
    _, state = fastslam.run_pf(ranges, cfg, seed=seed, device=dev)
    angles = angles_tensor(cfg, dev)
    r_last = torch.as_tensor(ranges[-1], device=dev)
    scan = sensor.read_scan(r_last, angles, cfg.lidar)
    rng = np.random.default_rng(seed)
    offsets = [torch.as_tensor(np.float32(1e-6 * (k + 1)), device=dev)
               for k in range(64)]

    def jitter(k):      # a distinct input a call, made outside the timing
        return offsets[k % len(offsets)]

    out = {}

    def raster(pose):
        wx, wy = se2.transform_ref(scan.x, scan.y, pose)
        local = gridmap.extract_local_map(state.pmap, wx, wy, scan.valid,
                                          g.border_size)
        return gridmap.rasterize_dual(local, g)[1].occ

    kf = state.pmap.keyframe_pose
    out["raster_crop"] = device_time_ms(raster, lambda k: (kf + jitter(k),))

    occs = [torch.roll(state.fine.occ, k, dims=0) for k in range(4)]
    out["edt"] = device_time_ms(
        lambda o: edt_ops.edt(o, int(g.max_dist_px)),
        lambda k: (occs[k % 4],))

    base0 = state.poses.to(torch.float64).mean(dim=0).to(torch.float32)

    def cascade(base):
        return correlative.build_cascade(
            state.fine_metric, state.fine, scan.x, scan.y, scan.valid, base,
            n_theta=pc.vol_theta_bins, theta_step=mc.fine_r,
            half=pc.vol_half, levels=pc.cascade_levels)

    out["volume_build"] = device_time_ms(cascade,
                                         lambda k: (base0 + jitter(k),))

    vols = cascade(base0)
    out["lookup_1024"] = device_time_ms(
        lambda poses: correlative.lookup_cascade(vols, poses),
        lambda k: (state.poses + jitter(k),))

    logw0 = torch.as_tensor(rng.normal(size=p).astype(np.float32),
                            device=dev)
    u0 = torch.as_tensor(np.float32(0.5 / p), device=dev)
    out["resample_1024"] = device_time_ms(
        lambda lw: fastslam.systematic_resample(u0, lw),
        lambda k: (logw0 + jitter(k),))

    out["whole_step"] = device_time_ms(
        lambda r: fastslam.pf_step(state, r, cfg, angles),
        lambda k: (r_last + jitter(k),))
    return out


def tensor_shapes(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and a ``collections.Counter`` of the shapes
    of every tensor its aten ops produced (views and in-place results
    included)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    shapes = Counter()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    shapes[tuple(t.shape)] += 1
            return out

    with Record():
        result = fn(*args, **kwargs)
    return result, shapes
