"""Captured steps over static buffers: the port's counterpart of ``jax.jit``
with ``donate_argnums`` (``scan_matcher.make_step_fn``,
``fastslam.make_pf_step``).

A step's state and inputs live in static buffers that the step object owns
(host-made rows enter them through ``upload``). Each arm of the step is a
*body*: a function of those buffers that reads them and ends by copying its
results back into them (``copy_into``). On a
CUDA device ``Graphs.run`` captures a body once in a ``torch.cuda.CUDAGraph``
and replays it after: a replay launches the body's hundreds of ops in one
call, with the copies back into the buffers inside the graph. Before a
capture the body runs once on a *clone* of the buffers, on the capture's side
stream, so the run does not advance: that warm-up fills ``device.constant``'s
cache and loads the kernels (``_build.load_kernels``), and the warm-up and the
capture both run under ``torch.cuda.set_sync_debug_mode("error")``, so a
body that would read the device on the host raises. Every graph of one
``Graphs`` shares one memory pool: the bodies keep nothing of their own
between replays (what outlives a replay is copied into the static buffers,
which live outside the pool), and one stream replays them one at a time.

On the CPU nothing is captured: ``run`` calls the same body on the same
static buffers, so the CPU tests exercise the buffer handling, aliasing
included, as the card runs it. A capture or replay that fails on the card
raises; nothing falls back to the eager step.

The kernel wrappers count launches in Python (``cuda_edt.launches``,
``cuda_match.launches`` and their ``launches_by_shape``), so a replay would
count nothing. ``LaunchBook`` takes the counts a capture makes out again,
keeps them as the graph's delta and adds the delta on each replay; the
warm-up's launches, on the clone, are not counted.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
from lidar_slam_tpu_torch.utils.tree import map_with_path

COUNTED = (cuda_edt, cuda_match)   # modules with launches, launches_by_shape


def clone_tree(tree):
    """``tree`` with every tensor leaf cloned; other leaves (host numbers,
    generators) kept as they are."""
    return map_with_path(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def copy_into(bufs, tree) -> None:
    """Copy every tensor leaf of ``tree`` into the leaf of ``bufs`` at the
    same path (same structure, shapes and dtypes); other leaves are skipped.

    A leaf that *is* its buffer needs no copy. A leaf that reads another
    buffer which this call writes (``prev_pose`` := the old ``pose`` while
    ``pose`` := the new one) is cloned before any buffer is written."""
    pairs = []

    def pair(path, buf, x):
        if isinstance(buf, torch.Tensor):
            if buf.shape != x.shape or buf.dtype != x.dtype:
                raise ValueError(f"{path}: {x.dtype}{tuple(x.shape)} does not "
                                 f"fit its buffer {buf.dtype}"
                                 f"{tuple(buf.shape)}")
            if x is not buf:
                pairs.append((buf, x))

    def storage(t):
        return t.untyped_storage().data_ptr()

    map_with_path(pair, bufs, tree)
    written = {storage(buf) for buf, _ in pairs}
    pairs = [(buf, x.clone() if storage(x) in written
              and storage(x) != storage(buf) else x) for buf, x in pairs]
    for buf, x in pairs:
        buf.copy_(x)


def upload(buf: torch.Tensor, rows) -> None:
    """Write host-made ``rows`` (numpy or a CPU tensor, ``buf``'s shape)
    into the static buffer ``buf`` without a host sync. On the card the
    copy comes from a pinned staging copy made for this call: the caching
    host allocator keeps it until the copy has run, so a later upload into
    the same buffer cannot overwrite its rows before then."""
    host = torch.as_tensor(rows, dtype=buf.dtype)
    if host.shape != buf.shape:
        raise ValueError(f"rows of shape {tuple(host.shape)} do not fit "
                         f"their buffer {tuple(buf.shape)}")
    if buf.is_cuda:
        host = host.pin_memory()
    buf.copy_(host, non_blocking=True)


class Counts(NamedTuple):
    launches: int
    by_shape: collections.Counter


class LaunchBook:
    """Launch counts of captured bodies, added again on each replay.
    ``counters``: modules (or objects) with an int ``launches`` and a
    ``collections.Counter`` ``launches_by_shape``."""

    def __init__(self, counters=COUNTED):
        self.counters = tuple(counters)

    def snapshot(self) -> list[Counts]:
        return [Counts(c.launches, collections.Counter(c.launches_by_shape))
                for c in self.counters]

    def restore(self, snap: list[Counts]) -> None:
        for c, s in zip(self.counters, snap):
            c.launches = s.launches
            c.launches_by_shape.clear()
            c.launches_by_shape.update(s.by_shape)

    def record(self, fn) -> list[Counts]:
        """Call ``fn()`` and return the counts it added, taken out again."""
        before = self.snapshot()
        fn()
        after = self.snapshot()
        self.restore(before)
        return [Counts(a.launches - b.launches, a.by_shape - b.by_shape)
                for a, b in zip(after, before)]

    def add(self, delta: list[Counts]) -> None:
        """Count the launches of one replay."""
        for c, d in zip(self.counters, delta):
            c.launches += d.launches
            c.launches_by_shape.update(d.by_shape)


@contextlib.contextmanager
def _no_host_sync():
    """Any op that waits for the device raises (on a CUDA device)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class Graphs:
    """The captured bodies of one step object, by key, in one memory pool.

    ``run(key, body, bufs)`` replays the graph of ``key``, capturing
    ``body(bufs)`` at its first call; ``body`` and ``bufs`` must be the same
    at every call of a key (the graph holds the buffers' addresses). On the
    CPU it calls ``body(bufs)``. ``capture_seconds``: the host time the
    captures took (warm-up, capture, instantiation), summed."""

    def __init__(self, device: torch.device, counters=COUNTED):
        self.device = device
        self.capturing = device.type == "cuda"
        self.book = LaunchBook(counters)
        self.pool = torch.cuda.graph_pool_handle() if self.capturing else None
        # one side stream for every warm-up and capture: the caching
        # allocator reuses a freed block only on the stream it was made on,
        # so a stream a capture would leave each graph's blocks to it alone
        self.stream = torch.cuda.Stream(device) if self.capturing else None
        self._graphs: dict = {}   # key -> (CUDAGraph, launch delta)
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        """The number of graphs captured."""
        return len(self._graphs)

    def run(self, key, body, bufs) -> None:
        if not self.capturing:
            body(bufs)
            return
        if key not in self._graphs:
            t0 = time.perf_counter()
            self._graphs[key] = self._capture(body, bufs)
            self.capture_seconds += time.perf_counter() - t0
        graph, delta = self._graphs[key]
        graph.replay()
        self.book.add(delta)

    def _capture(self, body, bufs):
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        start = self.book.snapshot()
        with torch.cuda.stream(side), _no_host_sync():
            body(clone_tree(bufs))     # the warm-up, on a clone: not counted
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.book.restore(start)
        graph = torch.cuda.CUDAGraph()

        def capture():
            # capture_begin/end rather than ``torch.cuda.graph``, whose entry
            # synchronizes and empties the caching allocator and the pinned
            # host cache before every capture
            with torch.cuda.stream(side), _no_host_sync():
                graph.capture_begin(pool=self.pool)
                try:
                    body(bufs)
                finally:
                    graph.capture_end()

        return graph, self.book.record(capture)

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this object's pool."""
        if not self.capturing:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
