"""Captured steps over static buffers: the port's counterpart of ``jax.jit``
with ``donate_argnums`` (``scan_matcher.make_step_fn``,
``fastslam.make_pf_step``), and of ``lax.cond`` and a masked ``lax.scan``
inside them (``cond``, ``while_loop``).

A step's state and inputs live in static buffers that the step object owns
(host-made rows enter them through ``upload``). Each step is a *body*: a
function of those buffers that reads them and ends by copying its results
back into them (``copy_into``). On a CUDA device ``Graphs.run`` captures a
body once in a ``torch.cuda.CUDAGraph`` and replays it after: a replay
launches the body's hundreds of ops in one call, with the copies back into
the buffers inside the graph. Before a capture the body runs once on a
*clone* of the buffers, on the capture's side stream, so the run does not
advance: that warm-up fills ``device.constant``'s cache and loads the
kernels (``_build.load_kernels``), and the warm-up and the capture both run
under ``torch.cuda.set_sync_debug_mode("error")``, so a body that would read
the device on the host raises. Every graph of one ``Graphs`` shares one
memory pool: the bodies keep nothing of their own between replays (what
outlives a replay is copied into the static buffers, which live outside the
pool), and one stream replays them one at a time. A conditional body's
allocations go to a second pool of the same object (its stream is another
capture than the graph's).

A body branches on a device bool with ``cond(pred, true_body, false_body)``,
JAX's ``lax.cond``: captured, each arm is a CUDA graph conditional (IF)
node, the second on ``~pred``, so the card picks the arm and the host never
reads ``pred``. The warm-up runs *both* arms (on the clone), so whatever an
arm makes at its first use (a constant's host->device copy, a kernel's
build) happens before the capture: a conditional body may hold only
kernels, memsets, device copies and further conditional nodes. Each arm
ends by copying its results into static buffers, since the nodes after the
branch read fixed addresses. A loop over a device count of rows (JAX's
masked ``lax.scan``) is ``while_loop(pred, body)``: one WHILE node whose
body runs for as long as the () bool ``pred``, which the body rewrites in
place, holds, so it runs as many times as the eager loop would; the
warm-up runs the body once. Conditional nodes do not nest here (every body
is captured on the one child stream of its ``Graphs``): a branch inside an
arm becomes a predicate of the main graph.

On the CPU nothing is captured: ``run`` calls the same body on the same
static buffers, ``cond`` takes the arm ``bool(pred)`` picks and
``while_loop`` loops on ``bool(pred)``, so the CPU tests exercise the buffer
handling, aliasing included, as the card runs it. A capture or replay that
fails on the card raises, and so does a missing conditional-node binding;
nothing falls back to the eager step, to a graph per count or to a host
read of the branch.

The kernel wrappers count launches in Python (``cuda_edt.launches``,
``cuda_match.launches``, ``cuda_scan_match.launches`` and their
``launches_by_shape``), so a replay would count nothing. ``LaunchBook``
takes the counts a capture makes out again: what runs on every replay is
the graph's delta, added on each replay; what runs in a conditional arm is
that arm's delta, and the arm adds one to its own device counter inside
the graph each time it runs (a WHILE body: each iteration). ``fetch``, a
run's one host read, brings the arm counters back with the run's results
and adds each arm's delta times the runs since the last fetch. The
warm-up's launches, on the clone, are not counted.

The models' step objects are ``CapturedStep``s: one protocol for loading
a state into the buffers, staging a step's inputs, replaying, rebuilding
the returned state and reading it back (``advance``, ``step(...)``,
``finish``); ``drive`` and ``host_loop`` are their driver loops.

A body may run the parallel layer's collectives (``parallel/mesh.Axis``)
in its main graph: NCCL's kernels are captured with the body's
(``CAPTURE_MODE``), and an ``Axis`` among a ``Graphs``'s ``counters`` has
its collectives booked as the kernels' launches are. The card's NCCL
refuses a collective of two or more ranks inside a conditional body (it
takes one on a world of one), so an arm writes what a collective needs
into static buffers and the main graph runs it after the node
(``tests/_nccl_probe.py`` tries each place).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch import _build
from lidar_slam_tpu_torch.device import resolve_device
from lidar_slam_tpu_torch.ops import (cuda_edt, cuda_match, cuda_scan_match,
                                      cuda_vol_lookup)
from lidar_slam_tpu_torch.utils.profiling import span
from lidar_slam_tpu_torch.utils.tree import map_with_path

# modules with launches, launches_by_shape
COUNTED = (cuda_edt, cuda_match, cuda_scan_match, cuda_vol_lookup)
# the capture's cudaStreamCaptureMode: "thread_local" lets another thread
# (c10d's NCCL watchdog, which polls the events of earlier collectives)
# make CUDA calls while a graph that holds collectives is captured
# (tests/_nccl_probe.py tries every mode)
CAPTURE_MODE = "thread_local"
# what records the IF and WHILE nodes on the card (torch 2.11 has no binding)
IF_NODE_ROUTE = "the port's C++ (csrc/graph_cond.cu)"


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
    """Launch counts of captured bodies, added again on each replay (or on
    each run of a conditional arm). ``counters``: modules (or objects) with
    an int ``launches`` and a ``collections.Counter``
    ``launches_by_shape``."""

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

    def add(self, delta: list[Counts], times: int = 1) -> None:
        """Count the launches of ``times`` replays (or arm runs)."""
        if times <= 0:
            return
        for c, d in zip(self.counters, delta):
            c.launches += d.launches * times
            for shape, n in d.by_shape.items():
                c.launches_by_shape[shape] += n * times


class Arm:
    """One conditional body of a captured graph: its launch delta, its
    device counter (() int64, one added inside the graph each time the body
    runs), the runs already added to the book and its ``kind``: "if" for an
    arm of ``cond``, "while" for the body of a ``while_loop``."""

    def __init__(self, delta: list[Counts], count: torch.Tensor,
                 kind: str = "if"):
        self.delta, self.count, self.kind = delta, count, kind
        self.settled = 0


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On a CUDA device, any op that waits for the device raises (the sync
    debug mode "error"); on the CPU, nothing."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class _Capture(NamedTuple):
    """What ``cond`` sees inside a ``Graphs``: the warm-up (``counts``
    None; ``arms`` gets a None an arm) or a capture, whose arms go to
    ``arms``, arm k counting its runs in ``counts[k]``."""
    runner: "Graphs"
    counts: torch.Tensor | None
    arms: list


_CAPTURE: contextvars.ContextVar = contextvars.ContextVar("graphs_capture",
                                                         default=None)


def cond(pred: torch.Tensor, true_body, false_body=None) -> None:
    """``jax.lax.cond`` inside a body: ``true_body()`` if the () bool tensor
    ``pred`` holds, else ``false_body()`` (if given). The arms return
    nothing; each ends by copying its results into static buffers.

    While a ``Graphs`` captures, each arm becomes an IF node (the second on
    ``~pred``) that adds one to the arm's device counter when it runs; in
    the warm-up before it, both arms run, on the clone; on the CPU the arm
    ``bool(pred)`` picks runs. On the card anywhere else it raises: the
    branch would have to read ``pred`` on the host."""
    ctx = _CAPTURE.get()
    if ctx is None:
        if pred.device.type != "cpu":
            raise RuntimeError("graphs.cond on the card runs only inside a "
                               "body that a Graphs captures")
        if bool(pred):
            true_body()
        elif false_body is not None:
            false_body()
        return
    if ctx.counts is None:   # the warm-up: every arm, on the clone
        for body in (true_body, false_body):
            if body is not None:
                body()
                ctx.arms.append(None)
        return
    arms = [(pred, true_body)]
    if false_body is not None:
        arms.append((torch.logical_not(pred), false_body))
    for p, body in arms:
        ctx.arms.append(ctx.runner._conditional_node(
            "if", p.contiguous(), body, ctx.counts[len(ctx.arms)]))


def while_loop(pred: torch.Tensor, body) -> None:
    """``body()`` for as long as the () bool tensor ``pred`` holds, tested
    before every run: a loop over a device count (JAX's ``lax.scan`` over
    rows under a mask). ``body`` returns nothing; it ends by copying its
    results into static buffers (tensors made before the loop, which it
    reads and rewrites in place) and by writing the next test into
    ``pred`` in place.

    While a ``Graphs`` captures, the loop is one WHILE node whose body adds
    one to its device counter an iteration; in the warm-up before it the
    body runs once, on the clone; on the CPU it loops on ``bool(pred)``. On
    the card anywhere else it raises: the loop would have to read ``pred``
    on the host."""
    if pred.shape != () or pred.dtype != torch.bool:
        raise ValueError(f"while_loop's pred is a () bool tensor, not "
                         f"{pred.dtype}{tuple(pred.shape)}")
    ctx = _CAPTURE.get()
    if ctx is None:
        if pred.device.type != "cpu":
            raise RuntimeError("graphs.while_loop on the card runs only "
                               "inside a body that a Graphs captures")
        while bool(pred):
            body()
        return
    if ctx.counts is None:   # the warm-up: the body once, on the clone
        body()
        ctx.arms.append(None)
        return
    ctx.arms.append(ctx.runner._conditional_node(
        "while", pred, body, ctx.counts[len(ctx.arms)]))


def fetch(*tensors: torch.Tensor, runners=()) -> list[np.ndarray]:
    """A run's one host read: ``tensors`` and the arm counters of every
    ``Graphs`` in ``runners`` come to the host together, behind one wait
    for the device; each arm's launches since the last fetch are then
    added to the kernels' counts. Returns the tensors as numpy arrays."""
    counts = [arm.count for r in runners for arm in r.arms]
    leaves = list(tensors)
    if counts:
        leaves.append(torch.stack(counts))
    hosts = []
    streams = set()
    with span("sync", tag="fetch"):
        for t in leaves:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                streams.add(torch.cuda.current_stream(t.device))
            else:
                h = t.detach().clone()
            hosts.append(h)
        for s in streams:
            s.synchronize()
    if counts:
        ran = iter(hosts.pop().tolist())
        for r in runners:
            for arm in r.arms:
                n = next(ran)
                r.book.add(arm.delta, n - arm.settled)
                arm.settled = n
    return [h.numpy() for h in hosts]


# The fields of a state that are host values in the eager steps and that a
# captured step which read nothing on the host returns as device tensors:
# its keyframe flag and, for the submap step, the atlas's slot ints; each
# with the host value it has in a step's buffers (``CapturedStep._load``).
HOST_FIELDS = {("mini_updated",): False, ("atlas", "n_submaps"): 0,
               ("atlas", "active"): 0}


def _field(state, path):
    for name in path:
        state = getattr(state, name, None)
    return state


def _with_field(state, path, value):
    if len(path) == 1:
        return state._replace(**{path[0]: value})
    return state._replace(**{path[0]: _with_field(
        getattr(state, path[0]), path[1:], value)})


def settle(step, state, *tensors):
    """A run's one host read for a step object (``step.graphs``, None for
    an eager step, and ``step.state``): ``tensors``, the ``HOST_FIELDS`` of
    ``state`` that are device tensors and the step's arm counters come to
    the host in one ``fetch``. Returns (``state`` with those fields as host
    values, the tensors as numpy arrays). The step keeps the result as its
    own state if ``state`` was, so its next call loads nothing."""
    paths = [p for p in HOST_FIELDS
             if isinstance(_field(state, p), torch.Tensor)]
    runners = [] if step.graphs is None else [step.graphs]
    hosts = fetch(*tensors, *(_field(state, p) for p in paths),
                  runners=runners)
    new = state
    for p, h in zip(paths, hosts[len(tensors):]):
        new = _with_field(new, p, h.item())
    if state is getattr(step, "state", None):
        step.state = new
    return new, hosts[:len(tensors)]


def finish(step, state):
    """``state`` with its device host fields read back (``settle``) and the
    step's conditional launches counted, in one ``fetch``."""
    return settle(step, state)[0]


class Graphs:
    """The captured bodies of one step object, by key, in one memory pool
    (and a second for their conditional bodies).

    ``run(key, body, bufs)`` replays the graph of ``key``, capturing
    ``body(bufs)`` at its first call; ``body`` and ``bufs`` must be the same
    at every call of a key (the graph holds the buffers' addresses). On the
    CPU it calls ``body(bufs)``. ``capture_seconds``: the host time the
    captures took (warm-up, capture, instantiation), summed. ``arms``: the
    conditional arms of every graph (``cond``), whose launches ``fetch``
    counts. While a profiler runs, each capture is a ``graphs.capture``
    span (its recording and instantiation, which run nothing on the
    device, a ``graphs.record`` host span inside it) and each replay (the
    body's call on the CPU) a ``graphs.replay`` span, tagged with the key
    (``profiling.span``)."""

    def __init__(self, device: torch.device, counters=COUNTED):
        self.device = device
        self.capturing = device.type == "cuda"
        self.book = LaunchBook(counters)
        self.pool = torch.cuda.graph_pool_handle() if self.capturing else None
        # one side stream for every warm-up and capture: the caching
        # allocator reuses a freed block only on the stream it was made on,
        # so a stream a capture would leave each graph's blocks to it alone
        self.stream = torch.cuda.Stream(device) if self.capturing else None
        # conditional bodies (``cond``): captured on a stream of their own,
        # into a pool of their own (what a body makes lives there)
        self.child = torch.cuda.Stream(device) if self.capturing else None
        self.cond_pool = torch.cuda.MemPool() if self.capturing else None
        self._graphs: dict = {}   # key -> (CUDAGraph, launch delta)
        self.arms: list[Arm] = []
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        """The number of graphs captured."""
        return len(self._graphs)

    def run(self, key, body, bufs) -> None:
        if not self.capturing:
            with span("graphs.replay", tag=key):
                body(bufs)
            return
        if key not in self._graphs:
            t0 = time.perf_counter()
            with span("graphs.capture", tag=key):
                self._graphs[key] = self._capture(key, body, bufs)
            self.capture_seconds += time.perf_counter() - t0
        graph, delta = self._graphs[key]
        with span("graphs.replay", tag=key):
            graph.replay()
        self.book.add(delta)

    def warm_up(self, body, bufs) -> int:
        """``body`` on a clone of ``bufs`` with every arm of its ``cond``s
        taken; the launches it makes are not counted. Returns the number
        of arms."""
        start = self.book.snapshot()
        arms: list = []
        token = _CAPTURE.set(_Capture(self, None, arms))
        try:
            body(clone_tree(bufs))
        finally:
            _CAPTURE.reset(token)
            self.book.restore(start)
        return len(arms)

    def _capture(self, key, body, bufs):
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), no_host_sync(self.device):
            n_arms = self.warm_up(body, bufs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        arms: list[Arm] = []
        # the arms' counters live outside the pool: a block the capture
        # takes from the pool may be a temporary of an earlier node of the
        # same graph, rewritten on every replay
        counts = torch.zeros(n_arms, dtype=torch.int64, device=self.device)

        def capture():
            # capture_begin/end rather than ``torch.cuda.graph``, whose entry
            # synchronizes and empties the caching allocator and the pinned
            # host cache before every capture
            with torch.cuda.stream(side), no_host_sync(self.device):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode=CAPTURE_MODE)
                token = _CAPTURE.set(_Capture(self, counts, arms))
                try:
                    body(bufs)
                finally:
                    _CAPTURE.reset(token)
                    graph.capture_end()

        # recording and instantiating run nothing on the device: a host span
        with span("graphs.record", tag=key, host=True):
            delta = self.book.record(capture)
        self.arms.extend(arms)
        return graph, delta

    def _conditional_node(self, kind: str, pred: torch.Tensor, body,
                          count: torch.Tensor) -> Arm:
        """Capture ``body()`` into an IF (``kind`` "if") or a WHILE
        ("while") node on the () bool ``pred`` of the graph being captured
        on the current stream, with its own launch delta and device
        counter. The body is captured on ``self.child``, its allocations
        routed to ``self.cond_pool``; a WHILE body ends by setting the
        node's handle from ``pred`` as the body left it."""
        parent = torch.cuda.current_stream(self.device)
        if parent == self.child:
            raise RuntimeError("conditional nodes do not nest: every body is "
                               "captured on the one child stream; make the "
                               "inner branch a predicate of the main graph")
        lib = _build.load_kernels()
        before = self.book.snapshot()
        handle = ctypes.c_ulonglong()
        if kind == "while":
            _build.check(lib.slam_while_begin(
                parent.cuda_stream, self.child.cuda_stream, pred.data_ptr(),
                ctypes.byref(handle)), "slam_while_begin")
        else:
            _build.check(lib.slam_if_begin(
                parent.cuda_stream, self.child.cuda_stream, pred.data_ptr()),
                "slam_if_begin")
        index, pool = self.child.device.index, self.cond_pool.id
        try:
            with torch.cuda.stream(self.child):
                # the body's stream is another capture than the graph's,
                # so the graph's pool does not take its allocations
                torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
                try:
                    body()
                    count.add_(1)
                finally:
                    torch._C._cuda_endAllocateToPool(index, pool)
                    torch._C._cuda_releasePool(index, pool)
        finally:
            if kind == "while":
                _build.check(lib.slam_while_end(
                    self.child.cuda_stream, handle, pred.data_ptr()),
                    "slam_while_end")
            else:
                _build.check(lib.slam_if_end(self.child.cuda_stream),
                             "slam_if_end")
        after = self.book.snapshot()
        self.book.restore(before)
        return Arm([Counts(a.launches - b.launches, a.by_shape - b.by_shape)
                    for a, b in zip(after, before)], count, kind)

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this object's two pools:
        the graphs' and their conditional bodies'."""
        if not self.capturing:
            return 0
        pools = {tuple(self.pool), tuple(self.cond_pool.id)}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)


class CapturedStep:
    """A model's step captured as one graph over static buffers that the
    object owns: JAX's jitted step with its state donated (the fidelity,
    submap, particle-filter, hybrid and EKF steps are subclasses).

    ``advance(state, *inputs)`` reads nothing on the host (on the card it
    runs under the sync debug mode "error"): the returned state's host
    fields (``HOST_FIELDS``) are the step's device values, which
    ``finish(state)`` reads back with the arms' launch counts in one copy.
    ``step(state, *inputs)`` also reads the pose and those fields (the
    ``out`` row, ``_decode``) in one copy. With ``eager_first``, scan 1
    (``state.step == 1``, whose guess differs) runs the eager step; with
    ``draws_from``, each step takes its ``draws`` from that callable.

    The returned state's tensors are the step's buffers until the next
    call, which takes them back (``clone_tree`` keeps a copy); a state the
    step did not return is copied in first. ``pose`` (on the device) and
    ``scan`` (None after an eager step) are the last step's. On the CPU
    the same body runs uncaptured on the same buffers.

    A subclass gives ``_eager``, ``_alloc`` (its buffers around a clone of
    the state), ``_stage`` (its inputs into them), ``_body`` and
    ``_returned`` (the state, pose and scan a replay returns), and where
    the defaults do not fit, ``_held``, ``_load_fields`` and ``_decode``."""

    key = "step"          # the graph's key in ``self.graphs``
    eager_first = True

    def __init__(self, device: str | torch.device, counters=COUNTED,
                 draws_from=None):
        self.device = resolve_device(device)
        self.graphs = Graphs(self.device, counters)
        self.draws_from = draws_from
        self.bufs = self.state = self.pose = self.scan = None

    def advance(self, state, *inputs, **kw):
        if self._eager_now(state, kw):
            self.scan = None
            return self._eager(state, *inputs, **kw)[0]
        with no_host_sync(self.device):
            return self._replay(state, *inputs, **kw)

    def __call__(self, state, *inputs, **kw):
        if self._eager_now(state, kw):
            self.scan = None
            state, pose = self._eager(state, *inputs, **kw)
            if isinstance(pose, torch.Tensor):
                pose = pose.cpu().numpy()
            return state, pose
        self._replay(state, *inputs, **kw)
        with span("sync", tag="step", req=state.step):
            host = self.bufs.out.to("cpu", copy=True)   # a copy on the CPU too
        self.state = self._decode(self.state, host)
        return self.state, host[:3].numpy()

    def finish(self, state):
        """The run's one host read (``graphs.finish``)."""
        return finish(self, state)

    def _eager_now(self, state, kw) -> bool:
        """Whether this step runs eagerly; puts its draws into ``kw``."""
        if self.draws_from is not None:
            kw["draws"] = self.draws_from()
        return self.eager_first and state.step == 1

    def _replay(self, state, *inputs, **kw):
        if state is not self.state:
            self._load(state, *inputs, **kw)
        self._stage(state, *inputs, **kw)
        self.graphs.run(self.key, self._body, self.bufs)
        self.state, self.pose, self.scan = self._returned(state)
        return self.state

    def _load(self, state, *inputs, **kw) -> None:
        """A state the step did not return into its buffers: its host
        fields (host values, or another step's device ones) go to
        ``_load_fields``, the rest into ``_held()``, made at the first load
        (``_alloc``, around a clone)."""
        held = state
        for path, value in HOST_FIELDS.items():
            if _field(state, path) is not None:
                held = _with_field(held, path, value)
        if self.bufs is None:
            self.bufs = self._alloc(clone_tree(held), *inputs, **kw)
        else:
            copy_into(self._held(), held)
        self._load_fields(state)

    def _held(self):
        return self.bufs.head.state

    def _load_fields(self, state) -> None:
        """Write what the buffers hold outside the state from ``state``."""

    def _decode(self, state, host: torch.Tensor):
        """``state`` with the keyframe flag of the ``out`` row ``host``."""
        return state._replace(mini_updated=bool(host[3]))


def load_value(buf: torch.Tensor, value) -> None:
    """Write a host field into ``buf``: a device value (a step's that read
    nothing on the host) by a device copy, a host one by ``fill_`` (an
    assignment would copy it from pageable memory and synchronize)."""
    if isinstance(value, torch.Tensor):
        buf.copy_(value)
    else:
        buf.fill_(value)


def drive(step: CapturedStep, state, n: int, inputs_at):
    """The captured driver loop, JAX's ``lax.scan`` over a log: steps
    t = 1..n-1 through ``step.advance(state, *inputs_at(t))`` with no host
    read after scan 1, each pose written into a (n, 3) tensor on the
    device, and the final state's host fields read back in the run's one
    read. Returns (that path, its row 0 the origin; the final state,
    cloned out of the step's buffers)."""
    path = torch.zeros((n, 3), dtype=torch.float32, device=step.device)
    for t in range(1, n):
        state = step.advance(state, *inputs_at(t))
        path[t] = step.pose
    return path, clone_tree(step.finish(state))


def host_loop(step: CapturedStep, state, n: int, inputs_at, start: int = 1):
    """``drive`` from step ``start`` with each pose copied to the host as
    it is produced, one read a step (``step(state, *inputs_at(t))``).
    Returns (path (n, 3) numpy, rows before ``start`` zero; final
    state)."""
    poses = [np.zeros(3, np.float32)] * start
    for t in range(start, n):
        state, pose = step(state, *inputs_at(t))
        poses.append(pose)
    return np.stack(poses), clone_tree(step.finish(state))
