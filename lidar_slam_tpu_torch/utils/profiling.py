"""Profiling and cost accounting (counterpart of
``lidar_slam_tpu.utils.profiling``).

- ``StageTimer``: wall time per named stage; on a CUDA device each stage
  ends with a device synchronize (where the JAX package calls
  ``jax.effects_barrier()``), so a stage's time includes the device work it
  queued. Its device defaults to the card, like every entry point.
- ``trace``: a ``torch.profiler`` context writing a Chrome trace.
- ``cost_analysis``: the FLOPs of a call, by
  ``torch.utils.flop_counter.FlopCounterMode``. It counts the aten ops it
  knows (matmuls, convolutions, attention); the ctypes kernels K1 and K2
  and every elementwise op are not counted.
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
import os
import statistics
import time
from collections import defaultdict

import torch

from lidar_slam_tpu_torch.device import resolve_device


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
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
    Chrome trace (chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``{"flops": n}``: the FLOPs ``FlopCounterMode`` counts in one call of
    ``fn`` (not K1, K2 or elementwise ops; see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


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
