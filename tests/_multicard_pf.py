"""The sharded PF-1024 on museum-1000 across the cards of one host, captured
against eager, with ``run_pf`` on one card as the yardstick, and the
scaling report:

    PYTHONPATH=. python tests/_multicard_pf.py [--meshes 2x2 1x4]
        [--scaling-scans N] [--out results.json]

Each mesh (particles x map) is a world of its own (``multihost.launch``,
a rank a card); ``run_pf`` runs in a world of one. On every rank, each
form (the captured step ``run_sharded_pf`` runs, then ``eager=True``)
runs the whole tour twice: scans/s is the second run's (host clock, the
path read), with its whole-run host syncs (sync debug mode "warn"), its
K1/K2 launches by shape and each axis's collectives by kind and shape.
Then two fresh runs of scans 1..150 drive the step object: the first
times scans 101-150 unprofiled, the second profiles them (device ms and
device ops a scan from ``torch.profiler``'s device rows, as
``chip_smoke.ProfileWindow`` reads them, and the NCCL kernels' share;
host syncs a scan). An NCCL kernel runs until every rank has joined, so
its device time holds the wait for the slowest rank and overlaps the
rank's other kernels. Last, on a map axis, the field's all-gather alone:
100 in a CUDA graph, one replay timed.

Checks, which fail the script: every rank's path, captured and eager, ==
``run_pf``'s; K1/K2 launches by shape and the particles axis's
collectives captured == eager; the map axis books one all-gather of the
field a scan captured and one a keyframe eager. Then
``multihost.scaling_report`` at worlds 1, 2 and 4 (the particles axis
alone). Prints the cards' names and power limits first; needs a card for
each rank of the largest mesh, and imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_SCANS = 1000
N_PARTICLES = 1024
WARM, WINDOW = 100, 50   # scans before the profiled window, and in it


def _profiled(run, n):
    """``run()`` (n scans) under ``torch.profiler`` (device activity) and
    the sync debug mode "warn": (device ops, device ms, host syncs, the
    NCCL kernels' device ms) a scan. An NCCL kernel runs from its launch
    until every rank has joined, so its time holds the wait for the
    slowest rank, and it overlaps the rank's other kernels."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    dev_us = nccl_us = 0.0
    n_ops = 0
    for ev in prof.key_averages():
        t_dev = getattr(ev, "self_device_time_total", None)
        if t_dev is None:
            t_dev = ev.self_cuda_time_total
        if t_dev > 0:
            dev_us += t_dev
            n_ops += ev.count
            if "nccl" in ev.key.lower():
                nccl_us += t_dev
    return n_ops / n, dev_us / n / 1e3, syncs / n, nccl_us / n / 1e3


def _window(make, n_first, n):
    """Two fresh runs of scans 1..n_first + n (``make() -> (step, state)``,
    ``step(state, t) -> state``): the wall seconds a scan of the last n
    unprofiled, then ``_profiled``'s numbers a scan of them."""
    out = []
    for profile in (False, True):
        step, state = make()
        for t in range(1, n_first + 1):
            state = step(state, t)

        def window():
            nonlocal state
            for t in range(n_first + 1, n_first + n + 1):
                state = step(state, t)  # noqa: B023

        if profile:
            out.append(_profiled(window, n))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) / n)
    return out


def _graph_us(launch, n: int = 100, replays: int = 5) -> float:
    """Device µs of one ``launch()``: n captured in a CUDA graph (the
    port's capture mode), one replay timed with CUDA events over n, the
    median of ``replays``; every rank replays at once."""
    from lidar_slam_tpu_torch.utils import graphs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=graphs.CAPTURE_MODE):
        for _ in range(n):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) * 1e3 / n)
    del graph
    return sorted(times)[replays // 2]


def pf_job(ranges: np.ndarray, n_map) -> dict:
    """In a rank of a launched world: the sharded PF-1024 on a
    (world / n_map) x n_map mesh, captured and eager, or with ``n_map``
    None ``run_pf`` alone. Returns each form's numbers and path."""
    from chip_smoke import SyncCount
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
    from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
    from lidar_slam_tpu_torch.parallel import sharded

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=N_PARTICLES))
    dev = torch.device("cuda", torch.cuda.current_device())
    scans = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    mesh = None if n_map is None else mesh_lib.make_mesh(
        n_map_shards=n_map, device_type="cuda")
    axes = () if mesh is None else (mesh.particles, mesh.map)
    forms = ("run_pf",) if mesh is None else ("captured", "eager")
    out = {}
    for form in forms:
        for _ in range(2):   # the second run is the one kept
            for c in (cuda_edt, cuda_match) + axes:
                c.launches = 0
                c.launches_by_shape.clear()
            with SyncCount() as sc:
                t0 = time.perf_counter()
                if mesh is None:
                    path, _ = fastslam.run_pf(ranges, cfg, 0, dev)
                else:
                    path, _ = sharded.run_sharded_pf(
                        ranges, cfg, mesh, eager=form == "eager")
                path = path.cpu().numpy()
                dt = time.perf_counter() - t0
                syncs = sc.count()
        keys = lambda d: {str(k): v for k, v in d.items()}   # noqa: E731
        out[form] = dict(
            path=path, scans_per_s=len(path) / dt, run_syncs=syncs,
            k1=keys(cuda_edt.launches_by_shape),
            k2=keys(cuda_match.launches_by_shape),
            particles=keys(mesh.particles.launches_by_shape) if mesh else {},
            map=keys(mesh.map.launches_by_shape) if mesh else {})

        def make(form=form):
            state = fastslam.init_particles(scans[0], cfg)
            if mesh is None:
                obj = fastslam.make_pf_step(cfg, dev)
            else:
                obj, place = sharded.make_sharded_pf_step(
                    cfg, mesh, eager=form == "eager")
                state = place(state)
            if form == "eager":
                return (lambda s, t: obj(s, scans[t])[0]), state
            return (lambda s, t: obj.advance(s, scans[t])), state

        wall, (ops, dev_ms, win_syncs, nccl_ms) = _window(make, WARM, WINDOW)
        out[form].update(window_wall_ms=wall * 1e3, device_ms=dev_ms,
                         device_ops=ops, syncs_a_scan=win_syncs,
                         nccl_ms=nccl_ms)
    if mesh is not None and mesh.map.size > 1:
        size = cfg.grid.fine_size
        block = torch.zeros((size // mesh.map.size, size), device=dev)
        out["field_gather_us"] = _graph_us(lambda: mesh.map.gather(block))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", nargs="+", default=["2x2", "1x4"],
                    help="particles x map meshes (default 2x2 1x4)")
    ap.add_argument("--scaling-scans", type=int, default=300,
                    help="scans of each scaling-report world (0: none)")
    ap.add_argument("--out", help="write every rank's numbers there "
                    "as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from lidar_slam_tpu_torch import _build
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import dataset
    from lidar_slam_tpu_torch.parallel import multihost

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load_kernels()   # built once here, not by every rank
    ranges, _ = dataset.ensure_dataset(n_scans=N_SCANS, seed=0)
    ok = True
    (ref,) = multihost.launch(1, [(pf_job, (ranges, None))], "cuda",
                              timeout_s=600.0)
    ref = ref[0]["run_pf"]
    ref_path = ref.pop("path")
    results = {"run_pf, 1 card": ref}

    def line(label, r):
        print(f"{label}: {r['scans_per_s']:.1f} scans/s (second run), "
              f"{r['run_syncs']} host syncs in the run; scans "
              f"{WARM + 1}-{WARM + WINDOW}: {r['window_wall_ms']:.3f} wall "
              f"ms a scan, {r['device_ms']:.3f} device ms a scan, "
              f"{r['device_ops']:.1f} device ops a scan, busy "
              f"{r['device_ms'] / r['window_wall_ms']:.1%}, "
              f"{r['syncs_a_scan']:.2f} host syncs a scan; NCCL kernels "
              f"{r['nccl_ms']:.3f} of the device ms, the rest "
              f"{r['device_ms'] - r['nccl_ms']:.3f}", flush=True)

    line("run_pf, 1 card", ref)
    for name in args.meshes:
        p, m = map(int, name.split("x"))
        ranks = multihost.launch(p * m, [(pf_job, (ranges, m))], "cuda",
                                 timeout_s=900.0)
        for rank, (r,) in enumerate(ranks):
            cap, eag = r["captured"], r["eager"]
            print(f"{name} mesh, rank {rank}: device ms a scan (NCCL "
                  f"kernels' share) captured {cap['device_ms']:.3f} "
                  f"({cap['nccl_ms']:.3f}), eager {eag['device_ms']:.3f} "
                  f"({eag['nccl_ms']:.3f}); the field's all-gather alone in "
                  f"a CUDA graph {r.get('field_gather_us', 0.0):.2f} us",
                  flush=True)
            for form, x in (("captured", cap), ("eager", eag)):
                if rank == 0:
                    line(f"{name} mesh, rank 0, {form}", x)
                path = x.pop("path")
                if not np.array_equal(path, ref_path):
                    ok = False
                    print(f"FAIL {name} rank {rank} {form}: path != run_pf's"
                          f", max {np.abs(path - ref_path).max()}")
            size = DEFAULT_CONFIG.grid.fine_size
            field = str(("all_gather", (size, size), 4))
            steps = N_SCANS - 1
            same = (cap["k1"] == eag["k1"] and cap["k2"] == eag["k2"]
                    and cap["particles"] == eag["particles"])
            by_design = (cap["map"] == {field: steps}
                         and list(eag["map"]) == [field]
                         and eag["map"][field] < steps) if m > 1 else (
                cap["map"] == eag["map"] == {})
            if not (same and by_design):
                ok = False
                print(f"FAIL {name} rank {rank}: K1 {cap['k1']} / "
                      f"{eag['k1']}, particles {cap['particles']} / "
                      f"{eag['particles']}, map {cap['map']} / "
                      f"{eag['map']} (captured / eager)")
            if rank == 0:
                print(f"{name} mesh: every form's K1 by shape {cap['k1']}, "
                      f"K2 {cap['k2']}; particles axis {cap['particles']} "
                      f"a run; map axis captured {cap['map']}, eager "
                      f"{eag['map']}", flush=True)
        results[name] = [r[0] for r in ranks]
    if args.scaling_scans:
        rep = multihost.scaling_report(ranges, N_PARTICLES, (1, 2, 4),
                                       args.scaling_scans, "cuda", 900.0)
        print(f"scaling_report, PF-{N_PARTICLES}, {args.scaling_scans} "
              f"scans, rank 0's scans/s by world (particles axis): "
              f"{rep.scans_per_s}, skipped {rep.skipped}", flush=True)
        results["scaling"] = rep.scans_per_s
    print(f"paths == run_pf's, launches and collectives as expected: {ok}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, default=lambda a: np.asarray(a).tolist())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
