#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``lidar_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and a CUDA
toolkit (``nvcc``). It builds both hand-written kernels from
``lidar_slam_tpu_torch/csrc/``, holds each against its plain PyTorch version
on the card, drives the port's main path (the fidelity pipeline and the
1024- and 10240-particle filters on the 1000-scan museum tour; fidelity
and graph SLAM with loop closure on the 700-scan loop and the 3800-scan
building tours; the particle-filter frontend with loop closure on both;
the scan-driven landmark EKF and the hybrid grid + landmark filter at 1024
particles, the submap atlas pipeline and the submap graph backend; the
parallel layer on an NCCL world of one) and checks the results:

1. card name and power limit (``nvidia-smi``); TF32 switched off; torch
   and CUDA versions and what records the CUDA graph conditional nodes
   (``utils/graphs.cond``: the port's C++, ``csrc/graph_cond.cu``);
2. kernel build (one nvcc a source, in parallel; sm_90a, --fmad=false) and
   the C++ oracle build (g++);
   2b. a CUDA graph WHILE node (``utils/graphs.while_loop``) in one graph
   replayed with device counts 16, 0, 3 and 0: its body runs that many
   times (none for 0) and ``fetch`` books the 19 iterations;
3. K1 clamped EDT == plain, exactly, on random grids and museum rasters;
4. K2 correlation volume == plain, exactly, on quantized EDT fields;
   4b. batched K2 == plain on real loop-tour keyframe rasters (B=8, T=21,
   half=14, 256^2), the closure-matching shape;
5. fidelity, museum-1000, through the captured driver (``run_scan``: the
   step as one CUDA graph whose branches are conditional nodes,
   ``utils/graphs.py``; no host sync after scan 1): trajectory
   bit-identical to the C++ oracle;
6. PF-1024, museum-1000, captured (``run_pf``): ATE < 0.15 m; then 100
   scans on the card and on the CPU with the same numpy-made draws, max
   |pose difference| <= 1e-3;
   6b. PF-10240, museum-1000 (bench.py's stage_pf10240), captured: ATE <
   0.15 m;
   6c. captured against eager on museum-1000: the eager loops (``slam_step``
   / ``pf_step`` a scan, seed 0) equal phases 5 and 6 (``np.array_equal``)
   with the same K1/K2 launches by shape; for each of the four drivers
   scans/s over the tour, and over scans 101-150 under the profiler and the
   sync debug mode device ops, device time and host syncs a scan and the
   busy share (the captured steps through ``advance``, no host read); the
   captured steps' graph count, pool bytes and capture seconds; the host
   syncs of a whole ``run_scan`` and ``run_pf`` (sync debug mode "warn"),
   equal on the first 200 scans and on the tour, and the tour's scans/s
   run again in the process;
7. K1 and K2 at every shape the main paths launch them with (K1 200^2,
   400^2, 256^2, 512^2, (8,256,256), (8,448,448), and the scan-odometry
   pre-pass's (50,448,448) and (49,448,448); K2 T=7 half=6 on 400^2,
   T=13 on 512^2, B=8 T=21 half=14 on 256^2, and the partial batches
   B = 1..7 of the batched shapes): each equal to its plain version; its
   device time (100 raw launches captured in a CUDA graph, one replay timed
   with CUDA events and divided by 100, the median of 5 replays; cross-
   checked by the kernel rows of a torch.profiler pass); the wrapper's time
   (back-to-back calls, host included) and the plain version's (plain,
   kernel, kernel, plain); the least time the card could take (bytes over
   3.35 TB/s or adds over 67 TFLOP/s) and the share of it reached; for K2
   one grouped conv2d computing the same sums (TF32 off) and whether it
   equals K2;
8. graph SLAM, loop-700, captured (``GraphSlam.run`` over
   ``scan_matcher.make_step_fn``, and its backend's keyframe rasters,
   closure matching, fine refinement and optimize as CUDA graphs; phases
   9, 10, 10b and 14 likewise, PF-graph's re-raster too): >= 1 closure,
   graph error per edge < 1, ATE < 0.1 m; the backend's graph count and
   pool bytes;
9. graph SLAM, building-3800 with BUILDING_WIDE_CONFIG: >= 5 closures,
   ATE < 0.2 m, pinned without frontend feedback; then the same tour with
   feedback, printed but not pinned: its chunk records (keyframe count
   and a full store, closures, the optimize's largest keyframe move, a
   feedback, graph error per edge) and the cause (the first scan at which
   the path leaves the tour by more than 50 m, the first optimize that
   moves a keyframe by more, the scan at which the keyframe store fills
   and the feedbacks and closures after it). The run loses the map on the
   card; the JAX package does the same from the card's state on the CPU;
   9b. fidelity, building-3800, captured: with BUILDING_CONFIG
   bit-identical to the C++ oracle and to the eager loop (the same K1
   launches by shape); with BUILDING_WIDE_CONFIG ATE < 0.5 m;
10. PF-graph, loop-700, 1024 particles: >= 1 closure, ATE < 0.15 m,
    smoothed-path ATE < ATE + 0.03 m;
    10b. PF-1024-graph, building-3800, BUILDING_CONFIG with closure
    feedback (bench.py's stage_building_pf): closures and ATE printed, not
    pinned (feedback is chaotic on this tour); K2's B=1 T=13 half=6 S=512
    launched (> 0);
11. EKF (``--mode ekf``), museum-1000, ``long_tour_config(1024)``,
    captured (``EkfStepFn``; phase 12's hybrid and 13's submap runs
    through ``HybridStepFn`` and ``submap_slam.make_step_fn``): the step
    object the run made holds one graph for every detection count, and its
    WHILE node's iterations equal the valid detection rows; ATE printed;
    100 scans on the card and on the CPU with the same numpy-made draws,
    max |pose difference| <= 1e-3; museum-400 with the config of
    ``tests/test_ekf_slam.py``'s museum test: ATE < 0.15 m;
12. hybrid EKF (``--mode ekf-hybrid``), museum-1000, ``long_tour_config
    (1024)``: one graph, its WHILE node's iterations == the valid rows of
    scans 2..T-1 (scan 1 is the eager seed step); ATE printed; 100 scans
    card against CPU, <= 1e-3; museum-500
    at 512 particles: ATE < 0.12 m and below the landmark-only filter's +
    0.02 m;
13. submap SLAM (``--mode submap``), museum-1000, ``DEFAULT_CONFIG``,
    through the captured step (one CUDA graph, the spawn a conditional
    node, the slot ints on the card; no host read after scan 1): 100
    scans card == CPU; ATE < max(2.5 x phase 5's fidelity ATE, 0.08 m);
    then the paged host loop through the captured step with
    ``tests/test_submap.py``'s paging config on the same tour: resident
    submaps <= the pool, pages out > 0, finite, and == the same loop with
    the eager ``slam_step`` (path, pages, slot ints, K1 launches by shape),
    scans/s of both;
14. submap graph SLAM (``--mode submap-graph``), loop-700: >= 1 closure,
    ATE < 0.1 m, graph error per edge < 1, >= 2 submaps all tied to a
    keyframe, map within the tour's extent + 30 m;
    14c. captured against eager: captured EKF-1024 and hybrid-EKF-1024 runs
    on the first 300 museum scans (one graph each, the WHILE node's
    iterations == the valid rows, graphs, pool bytes and capture seconds);
    each filter's pre-pass, then the filter from its inputs under the sync
    debug mode: at most one host sync (the final read) after the
    pre-pass; the pre-pass split into the detector, the batched
    ``read_scans`` and the matcher's chunk graphs, against the eager chunk
    loop (``read_scan`` a scan, ``match_batch`` a chunk): the same deltas
    (``torch.equal``) and K1 launches by shape, both timed; the eager
    loops (``GraphSlam(eager=True)``, frontend and backend eager;
    ``slam_step`` / ``ekf_slam_step_ml`` / ``hybrid_step`` a scan) equal
    phases 8, 9 (without feedback), 10, 13 and 14 and those filter runs
    (``np.array_equal``), with the same K1/K2 launches by
    shape; the graph runs' closures, attempt logs and keyframe poses equal
    too, and each backend stage's seconds and share of its run print
    eager against captured; graph loop-700 captured once more in the same
    process (its backend stages and capture time); for each of the five
    drivers and PF-1024-graph loop-700, eager and captured,
    scans/s over the run and, over scans 101-150 after 100 unprofiled,
    device ops, device time and host syncs a scan and the busy share (the
    graph runs profile that window from inside their chunk loop); the
    captured steps' graph count and pool bytes; the host syncs of a whole
    EKF and hybrid run and submap ``run_scan``, and those of the graph, PF-graph
    and submap-graph frontends' steps over a whole ``GraphSlam.run`` (sync
    debug mode "warn"), equal on the first 200 scans and on the tour, and
    the tour's scans/s run again;
15. streamed fidelity, museum-1000: a ``ScanServer`` on the tour, a
    ``RelayServer`` in front of it, ``run_streaming_slam`` on the card;
    the path bit-identical to ``run_host_loop`` on the card and to the C++
    oracle, both on the protocol-rounded ranges, 1000 requests relayed;
    prints scans/s and, with the prefetch queue full, the latency from a
    scan's arrival on the host to its pose on the host (p50/p99); then 300
    scans paced at the sensor's 10 Hz (the server holds row N until row 0's
    time + N x 0.1 s), the same path: the latency from a row's release to
    its pose on the host (p50/p99), the one a user waits; and host syncs a
    scan, counted in a 100-scan pass of their own;
16. supervised PF-1024, museum-1000: ``watchdog.run_supervised`` over a
    worker that runs ``watchdog.pf_worker`` and wedges its first attempt at
    scan 550 (checkpoints every 100 scans, 20 s stall timeout): 2 attempts,
    1 stall, the resumed path equal to phase 6's (the checkpoint carries
    the CUDA generator); the workers' launch counts join the kernels line;
17. landmark BA on the museum landmark tour (K = 512 pose slots, a 1536^2
    reduced system), TF32 off, captured (``optimize_ba``: one Gauss-Newton
    iteration a CUDA graph replay): == ``optimize_ba_eager`` bit for bit,
    card against CPU <= 1e-4 after 15 iterations, the error below 5% of
    its start; ms a Gauss-Newton iteration captured and eager, host syncs
    an iteration, and its largest device rows;
    17b. the robust pose graph on phase 8's graph plus one bad closure:
    two card runs equal, card against CPU <= 2e-6 (printed: how many pose
    values differ); the captured optimize (``posegraph.OptimizeFn``) ==
    the eager one, robust and not, and ms an optimize of each; its Huber
    chi on the same inputs (the graph's edges and 100000 random rows) card
    == CPU, and how many rows an f32 sqrt would change;
18. ``pf_stage_profile`` on the card (ms of each of the six stages);
    ``debug.validate_state`` empty for the final state of every main path
    (phases 5, 6, 8-17); ``debug.checked(slam_step)`` clean over 20 museum
    scans;
19-23. the parallel layer (``lidar_slam_tpu_torch/parallel``) on an NCCL
    world of one, made by ``multihost.initialize`` and destroyed at the
    end (one card: NCCL takes one rank a GPU; every collective still runs
    through the process group, and no multi-GPU run happens):
    19. the building 512^2 and museum 400^2 fine rasters as 2, 4 and 8 row
    blocks, K1 on each extended block (``edt_row_block``), == K1 on the
    whole grid, and the world-1 ``edt_sharded``/``edt_replicated`` too;
    each block shape timed as in phase 7;
    20. the sharded PF-1024, museum-1000, with the default keyframe
    field, with it as 4 row blocks and with ``edt_replicated`` over the
    map axis (``sharded_edt.ReplicatedField``: the refresh arm's IF node
    computes this rank's row block, the main graph all-gathers the field
    every scan, as on a map axis of 2 or more ranks): the captured
    step (what ``run_sharded_pf`` runs on every mesh shape: one CUDA graph
    with its collectives inside, none in the IF node, no host read after
    scan 1) == the eager step (``eager=True``) == phase 6's ``run_pf``,
    with the same K1/K2 launches by shape and the same collectives booked
    on the particles axis (the map axis: one all-gather of the field a
    scan captured, one a keyframe eager); scans/s and the whole run's host syncs of
    both, equal at 200 scans and on the tour; over scans 101-150 of each
    step device ops, device time, busy share and host syncs a scan; ms a
    step against ``run_pf`` in turns; a collective's host time called
    eagerly and its device time in a graph; the collectives' bytes a step
    (analytic at D = 1, 2, 4);
    21. the sharded EKF-1024 bank (``long_tour_config(1024)``), 300 museum
    scans: the captured step (one graph, its collectives in the main
    graph, the association loop a WHILE node) == the eager sharded run ==
    the unsharded ``run_ml``, path and every bank; one host read after
    the pre-pass; ms a step and the steady window of both;
    22. the matrix-free sharded BA on phase 17's K = 512 problem: the
    captured solve (three graphs: an iteration's prologue, a PCG step
    replayed 50 times, its update) == the eager ``_solve`` bit for bit
    with the same collectives; card vs CPU <= 1e-4, the error below 5% of
    its start, its difference from the dense solve printed; ms a GN
    iteration captured, eager and the dense ``optimize_ba``, host syncs
    (none), where the device time goes, and the largest tensors it makes,
    none (K, K) or (L, K);
    23. ``dryrun_multichip(1)`` and ``scaling_report(world_sizes=(1, 2,
    4))`` (a spawned world of 1 timing the captured step; 2 and 4
    skipped: 1 GPU).

Phases 6c and 14c profile a steady window of each driver: device ops a
scan and the device busy share (``torch.profiler`` device rows: kernels,
copies, memsets; the share is their time a scan over the unprofiled run's
wall time a scan) and host syncs a scan
(``torch.cuda.set_sync_debug_mode("warn")`` warnings).

Any failed check exits non-zero. The launch counters (a total and a count
by shape for each kernel) are zeroed right before each main-path run
(phases 5, 6, 6b, 8-15, 14c's captured filter runs, 20, 21, 23) and read
right after it, so they count
only the main paths (phase 16's workers count in their own processes and
write their counts to the run directory; phase 23's spawned rank counts in
its own process and is not summed); each run prints its counts by shape
and its scans/s, and the kernels line sums them. Every phase prints its
seconds. The second-to-last line is a JSON object with one entry per
kernel; the last line is the run's result JSON. Without a card, or outside
a checkout, it fails before printing either.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

K1_SOURCE = "lidar_slam_tpu_torch/csrc/edt.cu"
K2_SOURCE = "lidar_slam_tpu_torch/csrc/corr_volume.cu"
K1_REPLACES = "lidar_slam_tpu/ops/pallas_edt.py:119"
K2_REPLACES = "lidar_slam_tpu/ops/pallas_match.py:120"
# substrings of the kernels' names in a profiler trace
K1_KERNEL = "edt_"
K2_KERNEL = "corr_volume"

PF_ATE_MAX = 0.15          # m, the pin of tests/test_fastslam.py
CPU_CUDA_MAX_DIFF = 1e-3   # max |pose difference|, injected draws
GRAPH_LOOP_ATE_MAX = 0.1   # m, the pins of tests/test_graph_slam.py
GRAPH_BUILDING_ATE_MAX = 0.2     # m, bench.py stage_building_graph's target
GRAPH_BUILDING_MIN_CLOSURES = 5  # tests/test_graph_slam.py, corridor test
LOST_M = 50.0   # m: phase 9's feedback run has lost the map past this error
BUILDING_WIDE_ATE_MAX = 0.5      # m, tests/test_pipeline_parity.py
PF_GRAPH_SMOOTH_MARGIN = 0.03    # m, tests/test_pf_graph_slam.py
EKF_MUSEUM400_ATE_MAX = 0.15     # m, tests/test_ekf_slam.py museum test
HYBRID_MUSEUM500_ATE_MAX = 0.12  # m, tests/test_ekf_hybrid.py
HYBRID_OVER_LANDMARK_MARGIN = 0.02  # m, the same test
SUBMAP_ATE_FACTOR, SUBMAP_ATE_FLOOR = 2.5, 0.08  # tests/test_submap.py
PROFILE_SCANS = 100        # scans of each new path run under the profiler
STEADY_SCANS = 50          # phases 6c, 14c: scans profiled after
#                            PROFILE_SCANS
SYNC_SCANS = 200           # phases 6c, 14c: the short run whose host
#                            syncs must equal the whole tour's
FILTER_SCANS = 300         # phase 14c: museum scans of the EKF and hybrid
#                            comparisons
STREAM_PACE_S = 0.1       # phase 15: the sensor's 10 Hz
STREAM_PACED_SCANS = 300   # scans of the paced stream (30 s)
STREAM_SYNC_SCANS = 100    # scans of the stream that counts host syncs
SUP_WEDGE_AT = 550        # phase 16: the scan the first attempt wedges at
SUP_CKPT_EVERY = 100       # scans between the supervised run's checkpoints
SUP_STALL_S = 20.0         # s without a heartbeat before the kill
SUP_BOOT_GRACE_S = 300.0   # s a spawned child may take to its first beat
BA_ITERS = 15              # GN iterations, as tests/test_ba.py
BA_CPU_CUDA_MAX = 1e-4     # max |pose or landmark difference|, card vs CPU
BA_CG_ITERS = 50           # phase 22's PCG steps a GN iteration (on the
#                            CPU 50, 100 and 200 give the same error to 4
#                            digits)
TURN_SCANS = 300           # phase 20: scans of each plain/sharded turn
#                            (each run captures its step)
BA_ERROR_RATIO = 0.05      # tests/test_ba.py: error below 5% of its start
PG_CPU_CUDA_MAX = 2e-6     # robust pose graph, card vs CPU (9.54e-7 read)
CHI_ROWS = 100000          # random rows of the Huber chi check
# GraphSlam.timer's stages of the graph backend (14c prints them)
BACKEND_STAGES = ("kf_raster_edt", "closure_match", "optimize", "feedback")


def _serve_chain(ranges, conn) -> None:
    """Phase 15's data plane, in a spawned process: a ``ScanServer`` on the
    tour and a ``RelayServer`` in front of it (the reference's server and
    relay). Sends the relay's URL on ``conn``, then answers every message
    with (requests relayed so far, host clock when row 0 was last served).
    A float message sets the pace: row N is held until that many seconds
    times N after row 0, as a sensor at 1 / pace Hz makes it (0 serves at
    once). "stop" stops both servers."""
    from urllib.parse import parse_qs, urlparse

    from lidar_slam_tpu_torch.io import server

    srv = server.ScanServer(ranges)
    clock = {"t0": 0.0, "pace": 0.0}
    handler = srv._httpd.RequestHandlerClass
    serve_row = handler.do_GET

    def paced(self):
        try:
            n = int(parse_qs(urlparse(self.path).query)["param"][0])
        except (KeyError, ValueError):
            n = -1
        if n == 0:
            clock["t0"] = time.perf_counter()
        elif n > 0:
            time.sleep(max(0.0, clock["t0"] + n * clock["pace"]
                           - time.perf_counter()))
        serve_row(self)

    handler.do_GET = paced
    srv.start()
    relay = server.RelayServer(srv.url).start()
    try:
        conn.send(relay.url)
        while True:
            msg = conn.recv()
            if isinstance(msg, float):
                clock["pace"] = msg
            conn.send((relay.n_relayed, clock["t0"]))
            if msg == "stop":
                return
    finally:
        relay.stop()
        srv.stop()


def _wedging_pf_worker(run_dir, ranges, cfg, seed, ckpt_every, device,
                       wedge_at):
    """Phase 16's worker: the port's ``watchdog.pf_worker``, whose first
    attempt wedges (sleeps with the heartbeat silent) before scan
    ``wedge_at``, as ``tests/test_watchdog.py`` injects its hang. Each
    attempt writes its kernel launch counts by shape to
    ``launches_<attempt>.json`` in the run directory (the first just before
    it wedges). Module-level, so a spawned child can import it."""
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
    from lidar_slam_tpu_torch.utils import watchdog

    attempt = 1 + sum(f.startswith("attempt_") for f in os.listdir(run_dir))
    open(os.path.join(run_dir, f"attempt_{attempt}"), "w").close()

    def dump_counts():
        with open(os.path.join(run_dir, f"launches_{attempt}.json"), "w") as f:
            json.dump({key: [[list(k), v] for k, v in
                             mod.launches_by_shape.items()]
                       for key, mod in (("K1", cuda_edt), ("K2", cuda_match))},
                      f)

    if attempt == 1:
        step = fastslam.pf_step

        def wedging(state, *args, **kwargs):
            if state.step == wedge_at:
                dump_counts()
                time.sleep(3600)   # the injected wedge
            return step(state, *args, **kwargs)

        fastslam.pf_step = wedging
    watchdog.pf_worker(run_dir, ranges, cfg, seed, ckpt_every, device)
    dump_counts()


def eager_fidelity(ranges, cfg, dev):
    """The eager fidelity loop, ``slam_step`` a scan with the pose brought
    to the host by the keyframe test's copy (the host loop before the
    captured drivers): (path (T, 3) numpy, final state)."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.models import scan_matcher

    r = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = scan_matcher.init_state(r[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, len(r)):
        state, pose = scan_matcher.slam_step(state, r[t], cfg, angles,
                                             pose_to_host=True)
        poses.append(pose)
    return np.stack(poses), state


def eager_pf(ranges, cfg, seed, dev):
    """The eager particle-filter loop, ``pf_step`` a scan with the poses
    kept on the device (``run_pf`` before the captured drivers): (path
    (T, 3) on the card, final state)."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.models import fastslam, scan_matcher

    r = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = fastslam.init_particles(r[0], cfg, seed)
    poses = [torch.zeros(3, device=dev)]
    for t in range(1, len(r)):
        state, pose = fastslam.pf_step(state, r[t], cfg, angles)
        poses.append(pose)
    return torch.stack(poses), state


def eager_submap(ranges, cfg, dev):
    """The eager submap loop, ``slam_step`` a scan with the poses kept on
    the device (``run_scan`` before the captured step): (path (T, 3)
    numpy, final state)."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.models import scan_matcher, submap_slam

    r = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = submap_slam.init_state(r[0], cfg)
    poses = [state.pose]
    for t in range(1, len(r)):
        state, pose = submap_slam.slam_step(state, r[t], cfg, angles)
        poses.append(pose)
    return torch.stack(poses).cpu().numpy(), state


def eager_paged(ranges, cfg, paged, manage_every, dev):
    """``utils/paging.run_host_loop_paged`` with the eager ``slam_step`` a
    scan in place of the captured step (the paged loop before the captured
    step): (path (T, 3) numpy, final state)."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.models import scan_matcher, submap_slam

    r = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = submap_slam.init_state(r[0], cfg)
    poses = [np.zeros(3, np.float32)]
    for t in range(1, len(r)):
        state, pose = submap_slam.slam_step(state, r[t], cfg, angles)
        poses.append(pose.cpu().numpy())
        if t % manage_every == 0:
            new_atlas = paged.manage(state.atlas, poses[-1])
            if new_atlas is not state.atlas:
                state = state._replace(atlas=new_atlas)
    return np.stack(poses), state


def eager_ekf(ranges, ecfg, cfg, dev):
    """The eager scan-driven EKF (``run_ekf_slam_scan``'s pre-pass, then
    ``ekf_slam_step_ml`` a scan given its detection count, seed 0): (path
    (T, 3) numpy, final state)."""
    import torch

    from lidar_slam_tpu_torch.models import ekf_slam

    obs, valid, odo, counts = ekf_slam.scan_inputs(
        ranges, ecfg, cfg.lidar, ekf_slam.LONG_TOUR_MAX_RANGE, device=dev)
    state = ekf_slam.init_ekf_slam(ecfg, 0, dev)
    poses = [torch.zeros(3, device=dev)]
    for t, n_det in enumerate(counts.tolist()):
        state, est = ekf_slam.ekf_slam_step_ml(
            state, obs[t], valid[t], ecfg, odo=odo[t], n_det=n_det)
        poses.append(est)
    return torch.stack(poses).cpu().numpy(), state


def eager_hybrid(ranges, ecfg, cfg, dev):
    """The eager hybrid loop (``run_ekf_hybrid``'s pre-pass, then
    ``hybrid_step`` a scan given its detection count, seed 0): (path
    (T, 3) numpy, final state)."""
    import torch

    from lidar_slam_tpu_torch.models import ekf_hybrid, scan_matcher

    r, det, odo, _ = ekf_hybrid.hybrid_inputs(ranges, cfg, device=dev)
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = ekf_hybrid.init_hybrid(r[0], ecfg, cfg, 0)
    poses = [torch.zeros(3, device=dev)]
    counts = det.count.tolist()
    for t in range(1, len(r)):
        state, est = ekf_hybrid.hybrid_step(
            state, r[t], det.rb[t], det.valid[t], odo[t - 1], ecfg, cfg,
            angles, n_det=counts[t])
        poses.append(est)
    return torch.stack(poses).cpu().numpy(), state


def eager_pairwise(r, angles, lidar_cfg):
    """``pairwise_odometry`` as an eager loop, its form before the batched
    read and the chunk graphs: ``read_scan`` a scan, then ``match_batch`` a
    chunk of 50 pairs with the pre-pass's settings. Returns (the deltas,
    the seconds of the reads, of the chunks)."""
    import torch

    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.ops import scan_odometry

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scans = [sensor.read_scan(x, angles, lidar_cfg) for x in r]
    x, y, v = (torch.stack([getattr(sc, f) for sc in scans])
               for f in ("x", "y", "valid"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for a in range(0, r.shape[0] - 1, 50):
        b = min(a + 50, r.shape[0] - 1)
        out.append(scan_odometry.match_batch(
            x[a:b], y[a:b], v[a:b], x[a + 1:b + 1], y[a + 1:b + 1],
            v[a + 1:b + 1], torch.zeros((b - a, 3), device=r.device),
            max_range=10.0, pixel=0.05, size=448, iters=7, step_t0=0.03,
            step_r0=0.03))
    out = torch.cat(out)
    torch.cuda.synchronize()
    return out, t1 - t0, time.perf_counter() - t1


class StepsMade:
    """Inside ``with``, every object made of ``module``'s class ``name``
    (the step object a driver makes for itself, as ``run_ml`` makes its
    ``EkfStepFn``) is kept in ``made``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.made = module, name, []

    def __enter__(self):
        cls, made = getattr(self.module, self.name), self.made

        class Kept(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                made.append(self)

        self._cls = cls
        setattr(self.module, self.name, Kept)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._cls)
        return False


def loop_iterations(runner) -> int:
    """The iterations the WHILE bodies of a ``Graphs`` ran, as its last
    ``fetch`` booked them."""
    return sum(a.settled for a in runner.arms if a.kind == "while")


class ProfileWindow:
    """``torch.profiler`` (device activity only: recording every CPU op of
    a 1000-launch scan would double its time) and the sync debug mode
    "warn" from ``start()`` to ``stop(n)``, which returns (device ops a
    scan, device ms a scan, host syncs a scan) over the n scans run in
    between. Device ops and time: the profiler's rows with device time
    (kernels, copies, memsets); syncs: the mode's warnings."""

    def start(self) -> None:
        import warnings

        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._warnings = warnings.catch_warnings(record=True)
        self._caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self, n: int) -> tuple[float, float, float]:
        import torch

        try:
            torch.cuda.synchronize()
            self._prof.stop()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            self._warnings.__exit__(None, None, None)
        syncs = sum("synchroniz" in str(w.message) for w in self._caught)
        dev_us, n_ops = 0.0, 0
        for ev in self._prof.key_averages():
            t_dev = getattr(ev, "self_device_time_total", None)
            if t_dev is None:
                t_dev = ev.self_cuda_time_total
            if t_dev > 0:
                dev_us += t_dev
                n_ops += ev.count
        return n_ops / n, dev_us / n / 1e3, syncs / n


def profiled(run, n: int) -> tuple[float, float, float]:
    """``run()`` (n scans) in a ``ProfileWindow``: (device ops a scan,
    device ms a scan, host syncs a scan)."""
    window = ProfileWindow()
    window.start()
    try:
        run()
    finally:
        numbers = window.stop(n)
    return numbers


def report(tag, label, numbers, wall_per_scan, steady_wall):
    """Prints a steady window's ops, device time, busy share and syncs
    beside the unprofiled wall time a scan, over the whole run and over
    the same window run unprofiled."""
    ops, dev_ms, syncs = numbers
    print(f"[{tag}] {label}: {1 / wall_per_scan:.1f} scans/s; scans "
          f"{PROFILE_SCANS + 1}-{PROFILE_SCANS + STEADY_SCANS}: "
          f"{steady_wall * 1e3:.3f} ms a scan unprofiled (host clock), "
          f"and under the profiler {ops:.1f} device ops a scan, device "
          f"time {dev_ms:.3f} ms a scan, busy share "
          f"{dev_ms / 1e3 / steady_wall:.1%} of those scans' unprofiled "
          f"time and {dev_ms / 1e3 / wall_per_scan:.1%} of the run's "
          f"{wall_per_scan * 1e3:.3f} ms a scan; host syncs "
          f"{syncs:.2f} a scan", flush=True)


def steady(tag, label, make, wall_per_scan):
    """Two fresh runs of scans 1..PROFILE_SCANS + STEADY_SCANS
    (``make() -> (step, state)``; ``step(state, t) -> (state, pose)``
    runs scan t; the captures happen in the first PROFILE_SCANS): the
    first times its last STEADY_SCANS unprofiled on the host clock, the
    second profiles them (``report``). Returns the second run's
    step."""
    import torch

    numbers = wall = None
    for profile in (False, True):
        step, state = make()
        for t in range(1, PROFILE_SCANS + 1):
            state, _ = step(state, t)

        def window():
            nonlocal state
            for t in range(PROFILE_SCANS + 1,
                           PROFILE_SCANS + STEADY_SCANS + 1):
                state, _ = step(state, t)  # noqa: B023

        if profile:
            numbers = profiled(window, STEADY_SCANS)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / STEADY_SCANS
    report(tag, label, numbers, wall_per_scan, wall)
    return step


class WindowedFrontend:
    """A ``GraphSlam`` frontend (``GraphSlam.frontend``) that counts the
    run's scans and measures scans ``first`` .. ``first + n - 1`` from
    inside the chunk loop: under a ``ProfileWindow`` with ``profile``,
    else on the host clock, unprofiled. The scans before them run
    unprofiled, and the captures happen there. ``result`` holds the
    window's numbers once the run has passed it (the profile's, or the
    wall seconds a scan); ``step`` is the captured step object the run made
    (None for an eager run)."""

    def __init__(self, frontend, first: int, n: int, profile: bool):
        self.frontend, self.first, self.n = frontend, first, n
        self.profile = profile
        self.t, self.result, self.step = 0, None, None
        self.window = ProfileWindow()

    def counted(self, step, *args):
        """``step(*args)`` as scan ``t``: the window opens before scan
        ``first`` and closes after scan ``first + n - 1``."""
        import torch

        self.t += 1
        if self.t == self.first:
            if self.profile:
                self.window.start()
            else:
                torch.cuda.synchronize()
                self._t0 = time.perf_counter()
        out = step(*args)
        if self.t == self.first + self.n - 1:
            if self.profile:
                self.result = self.window.stop(self.n)
            else:
                torch.cuda.synchronize()
                self.result = (time.perf_counter() - self._t0) / self.n
        return out

    def init_state(self, ranges0, cfg):
        return self.frontend.init_state(ranges0, cfg)

    def slam_step(self, state, ranges, cfg, angles):
        return self.counted(self.frontend.slam_step, state, ranges, cfg,
                            angles)

    def make_step_fn(self, cfg, device):
        self.step = self.frontend.make_step_fn(cfg, device)
        return _CountedStep(self)


class ByScan:
    """A captured step object driven by scan index: ``step(state, t)``
    calls ``obj(state, *inputs(t))`` (the pose read on the host), or with
    ``advance`` ``obj.advance(state, *inputs(t))`` (nothing read; the pose
    is None); ``graphs`` is the object's."""

    def __init__(self, obj, inputs, advance: bool = False):
        self.obj, self.inputs, self.advance = obj, inputs, advance

    def __call__(self, state, t: int):
        if self.advance:
            return self.obj.advance(state, *self.inputs(t)), None
        return self.obj(state, *self.inputs(t))

    @property
    def graphs(self):
        return self.obj.graphs


class SyncCount:
    """The sync debug mode "warn" inside ``with``: ``count()`` is the host
    syncs so far (the mode's warnings)."""

    def __enter__(self):
        import warnings

        import torch

        torch.cuda.synchronize()
        self._warnings = warnings.catch_warnings(record=True)
        self._caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        self._warnings.__exit__(*exc)
        return False

    def count(self) -> int:
        return sum("synchroniz" in str(w.message) for w in self._caught)

    def where(self, since: int = 0) -> list[str]:
        """file:line of each host sync after the first ``since``."""
        syncs = [w for w in self._caught if "synchroniz" in str(w.message)]
        return [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                for w in syncs[since:]]


class StepSyncs:
    """A ``GraphSlam`` frontend whose captured step counts the host syncs
    its calls make inside a ``SyncCount`` (``syncs``), the chunk loop's
    own fetches and the backend's left out."""

    def __init__(self, frontend, sync_count: SyncCount):
        self.frontend, self.sync_count = frontend, sync_count
        self.syncs, self.step = 0, None

    def counted(self, step, *args):
        before = self.sync_count.count()
        out = step(*args)
        self.syncs += self.sync_count.count() - before
        return out

    def init_state(self, ranges0, cfg):
        return self.frontend.init_state(ranges0, cfg)

    def make_step_fn(self, cfg, device):
        self.step = self.frontend.make_step_fn(cfg, device)
        return _CountedStep(self)


class _CountedStep:
    """The captured step of a ``WindowedFrontend`` (or ``StepSyncs``),
    counted a call."""

    def __init__(self, frontend):
        self.frontend = frontend

    def advance(self, state, ranges):
        return self.frontend.counted(self.frontend.step.advance, state,
                                     ranges)

    def __getattr__(self, name):   # pose, scan, graphs
        return getattr(self.frontend.step, name)


def feedback_report(gs, gt) -> None:
    """Phase 9's feedback run, chunk by chunk (``GraphSlam.chunk_log``):
    the keyframe store's count and saturation, closures, the optimize's
    largest keyframe move and the graph error per edge, whether a feedback
    ran; then the cause: the first scan at which the path leaves the tour
    by more than ``LOST_M``, the first optimize that moved a keyframe by
    more than that, the scan at which the store filled, and the feedbacks
    and closures after it."""
    import numpy as np

    for r in gs.chunk_log:
        full = r.keyframes >= gs.max_keyframes
        print(f"[9]   chunk@{r.first_scan}: keyframes {r.keyframes}"
              f"{' (store full)' if full else ''}, made {r.made}, closures "
              f"{r.closures} (weak {r.weak}), delta "
              f"{'-' if r.delta is None else f'{r.delta:.6f} m'}, feedback "
              f"{int(r.feedback)}, graph error per edge "
              f"{'-' if r.error_per_edge is None else f'{r.error_per_edge:.6f}'}",
              flush=True)
    path = gs._last_path
    err = np.hypot(*(path[:, :2] - gt[:, :2]).T)
    lost = int(np.argmax(err > LOST_M)) if (err > LOST_M).any() else None
    jump = next((r for r in gs.chunk_log
                 if r.delta is not None and r.delta > LOST_M), None)
    sat = gs.saturated_at
    # the chunk the store filled in (its feedback comes after the fill) and
    # every later one
    after = [r for r in gs.chunk_log if r.keyframes >= gs.max_keyframes]
    print(f"[9] the feedback run's cause: the path first leaves the tour by "
          f"more than {LOST_M:.0f} m at scan {lost}; the first optimize to "
          f"move a keyframe by more than that: "
          + ("none" if jump is None else
             f"chunk@{jump.first_scan} ({jump.closures} closures, delta "
             f"{jump.delta:.6f} m, feedback {int(jump.feedback)})")
          + f"; the keyframe store ({gs.max_keyframes}) filled at scan "
          f"{sat}, and after it {sum(r.feedback for r in after)} feedbacks "
          f"and {sum(r.closures + r.weak for r in after)} closures; largest "
          f"error {err.max():.4f} m", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ate(est, ref) -> float:
    """RMSE of the xy trajectory error (the ATE the CLIs print)."""
    import numpy as np

    d = np.asarray(est, np.float64)[:, :2] - np.asarray(ref, np.float64)[:, :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


_PHASE_START = [time.perf_counter()]


def phase_done(tag: str) -> None:
    """Print the seconds since the previous phase ended."""
    now = time.perf_counter()
    print(f"[{tag}] phase time {now - _PHASE_START[0]:.1f} s", flush=True)
    _PHASE_START[0] = now


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls, by CUDA
    events. Where the host enqueues more slowly than the card runs, this
    is the host's time per call (the "wrapper" time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


GRAPH_LAUNCHES = 100   # raw launches captured in one CUDA graph
GRAPH_REPLAYS = 5      # timed replays; the median is kept


def graph_time_ms(launch) -> float:
    """Device time of one raw launch: ``GRAPH_LAUNCHES`` launches captured
    in a CUDA graph, one replay timed with CUDA events and divided by the
    count; the median of ``GRAPH_REPLAYS`` replays. The host does no work
    between the launches, so this is the card's time, not the enqueue's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(GRAPH_REPLAYS):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / GRAPH_LAUNCHES)
    del graph
    return sorted(times)[GRAPH_REPLAYS // 2]


def profiler_kernel_ms(launch, name: str, iters: int = 50):
    """Mean device time of the kernel rows whose name holds ``name`` over
    ``iters`` raw launches under ``torch.profiler`` (the cross-check of
    ``graph_time_ms``; a launcher's memset is not in these rows). None when
    the profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = ev.self_cuda_time_total
            total += t
            count += ev.count
    return total / count / 1e3 if count else None


# H100 SXM peaks (NVIDIA's data sheet) for the least-time bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def device_rows(fn, per: int) -> str:
    """``fn()``'s device time under the profiler (its device rows) over
    ``per``, and its six largest rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t_dev = getattr(ev, "self_device_time_total", None)
        if t_dev is None:
            t_dev = ev.self_cuda_time_total
        if t_dev > 0:
            rows.append((t_dev, ev.count, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3 / per
    return (f"{dev_ms:.3f} ms (profiler device rows); largest: " + "; ".join(
        f"{k[:60]} {t / 1e3 / per:.3f} ms x{n // per}"
        for t, n, k in rows[:6]))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv2d_yardstick(metric, cx0, cy0, valid, n_rows, n_cols, half):
    """K2's function as one grouped ``conv2d``, the TPU kernel's own body
    (sum of beam histogram x masked field). The field, masked by the
    reference bounds test, is padded by 2*half; the weight counts the valid
    beams of each bin at base cell + half, over (S + 2*half)^2, so every
    beam that can reach the grid is counted. Returns (inputs, call): the
    inputs are built here, outside any timed window."""
    import torch
    import torch.nn.functional as F

    lead = metric.shape[:-2]
    b = lead[0] if lead else 1
    s = metric.shape[-1]
    h = half
    m = metric.reshape(b, s, s)
    cx = cx0.reshape(b, -1, cx0.shape[-1]).long()
    cy = cy0.reshape(b, -1, cy0.shape[-1]).long()
    v = valid.reshape(b, 1, -1).expand(cx.shape)
    t_bins = cx.shape[1]
    idx = torch.arange(s, device=metric.device)
    ok_r = (idx >= 1) & (idx < n_rows - 1)
    ok_c = (idx >= 1) & (idx < n_cols - 1)
    masked = torch.where(ok_r[:, None] & ok_c[None, :], m, 0.0)
    inp = F.pad(masked[None], (2 * h, 2 * h, 2 * h, 2 * h))
    side = s + 2 * h
    r, c = cy + h, cx + h
    keep = v & (r >= 0) & (r < side) & (c >= 0) & (c < side)
    plane = (torch.arange(b * t_bins, device=metric.device)
             .view(b, t_bins, 1).expand(cx.shape))
    flat = (plane * side + r) * side + c
    hist = torch.zeros(b * t_bins * side * side, dtype=torch.float32,
                       device=metric.device)
    hist.index_add_(0, flat[keep], torch.ones_like(flat[keep],
                                                   dtype=torch.float32))
    weight = hist.view(b * t_bins, 1, side, side)
    w = 2 * h + 1

    def call():
        return F.conv2d(inp, weight, groups=b).view(lead + (t_bins, w, w))
    return call


def k1_shape_row(label, occ, cross_check: bool = True) -> tuple[dict, float]:
    """Phase 7's row for K1 at one shape: equal to its plain version; its
    device time (a CUDA graph of raw launches), the profiler's kernel row
    (``cross_check``), the wrapper's and the plain version's times (plain,
    kernel, kernel, plain) and the bound. Returns (row, max_abs_err)."""
    import torch

    from lidar_slam_tpu_torch.ops import cuda_edt
    from lidar_slam_tpu_torch.ops import edt as edt_ops

    occ3 = occ.contiguous().view((-1,) + tuple(occ.shape[-2:]))
    out = torch.empty(occ3.shape, dtype=torch.float32, device=occ.device)
    got = cuda_edt.edt_clamped_cuda(occ3)
    want = edt_ops.edt_clamped(occ3)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"K1 differs from plain at {label}")
    err = (got - want).abs().max().item()
    raw = lambda: cuda_edt.launch(occ3, out, 10)  # noqa: E731
    device_ms = graph_time_ms(raw)
    require(torch.equal(out, want), f"raw K1 differs at {label}")
    prof_ms = profiler_kernel_ms(raw, K1_KERNEL) if cross_check else None
    wrap = lambda: cuda_edt.edt_clamped_cuda(occ3)  # noqa: E731
    plain = lambda: edt_ops.edt_clamped(occ3)  # noqa: E731
    p1, w1, w2, p2 = (cuda_time_ms(f, iters=50, warmup=5)
                      for f in (plain, wrap, wrap, plain))
    bnd, by = bound_ms(occ3.numel() * (1 + 4), 0)
    tag = 7 if cross_check else 19
    print(f"[{tag}] K1 {label}: device {device_ms * 1e3:.2f} us (CUDA graph "
          f"of {GRAPH_LAUNCHES}; profiler kernel row "
          f"{'n/a' if prof_ms is None else f'{prof_ms * 1e3:.2f}'} us); "
          f"wrapper {w1 * 1e3:.1f} / {w2 * 1e3:.1f} us; plain "
          f"{p1 * 1e3:.1f} / {p2 * 1e3:.1f} us; bound {bnd * 1e3:.3f} us "
          f"({by}), {bnd / device_ms:.1%} of it reached; library: none",
          flush=True)
    return ({"shape": label, "key": tuple(occ3.shape),
             "device_ms": device_ms, "profiler_ms": prof_ms,
             "wrapper_ms": min(w1, w2), "plain_ms": min(p1, p2),
             "bound_ms": bnd, "bound_by": by, "library_ms": None}, err)


def parallel_phases(ctx) -> None:
    """Phases 19-23: the parallel layer on an NCCL world of one (one card:
    NCCL takes one rank a GPU, so every collective runs through the group
    on one rank; no multi-GPU run happens here). ``ctx`` carries the
    earlier phases' inputs, results and launch books; the new K1 shapes
    join phase 7's table and each run's launches the kernels line."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.models import ba, ekf_slam, fastslam
    from lidar_slam_tpu_torch.utils import debug
    from lidar_slam_tpu_torch.ops import cuda_edt
    from lidar_slam_tpu_torch.ops import edt as edt_ops
    from lidar_slam_tpu_torch.parallel import (dryrun, multihost, sharded,
                                               sharded_ba, sharded_edt,
                                               sharded_ekf)
    from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
    from lidar_slam_tpu_torch.utils.profiling import tensor_shapes

    dev = ctx.dev
    known_states = set(ctx.final_states)
    rank, world = multihost.initialize(device_type="cuda")
    require((rank, world) == (0, 1), f"world {world}, rank {rank}")
    print(f"[19] process group: world of {world}, backend "
          f"{mesh_lib.backend_for('cuda')} (NCCL for CUDA tensors)",
          flush=True)

    def add_launches(used):
        for k in used:
            ctx.launches[k] += used[k]

    # ---- 19. the row-block EDT, K1 on every block
    axis = mesh_lib.make_axis("map", "cuda")
    for name, occ in (("building 512^2", ctx.building_occ),
                      ("museum 400^2", ctx.fine_occ)):
        occ = occ.contiguous()
        whole = cuda_edt.edt_clamped_cuda(occ)
        require(torch.equal(whole, edt_ops.edt_clamped(occ)),
                f"K1 differs from plain on the {name} raster")
        size, width = occ.shape
        for d in (2, 4, 8):
            blocks = sharded_edt.extended_blocks(occ, d)
            got = torch.cat([sharded_edt.edt_row_block(b) for b in blocks])
            require(torch.equal(got, whole),
                    f"{d} row blocks of the {name} raster differ from K1 on "
                    f"the whole grid")
            row, err = k1_shape_row(f"(1,{size // d + 20},{width}) {name} "
                                    f"in {d} row blocks", blocks[d // 2],
                                    cross_check=False)
            ctx.k1_err = max(ctx.k1_err, err)
            ctx.shape_rows["K1"].append(row)
            ctx.device_by_shape["K1"][row["key"]] = row["device_ms"]
        exch = sharded_edt.edt_sharded(occ, axis)
        rep = sharded_edt.edt_replicated(occ, axis)
        require(torch.equal(exch, whole) and torch.equal(rep, whole),
                f"the NCCL world-1 edt_sharded differs on the {name} raster")
        # the world of one's block: the whole grid and its halo rows
        row, err = k1_shape_row(f"(1,{size + 20},{width}) {name} and its "
                                f"halo (edt_sharded, world of 1)",
                                sharded_edt.extended_blocks(occ, 1)[0],
                                cross_check=False)
        ctx.k1_err = max(ctx.k1_err, err)
        ctx.shape_rows["K1"].append(row)
        ctx.device_by_shape["K1"][row["key"]] = row["device_ms"]
        print(f"[19] {name} fine raster: 2, 4 and 8 row blocks, K1 on each "
              f"(edt_row_block), == K1 on the whole grid == plain "
              f"(torch.equal); edt_sharded and edt_replicated on the NCCL "
              f"world of 1 (edge-row all-gather, K1 on the "
              f"({size + 20},{width}) block) == too", flush=True)
    phase_done("19")

    # ---- 20. the sharded PF-1024, museum-1000, on the world of one: the
    # captured step (what run_sharded_pf runs) against the eager one, with
    # each keyframe field, each == phase 6's run_pf
    mesh = mesh_lib.make_mesh(device_type="cuda")
    steps = len(ctx.ranges) - 1
    edts = {"default EDT": None,
            "4-block EDT": lambda o, r: sharded_edt.edt_blocks(o, 4, r),
            "edt_replicated over the map axis":
                sharded_edt.ReplicatedField(mesh.map)}
    print(f"[20] the form run_sharded_pf runs on this {mesh.particles.size}"
          f"x{mesh.map.size} mesh, as on every mesh shape: captured, with no "
          f"collective inside the IF node (on a map axis, the refresh arm "
          f"computes this rank's row block of the field and the main graph "
          f"all-gathers it every scan)", flush=True)

    def pf_run(ranges, edt_fn=None, eager=False):
        """A sharded run, its path read: (path, state, seconds, the whole
        run's host syncs, where the first four were made)."""
        with SyncCount() as sc:
            t0 = time.perf_counter()
            path, state = sharded.run_sharded_pf(
                ranges, ctx.pcfg, mesh, seed=0, edt_fn=edt_fn, eager=eager)
            path = path.cpu().numpy()
            return (path, state, time.perf_counter() - t0, sc.count(),
                    sc.where()[:4])

    runs = {}
    for name, edt_fn in edts.items():
        for form in ("captured", "eager"):
            label = f"sharded PF-1024 museum-1000, {name}, {form}"
            mesh.particles.reset_counts()
            mesh.map.reset_counts()
            ctx.reset_counts()
            spath, sstate, dt, syncs, where = pf_run(ctx.ranges, edt_fn,
                                                     form == "eager")
            used = ctx.read_counts(label)
            if form == "captured":   # the main path; eager is its reference
                add_launches(used)
                ctx.final_states[label] = sstate
                ctx.scans_per_s[label] = len(spath) / dt
            require(used["K1"] > 0 and used["K2"] > 0,
                    f"{label} launched K1 {used['K1']} / K2 {used['K2']} "
                    f"times")
            require(np.array_equal(spath, ctx.ppath),
                    f"{label} differs from phase 6's run_pf: max "
                    f"{np.abs(spath - ctx.ppath).max()}")
            runs[name, form] = dict(
                dt=dt, syncs=syncs, where=where, label=label,
                particles=dict(mesh.particles.launches_by_shape),
                map=dict(mesh.map.launches_by_shape),
                calls=mesh.particles.calls + mesh.map.calls)
        cap, eag = runs[name, "captured"], runs[name, "eager"]
        require(ctx.path_counts[cap["label"]] == ctx.path_counts[
            eag["label"]], f"{name}: K1/K2 launches by shape, captured "
            f"{ctx.path_counts[cap['label']]} against eager "
            f"{ctx.path_counts[eag['label']]}")
        require(cap["particles"] == eag["particles"],
                f"{name}: collectives booked on the particles axis, captured "
                f"{cap['particles']} against eager {eag['particles']}")
        if isinstance(edt_fn, sharded_edt.ReplicatedField):
            # by design: the field gathered every scan captured, on a
            # keyframe eager
            field = ("all_gather", tuple(sstate.fine_metric.shape), 4)
            keyframes = eag["map"].get(field, 0)
            require(cap["map"] == {field: steps}
                    and eag["map"] == {field: keyframes}
                    and 1 <= keyframes < steps,
                    f"{name}: the map axis booked {cap['map']} captured "
                    f"(one all-gather of the field a scan expected, "
                    f"{steps}) and {eag['map']} eager (one a keyframe)")
            print(f"[20] {name}: the map axis books one all-gather of the "
                  f"field a scan captured ({steps} over {steps} steps) and "
                  f"one a keyframe eager ({keyframes}); K1 by shape "
                  f"captured == eager: {ctx.path_counts[cap['label']]['K1']}",
                  flush=True)
        else:
            require(cap["map"] == eag["map"], f"{name}: collectives booked "
                    f"on the map axis, captured {cap['map']} against eager "
                    f"{eag['map']}")
        print(f"[20] sharded PF-1024 museum-1000, {name}, on the NCCL world "
              f"of 1 (a 1x1 particles x map mesh): captured step path == "
              f"eager step path == phase 6's run_pf (np.array_equal); "
              f"{len(ctx.ranges) / cap['dt']:.1f} scans/s captured against "
              f"{len(ctx.ranges) / eag['dt']:.1f} eager; host syncs of the "
              f"whole run {cap['syncs']} captured (at {cap['where']}), "
              f"{eag['syncs']} eager (sync debug mode \"warn\"); K1/K2 "
              f"launches by shape equal; "
              f"collectives booked {cap['calls'] / steps:.2f} a step "
              f"captured, {eag['calls'] / steps:.2f} eager; by kind and "
              f"shape particles {cap['particles']}, map {cap['map']} "
              f"captured, {eag['map']} eager", flush=True)
    require(any(k[1] == 120 for k in
                ctx.path_counts[runs["4-block EDT", "captured"]["label"]]
                ["K1"]), "the 4-block run launched no K1 at (1,120,400)")
    cap = runs["default EDT", "captured"]
    calls = cap["calls"]
    gathered = sum(n * int(np.prod(sh)) * b for (k, sh, b), n
                   in cap["particles"].items() if k == "all_gather")
    reduced = sum(n * int(np.prod(sh)) * b for (k, sh, b), n
                  in cap["particles"].items() if k == "all_reduce")
    # the host syncs of a whole captured run do not grow with the tour
    short = pf_run(ctx.ranges[:SYNC_SCANS])[3]
    require(short == cap["syncs"], f"the captured sharded PF's host syncs "
            f"grow with the tour: {short} at {SYNC_SCANS} scans, "
            f"{cap['syncs']} at {len(ctx.ranges)}")
    # the steady window: ms, device ops, busy share and syncs a scan
    scans_t = torch.as_tensor(
        ctx.ranges[:PROFILE_SCANS + STEADY_SCANS + 1], device=dev)
    angles = torch.as_tensor(sensor.beam_angles(ctx.pcfg.lidar), device=dev)

    def pf_state():
        return mesh_lib.shard_particle_state(
            fastslam.init_particles(scans_t[0], ctx.pcfg), mesh)

    def eager_sharded(s_, t):
        return fastslam.pf_step(s_, scans_t[t], ctx.pcfg, angles,
                                rows=mesh.particles)

    steady("20", "sharded PF-1024 museum-1000 eager",
               lambda: (eager_sharded, pf_state()),
               runs["default EDT", "eager"]["dt"] / len(ctx.ranges))
    step = steady(
        "20", "sharded PF-1024 museum-1000 captured",
        lambda: (ByScan(sharded.make_sharded_pf_step(ctx.pcfg, mesh)[0],
                        lambda t: (scans_t[t],), advance=True), pf_state()),
        cap["dt"] / len(ctx.ranges))
    print(f"[20] the captured sharded step: {len(step.graphs)} graph, pool "
          f"{step.graphs.pool_bytes()} bytes, captured in "
          f"{step.graphs.capture_seconds:.3f} s", flush=True)
    del step
    # the sharding's cost in turns on one host: run_pf, captured sharded,
    # captured sharded, run_pf, twice
    turns = []
    for run in ("plain", "sharded", "sharded", "plain") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "plain":
            p, _ = fastslam.run_pf(ctx.ranges[:TURN_SCANS], ctx.pcfg, 0, dev)
        else:
            p, _ = sharded.run_sharded_pf(ctx.ranges[:TURN_SCANS], ctx.pcfg,
                                          mesh)
        p.cpu()
        turns.append((time.perf_counter() - t0) / (TURN_SCANS - 1) * 1e3)
    # a collective's host time called eagerly through the layer's Axis,
    # against its device time inside a CUDA graph (100 captured, one
    # replay timed)
    x = torch.randn(1024, 3, device=dev)
    y = torch.zeros(1536, dtype=torch.float64, device=dev)
    gather_us = cuda_time_ms(lambda: mesh.particles.gather(x), iters=1000,
                             warmup=50) * 1e3
    reduce_us = cuda_time_ms(lambda: mesh.particles.all_reduce(y),
                             iters=1000, warmup=50) * 1e3
    gather_dev = graph_time_ms(lambda: mesh.particles.gather(x)) * 1e3
    reduce_dev = graph_time_ms(lambda: mesh.particles.all_reduce(y)) * 1e3
    mesh.particles.reset_counts()
    print(f"[20] in turns over {TURN_SCANS} scans, ms a step run_pf / "
          f"captured sharded / captured sharded / run_pf, twice: "
          + " / ".join(f"{t:.3f}" for t in turns)
          + f"; a collective through the layer's Axis, host time called "
          f"eagerly (back-to-back, CUDA events) against device time in a "
          f"CUDA graph: gather of 1024x3 f32 {gather_us:.1f} / "
          f"{gather_dev:.2f} us, all_reduce of 1536 f64 {reduce_us:.1f} / "
          f"{reduce_dev:.2f} us", flush=True)
    g, r = gathered / steps, reduced / steps
    print(f"[20] collectives a step: {calls / steps:.2f} calls (all-gathers "
          f"of {g:.0f} result bytes, all-reduces of {r:.0f}); bytes a rank "
          f"receives a step (analytic, P = 1024 over D ranks): " + ", ".join(
              f"D={d}: {mesh_lib.bytes_per_rank(g, r, d):.0f}"
              for d in (1, 2, 4)), flush=True)
    phase_done("20")

    # ---- 21. the sharded EKF-1024 bank, museum-300: captured against
    # eager, each == the unsharded run_ml
    ecfg = ekf_slam.long_tour_config(1024)
    ctx.reset_counts()
    t0 = time.perf_counter()
    obs, valid, odo, counts = ekf_slam.scan_inputs(
        ctx.ranges[:FILTER_SCANS], ecfg, lidar_cfg=ctx.cfg.lidar,
        max_range=ekf_slam.LONG_TOUR_MAX_RANGE, device=dev)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    label = "sharded EKF-1024 museum-300, captured (pre-pass included)"
    ekf = {}
    for form in ("captured", "eager"):
        if form == "eager":
            ctx.reset_counts()
        mesh.particles.reset_counts()
        with SyncCount() as sc:
            t0 = time.perf_counter()
            ekf[form] = sharded_ekf.run_sharded_ml(
                obs, valid, odo, ecfg, mesh, 0,
                counts=counts if form == "eager" else None,
                eager=form == "eager")
            syncs = sc.count()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        ekf[form] += (dt, syncs, dict(mesh.particles.launches_by_shape),
                      ctx.read_counts(label if form == "captured" else
                                      "sharded EKF-1024 museum-300, eager"))
    (cpath, cstate, cdt, csyncs, ccoll, cused), \
        (epath, estate, edt, esyncs, ecoll, eused) = ekf.values()
    add_launches(cused)
    require(cused["K1"] > 0, f"{label} launched K1 no time")
    rpath, rstate = ekf_slam.run_ml(obs, valid, odo, ecfg, 0, dev)
    for what, (pa, st) in (("the eager sharded run", (epath, estate)),
                           ("the unsharded run_ml", (rpath, rstate))):
        require(torch.equal(cpath, pa), f"{label}: path differs from {what}")
        for f in ekf_slam.PARTICLE_LEAVES:
            require(torch.equal(getattr(cstate, f), getattr(st, f)),
                    f"{label}: {f} differs from {what}")
    require(csyncs == 1, f"{label}: {csyncs} host syncs after the pre-pass "
            f"(one, the final read, expected)")
    require(ccoll == ecoll, f"{label}: collectives booked, captured {ccoll} "
            f"against eager {ecoll}")
    ctx.final_states[label] = cstate
    ctx.scans_per_s[label] = len(cpath) / (cdt + pre_s)
    n = len(cpath) - 1
    print(f"[21] sharded EKF-1024 museum-300 on the NCCL world of 1: the "
          f"captured step's path and every bank == the eager sharded run's "
          f"== the unsharded run_ml's (torch.equal); after the pre-pass "
          f"({pre_s:.3f} s, K1 {cused['K1']}) the captured run reads the "
          f"host {csyncs} time(s), the eager one {esyncs}; ms a step "
          f"{cdt / n * 1e3:.3f} captured, {edt / n * 1e3:.3f} eager; "
          f"collectives a step {sum(ccoll.values()) / n:.2f} in both, by "
          f"kind and shape {ccoll}", flush=True)
    ekf_in = lambda t: (obs[t - 1], valid[t - 1], odo[t - 1])  # noqa: E731
    counts_host = counts.tolist()
    steady("21", "sharded EKF-1024 museum-300 eager",
               lambda: ((lambda s_, t: ekf_slam.ekf_slam_step_ml(
                   s_, *ekf_in(t)[:2], ecfg, odo=ekf_in(t)[2],
                   n_det=counts_host[t - 1], rows=mesh.particles)),
                   sharded_ekf.place_state(ekf_slam.init_ekf_slam(
                       ecfg, 0, dev), mesh)), edt / n)
    step = steady(
        "21", "sharded EKF-1024 museum-300 captured",
        lambda: (ByScan(sharded_ekf.make_sharded_ekf_step(ecfg, mesh)[0],
                        ekf_in), sharded_ekf.place_state(
                            ekf_slam.init_ekf_slam(ecfg, 0, dev), mesh)),
        cdt / n)
    print(f"[21] the captured sharded step: {len(step.graphs)} graph, pool "
          f"{step.graphs.pool_bytes()} bytes, captured in "
          f"{step.graphs.capture_seconds:.3f} s", flush=True)
    del step
    phase_done("21")

    # ---- 22. the matrix-free sharded BA on phase 17's K = 512 problem:
    # the captured solve (three graphs) against the eager one
    gaxis = sharded_ba.make_graph_mesh("cuda")
    bgpu, bgo = ctx.bgpu, ctx.bgo
    e0 = float(ba.ba_error(bgpu))

    def solve(p, iters=BA_ITERS, cg_iters=BA_CG_ITERS, eager=False,
              axis=gaxis):
        return sharded_ba.optimize_ba_sharded(
            p, axis, iters=iters, cg_iters=cg_iters, eager=eager)

    gaxis.reset_counts()
    out = solve(bgpu)
    cap_calls = gaxis.calls
    gaxis.reset_counts()
    eager_out = solve(bgpu, eager=True)
    require(gaxis.calls == cap_calls, f"sharded BA: {cap_calls} collectives "
            f"booked captured, {gaxis.calls} eager")
    require(torch.equal(out.poses, eager_out.poses)
            and torch.equal(out.landmarks, eager_out.landmarks),
            "the captured sharded BA differs from the eager _solve")
    out_cpu = solve(type(bgpu)(*[t.cpu() for t in bgpu]),
                    axis=sharded_ba.make_graph_mesh("cuda"))
    e1 = float(ba.ba_error(out))
    card_cpu = max(float((out.poses.cpu() - out_cpu.poses).abs().max()),
                   float((out.landmarks.cpu() - out_cpu.landmarks)
                         .abs().max()))
    dense = max(float((out.poses - bgo.poses).abs().max()),
                float((out.landmarks - bgo.landmarks).abs().max()))
    heading0 = float(bgo.poses[0, 2] - bgpu.poses[0, 2])
    require(card_cpu <= BA_CPU_CUDA_MAX,
            f"sharded BA card vs CPU: max {card_cpu}")
    require(e1 < BA_ERROR_RATIO * e0, f"sharded BA error {e1} >= "
            f"{BA_ERROR_RATIO} x start {e0}")
    ms = {}
    for form in ("captured", "eager", "captured", "eager"):
        t = cuda_time_ms(lambda: solve(bgpu, eager=form == "eager"),
                         iters=1, warmup=0) / BA_ITERS
        ms[form] = min(ms.get(form, t), t)
    ms["dense"] = cuda_time_ms(lambda: ba.optimize_ba(bgpu, iters=BA_ITERS),
                               iters=1, warmup=1) / BA_ITERS
    with SyncCount() as sc:
        solve(bgpu)
        syncs = sc.count()
    require(syncs == 0, f"the captured sharded BA made {syncs} host syncs")
    _, shapes = tensor_shapes(solve, bgpu, 1, 8,
                              axis=sharded_ba.make_graph_mesh("cuda"))
    k, l = bgpu.poses.shape[0], bgpu.landmarks.shape[0]
    dense_like = [sh for sh in shapes
                  if sh.count(k) >= 2 or tuple(sh[:2]) == (l, k)]
    require(dense_like == [], f"sharded BA made {dense_like}")
    largest = sorted(shapes, key=lambda sh: -int(np.prod(sh)))[:4]
    where = device_rows(lambda: solve(bgpu), BA_ITERS)
    ctx.final_states["sharded BA museum K=512"] = out
    kept = gaxis.ba_solve
    print(f"[22] sharded BA museum K=512 on the NCCL world of 1, "
          f"{BA_ITERS} iterations of {BA_CG_ITERS} PCG steps: the captured "
          f"solve ({len(kept.graphs)} graphs, {BA_CG_ITERS + 2} replays "
          f"an iteration, pool {kept.graphs.pool_bytes()} bytes) == the "
          f"eager _solve (torch.equal), {cap_calls / BA_ITERS:.0f} "
          f"collectives an iteration in both; error {e0:.1f} -> {e1:.1f} "
          f"({e1 / e0:.2%} of start, bar {BA_ERROR_RATIO:.0%}); card vs "
          f"CPU max {card_cpu:.3g} (bar {BA_CPU_CUDA_MAX}); vs the dense "
          f"optimize_ba on the card max {dense:.3g} (its soft 1e6 gauge "
          f"prior let pose 0's heading move {heading0:.3g} rad; the exact "
          f"gauge holds it); ms a GN iteration (CUDA events, the better of "
          f"two turns) captured {ms['captured']:.3f}, eager "
          f"{ms['eager']:.3f}, dense captured optimize_ba {ms['dense']:.3f}; "
          f"host syncs {syncs / BA_ITERS:.2f} an iteration; largest "
          f"tensors made {largest}, none (K, K) or (L, K) among "
          f"{len(shapes)} shapes (a fresh captured solve, 1 iteration of 8 "
          f"PCG steps)", flush=True)
    print(f"[22] where a captured GN iteration's device time goes: {where}",
          flush=True)
    del kept
    gaxis.ba_solve = None
    phase_done("22")

    # ---- 23. the dry run and the scaling report
    ctx.reset_counts()
    dry = dryrun.dryrun_multichip(1, "cuda")
    used = ctx.read_counts("dry run (NCCL world of 1)")
    add_launches(used)
    require(np.isfinite(dry["pf_est"]).all()
            and np.isfinite(dry["ekf_est"]).all(), f"dry run: {dry}")
    gc.collect()   # no captured collective outlives its communicator
    multihost.shutdown()
    rep = multihost.scaling_report(ctx.ranges, n_particles=1024,
                                   world_sizes=(1, 2, 4), n_scans=300,
                                   device_type="cuda", timeout_s=300.0)
    require(set(rep.scans_per_s) == {1} and set(rep.skipped) == {2, 4},
            f"scaling report: {rep}")
    print(f"[23] dryrun_multichip(1) on the NCCL world of 1: two PF steps "
          f"(the eager first, then the captured step), BA "
          f"error {dry['ba_error'][0]:.4f} -> {dry['ba_error'][1]:.4f}, EDT "
          f"point checks, two EKF steps; launches K1 {used['K1']} K2 "
          f"{used['K2']}. scaling_report(world_sizes=(1, 2, 4)), PF-1024 "
          f"museum, 297 timed scans in a spawned world: ran 1 ("
          f"{rep.scans_per_s[1]:.1f} scans/s); skipped " + ", ".join(
              f"{d} ({why})" for d, why in sorted(rep.skipped.items()))
          + "; the captured step, timed after its capture; no multi-GPU "
          "run (its rank's launches are counted in its own process, not "
          "here)", flush=True)
    for name, st in ctx.final_states.items():
        if name not in known_states:
            bad = debug.validate_state(st, name)
            require(bad == [], f"{name}: {bad}")
    print(f"[23] validate_state == [] for the final states of phases 20-22 "
          f"({', '.join(set(ctx.final_states) - known_states)})", flush=True)
    phase_done("23")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "lidar_slam_tpu_torch")):
        fail("run from the root of a checkout: lidar_slam_tpu_torch/ is "
             "missing beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(card, flush=True)
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    from lidar_slam_tpu_torch.utils import graphs
    binding = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    print(f"[1] CUDA graph conditional nodes (utils/graphs.cond: IF; "
          f"utils/graphs.while_loop: WHILE) recorded by "
          f"{graphs.IF_NODE_ROUTE}; torch's own binding "
          f"(CUDAGraph.begin_capture_to_if_node) "
          f"{'present' if binding else 'absent'}", flush=True)

    phase_done("1")

    from lidar_slam_tpu_torch import _build, native
    from lidar_slam_tpu_torch.config import (BUILDING_CONFIG,
                                             BUILDING_WIDE_CONFIG,
                                             DEFAULT_CONFIG, ParticleConfig)
    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.io import dataset, simulate
    from lidar_slam_tpu_torch.config import SubmapConfig
    from lidar_slam_tpu_torch.models import (ekf_hybrid, ekf_slam, fastslam,
                                             graph_slam, pf_graph_slam,
                                             posegraph, scan_matcher,
                                             submap_slam)
    from lidar_slam_tpu_torch.models.submap_graph_slam import SubmapGraphSlam
    from lidar_slam_tpu_torch.utils import paging
    from lidar_slam_tpu_torch.ops import (correlative, cuda_edt, cuda_match,
                                          landmarks)
    from lidar_slam_tpu_torch.ops import edt as edt_ops
    from lidar_slam_tpu_torch.ops import scan_odometry

    # ---- 2. build
    t0 = time.perf_counter()
    _build.build_kernels(force=True)
    _build.load_kernels()
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_oracle()
    t_oracle = time.perf_counter() - t0
    print(f"[2] kernels built in {t_kernels:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)}); oracle built in "
          f"{t_oracle:.1f} s", flush=True)
    phase_done("2")

    # ---- 2b. a WHILE node (graphs.while_loop), one graph replayed with
    # device counts 16, 0, 3, 0: its body runs that many times, none for 0
    loop_runner = graphs.Graphs(dev)
    loop_bufs = {"n": torch.zeros((), dtype=torch.int64, device=dev),
                 "sum": torch.zeros((), device=dev)}

    def loop_body(b):
        k = torch.zeros((), dtype=torch.int64, device=dev)
        go = b["n"] > k

        def once():
            b["sum"].add_(k.to(torch.float32) + 1.0)
            k.add_(1)
            torch.lt(k, b["n"], out=go)

        graphs.while_loop(go, once)

    for n in (16, 0, 3, 0):
        loop_bufs["n"].fill_(n)
        loop_bufs["sum"].fill_(-1.0)
        loop_runner.run(None, loop_body, loop_bufs)
        got = float(loop_bufs["sum"])
        require(got == -1.0 + n * (n + 1) / 2,
                f"WHILE node with count {n}: sum {got}")
    graphs.fetch(runners=[loop_runner])
    require(len(loop_runner) == 1 and loop_iterations(loop_runner) == 19,
            f"WHILE node: {len(loop_runner)} graphs, "
            f"{loop_iterations(loop_runner)} iterations booked (19 run)")
    print("[2b] a WHILE node (graphs.while_loop) in one graph, replayed "
          "with device counts 16, 0, 3 and 0: its body ran 16, 0, 3 and 0 "
          "times (none for 0), 19 iterations booked by fetch", flush=True)
    del loop_runner, loop_bufs
    phase_done("2b")

    ranges, gt = dataset.ensure_dataset(n_scans=1000, seed=0)
    cfg = DEFAULT_CONFIG
    pcfg = dataclasses.replace(cfg, particles=ParticleConfig(n_particles=1024))
    rng = np.random.default_rng(0)

    # ---- 3. K1 vs plain
    grids = []
    for b in (1, 4):
        for s in (200, 400, 512):
            dens = rng.uniform(0.001, 0.05, size=(b, 1, 1))
            grids.append(torch.as_tensor(rng.random((b, s, s)) < dens))
    angles = scan_matcher.angles_tensor(cfg, dev)
    state = scan_matcher.init_state(torch.as_tensor(ranges[0], device=dev),
                                    cfg)
    for t in range(1, 121):
        state, _ = scan_matcher.slam_step(
            state, torch.as_tensor(ranges[t], device=dev), cfg, angles)
        if t % 30 == 0:   # the rasters of the latest keyframe
            grids += [state.coarse.occ.cpu(), state.fine.occ.cpu()]
    k1_err = 0.0
    for occ in grids:
        occ = occ.to(dev).contiguous()
        got = cuda_edt.edt_clamped_cuda(occ)
        want = edt_ops.edt_clamped(occ)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"K1 differs from plain on {tuple(occ.shape)}: max "
                f"{(got - want).abs().max().item()}")
        k1_err = max(k1_err, (got - want).abs().max().item())
    print(f"[3] K1 == plain (torch.equal) on {len(grids)} grids "
          f"(B x 200/400/512 random, museum coarse/fine rasters); "
          f"max_abs_err {k1_err}", flush=True)
    phase_done("3")

    # ---- 4. K2 vs plain
    # the main path's inputs: the museum 400^2 keyframe field and scan 120's
    # base cells at the PF's theta bins and window
    fine_grid = state.fine
    fine_occ = fine_grid.occ.contiguous()
    fine_metric = state.fine_metric
    scan = sensor.read_scan(torch.as_tensor(ranges[120], device=dev), angles,
                            cfg.lidar)
    half = pcfg.particles.vol_half
    cx0, cy0 = correlative.base_cells(fine_grid, scan.x, scan.y, state.pose,
                                      pcfg.particles.vol_theta_bins,
                                      cfg.matcher.fine_r)
    k2_cases = [(fine_metric, cx0, cy0, scan.valid, fine_grid.n_rows,
                 fine_grid.n_cols, half)]
    n_beams = cfg.lidar.n_beams
    for t_bins, half_r, s in ((7, 6, 400), (13, 6, 512), (5, 14, 448)):
        occ = torch.as_tensor(rng.random((s, s)) < 0.01, device=dev)
        metric = cuda_edt.edt_clamped_cuda(occ)
        cx_r, cy_r = (torch.as_tensor(
            rng.integers(-20, s + 20, (t_bins, n_beams)), dtype=torch.int32,
            device=dev) for _ in range(2))
        valid_r = torch.as_tensor(rng.random(n_beams) < 0.9, device=dev)
        for n_rows, n_cols in ((s, s), (s // 2 + 3, s - 17), (s + 9, s + 9)):
            k2_cases.append((metric, cx_r, cy_r, valid_r, n_rows, n_cols,
                             half_r))
    k2_err = 0.0
    for args in k2_cases:
        got = cuda_match.score_volume_cuda(*args)
        want = correlative.score_volume_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"K2 differs from plain at T={args[1].shape[0]} "
                f"half={args[6]} S={args[0].shape[0]}: max "
                f"{(got - want).abs().max().item()}")
        k2_err = max(k2_err, (got - want).abs().max().item())
    print(f"[4] K2 == plain (torch.equal) on the museum 400^2 field with scan "
          f"120 (T=7, half=6) and at random (T,half,S) = (7,6,400), "
          f"(13,6,512), (5,14,448); max_abs_err {k2_err}", flush=True)
    phase_done("4")

    # ---- 4b. batched K2 vs plain: the closure-matching shape, on real
    # keyframe rasters of the loop tour and the scans 8 later
    lc = graph_slam.LoopClosureConfig()
    lranges, lgt = simulate.generate_dataset(
        700, seed=0, waypoints=simulate.LOOP_WAYPOINTS)
    old_rows = [0, 40, 80, 120, 160, 200, 240, 280]
    cur_rows = [r + 8 for r in old_rows]
    kscans = [sensor.read_scan(torch.as_tensor(lranges[i], device=dev),
                               angles, cfg.lidar)
              for i in old_rows + cur_rows]
    kx, ky, kv = (torch.stack([getattr(sc, f) for sc in kscans])
                  for f in ("x", "y", "valid"))
    kf_metric = graph_slam._raster_edt_batch(kx[:8], ky[:8], kv[:8],
                                             lc.raster_size, lc.raster_pixel)
    guesses = torch.as_tensor(np.stack([
        graph_slam._np_between_ref(lgt[i], lgt[k])
        for i, k in zip(old_rows, cur_rows)]), device=dev)
    cgrid = graph_slam._closure_grid(lc.raster_size, lc.raster_pixel, dev)
    ccx, ccy = correlative.base_cells(cgrid, kx[8:], ky[8:], guesses,
                                      lc.n_theta, lc.theta_step)
    cval = kv[8:].contiguous()
    k2b_args = (kf_metric, ccx, ccy, cval, cgrid.n_rows, cgrid.n_cols,
                lc.window_half)
    got = cuda_match.score_volume_cuda(*k2b_args)
    want = correlative.score_volume_plain(*k2b_args)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            f"batched K2 differs from plain: max "
            f"{(got - want).abs().max().item()}")
    require(float(got.abs().sum()) > 0, "batched K2 volume is all zeros")
    k2_err = max(k2_err, (got - want).abs().max().item())
    print(f"[4b] batched K2 == plain (torch.equal) on 8 loop-tour keyframe "
          f"rasters, B=8 T={lc.n_theta} half={lc.window_half} "
          f"S={lc.raster_size}, N={cfg.lidar.n_beams}; max_abs_err "
          f"{(got - want).abs().max().item()}", flush=True)
    phase_done("4b")

    # ---- 5. fidelity, museum-1000 (main path; counters start here)
    def reset_counts():
        for mod in (cuda_edt, cuda_match):
            mod.launches = 0
            mod.launches_by_shape.clear()

    path_counts = {}   # main path -> {"K1": Counter, "K2": Counter}

    def read_counts(title):
        used = {"K1": cuda_edt.launches, "K2": cuda_match.launches}
        path_counts[title] = {"K1": dict(cuda_edt.launches_by_shape),
                              "K2": dict(cuda_match.launches_by_shape)}
        require(sum(path_counts[title]["K1"].values()) == used["K1"]
                and sum(path_counts[title]["K2"].values()) == used["K2"],
                f"{title}: launches by shape do not add up")
        print(f"    launches by shape (K1: B,H,W; K2: B,T,half,S): "
              f"{path_counts[title]}", flush=True)
        return used

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, fstate = scan_matcher.run_scan(ranges, cfg, device=dev)
    path = path.cpu().numpy()
    dt = time.perf_counter() - t0
    used = read_counts("fidelity museum-1000")
    final_states = {"fidelity museum-1000": fstate}   # for phase 18
    opath, _ = native.run_oracle_cfg(ranges, cfg)
    require(np.array_equal(path, opath),
            f"fidelity path differs from the oracle: max "
            f"{np.abs(path - opath).max()} at scan "
            f"{int(np.argmax(np.abs(path - opath).max(axis=1)))}")
    require(used["K1"] > 0, "fidelity run launched K1 no time")
    launches = dict(used)
    fid_seconds = dt
    scans_per_s = {"fidelity museum-1000": len(path) / dt}
    fid_ate = ate(path, gt)
    print(f"[5] fidelity museum-1000 on cuda: bit-identical to the C++ "
          f"oracle; {len(path) / dt:.1f} scans/s ({dt:.2f} s); "
          f"ATE {ate(path, gt):.4f} m; K1 launches {used['K1']}", flush=True)
    phase_done("5")

    # ---- 6. PF-1024, museum-1000, the port's generator
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppath, pstate = fastslam.run_pf(ranges, pcfg, seed=0, device=dev)
    ppath = ppath.cpu().numpy()
    dt = time.perf_counter() - t0
    pf_seconds = dt
    used = read_counts("PF-1024 museum-1000")
    final_states["PF-1024 museum-1000"] = pstate
    require(used["K1"] > 0, "PF run launched K1 no time")
    require(used["K2"] > 0, "PF run launched K2 no time")
    for k in used:
        launches[k] += used[k]
    require(np.isfinite(ppath).all(), "PF path has non-finite poses")
    pf_ate = ate(ppath, gt)
    require(pf_ate < PF_ATE_MAX, f"PF-1024 ATE {pf_ate:.4f} m >= {PF_ATE_MAX}")
    scans_per_s["PF-1024 museum-1000"] = len(ppath) / dt
    print(f"[6] PF-1024 museum-1000 on cuda: {len(ppath) / dt:.1f} scans/s "
          f"({dt:.2f} s); ATE {pf_ate:.4f} m; map {int(pstate.pmap.size)} "
          f"points; launches K1 {used['K1']} K2 {used['K2']}", flush=True)

    n_cmp = 100
    drng = np.random.default_rng(1)
    draws = [(drng.standard_normal((1024, 3)).astype(np.float32),
              np.float32(drng.random() / 1024)) for _ in range(n_cmp - 1)]
    p_cuda, _ = fastslam.run_pf(ranges[:n_cmp], pcfg, device=dev,
                                draws=draws)
    t0 = time.perf_counter()
    p_cpu, _ = fastslam.run_pf(ranges[:n_cmp], pcfg, device="cpu",
                               draws=draws)
    dt_cpu = time.perf_counter() - t0
    diff = float(np.abs(p_cuda.cpu().numpy() - p_cpu.numpy()).max())
    require(diff <= CPU_CUDA_MAX_DIFF,
            f"PF cuda vs cpu with the same draws: max |dpose| {diff}")
    print(f"[6] PF-1024 first {n_cmp} scans, same numpy draws: cuda vs cpu "
          f"max |dpose| {diff} (bar {CPU_CUDA_MAX_DIFF}); cpu run "
          f"{dt_cpu:.1f} s", flush=True)
    phase_done("6")

    # ---- 6b. PF-10240, museum-1000 (bench.py's stage_pf10240)
    title = "PF-10240 museum-1000"
    big = dataclasses.replace(cfg, particles=ParticleConfig(n_particles=10240))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xpath, xstate = fastslam.run_pf(ranges, big, seed=0, device=dev)
    xpath = xpath.cpu().numpy()
    dt = time.perf_counter() - t0
    used = read_counts(title)
    for k in used:
        launches[k] += used[k]
    final_states[title] = xstate
    require(used["K1"] > 0 and used["K2"] > 0,
            f"{title} launched K1 {used['K1']} / K2 {used['K2']} times")
    require(np.isfinite(xpath).all(), f"{title} path is not finite")
    x_ate = ate(xpath, gt)
    require(x_ate < PF_ATE_MAX, f"{title} ATE {x_ate:.4f} m >= {PF_ATE_MAX}")
    scans_per_s[title] = len(xpath) / dt
    print(f"[6b] {title} on cuda: {len(xpath) / dt:.1f} scans/s ({dt:.2f} "
          f"s); ATE {x_ate:.4f} m (< {PF_ATE_MAX}); launches K1 "
          f"{used['K1']} K2 {used['K2']}", flush=True)
    phase_done("6b")

    # ---- 6c. captured against eager, museum-1000: the eager loops
    # (``slam_step`` / ``pf_step`` a scan, the drivers before the captured
    # ones) equal phases 5 and 6 bit for bit, with the same launches by
    # shape; then each driver's steady state: scans 1..100 run unprofiled
    # (the graphs are captured there), scans 101..150 under the profiler
    mranges = torch.as_tensor(ranges, device=dev)
    drivers = {}
    for title, graph_path, graph_seconds, run_eager in (
            ("fidelity museum-1000", path, fid_seconds,
             lambda: eager_fidelity(ranges, cfg, dev)[0]),
            ("PF-1024 museum-1000", ppath, pf_seconds,
             lambda: eager_pf(ranges, pcfg, 0, dev)[0].cpu().numpy())):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epath = run_eager()
        dt = time.perf_counter() - t0
        eager_counts = {"K1": dict(cuda_edt.launches_by_shape),
                        "K2": dict(cuda_match.launches_by_shape)}
        require(np.array_equal(epath, graph_path),
                f"{title}: the eager loop differs from the captured driver: "
                f"max {np.abs(epath - graph_path).max()}")
        require(eager_counts == path_counts[title],
                f"{title}: launches by shape, eager {eager_counts} against "
                f"captured {path_counts[title]}")
        drivers[title] = {"eager": len(epath) / dt,
                          "graph": len(graph_path) / graph_seconds}
    reset_counts()
    phase_done("6c")

    def whole_run_syncs(tag, title, run, n_full, steps_of=None):
        """``run(n)`` on the first ``SYNC_SCANS`` scans and on ``n_full``,
        each under the sync debug mode "warn": the host syncs of the whole
        run (and, with ``steps_of(run's result)``, those the frontend's
        steps made), which must not grow with the tour; and the tour's
        scans/s, run again in a process that has run the driver before."""
        counts = {}
        for n in (SYNC_SCANS, n_full):
            torch.cuda.synchronize()
            with SyncCount() as sc:
                t0 = time.perf_counter()
                out = run(n, sc) if steps_of else run(n)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                total = sc.count()
            counts[n] = (total, steps_of(out) if steps_of else total)
        (t_short, s_short), (t_full, s_full) = counts[SYNC_SCANS], \
            counts[n_full]
        require(s_short == s_full,
                f"{title}: host syncs grow with the tour: {s_short} at "
                f"{SYNC_SCANS} scans, {s_full} at {n_full}")
        what = ("whole run" if not steps_of else
                f"frontend steps (whole run, chunk fetches and backend "
                f"included: {t_short} and {t_full})")
        print(f"[{tag}] {title}: host syncs over the {what}: {s_short} at "
              f"{SYNC_SCANS} scans, {s_full} at {n_full} (sync debug mode "
              f"\"warn\"); the {n_full}-scan run again in this process "
              f"{n_full / dt:.1f} scans/s ({dt:.3f} s)", flush=True)

    def graph_report(tag, title, step, reserved, rates):
        """Prints a captured driver's graphs and pool beside its scans/s
        against the eager loop's."""
        print(f"[{tag}] {title} captured: {len(step.graphs)} graphs "
              f"in pools of {step.graphs.pool_bytes()} bytes (the graphs' "
              f"and their conditional bodies'), captured in "
              f"{step.graphs.capture_seconds:.3f} s of host time (warm-up, "
              f"capture, instantiation); "
              f"torch.cuda.memory_reserved {reserved} -> "
              f"{torch.cuda.memory_reserved()} bytes; path == the eager "
              f"loop's (np.array_equal), launches by shape equal; scans/s "
              f"captured {rates['graph']:.1f} against eager "
              f"{rates['eager']:.1f} ({rates['graph'] / rates['eager']:.2f}"
              f"x) over the whole run", flush=True)

    for title, mk_state, eager_step, graph_step in (
            ("fidelity museum-1000",
             lambda: scan_matcher.init_state(mranges[0], cfg),
             lambda s, t: scan_matcher.slam_step(s, mranges[t], cfg, angles,
                                                 pose_to_host=True),
             lambda: scan_matcher.make_step_fn(cfg, dev)),
            ("PF-1024 museum-1000",
             lambda: fastslam.init_particles(mranges[0], pcfg, 0),
             lambda s, t: fastslam.pf_step(s, mranges[t], pcfg, angles),
             lambda: fastslam.make_pf_step(pcfg, dev))):
        rates = drivers[title]
        steady("6c", f"{title} eager",
               lambda: (eager_step, mk_state()),  # noqa: B023
               1 / rates["eager"])
        reserved = torch.cuda.memory_reserved()
        step = steady("6c", f"{title} captured", lambda: (  # noqa: B023
            ByScan(graph_step(), lambda t: (mranges[t],), advance=True),
            mk_state()), 1 / rates["graph"])
        graph_report("6c", title, step, reserved, rates)
        del step
    reset_counts()
    for title, run in (
            ("fidelity museum-1000",
             lambda n: scan_matcher.run_scan(ranges[:n], cfg, device=dev)),
            ("PF-1024 museum-1000",
             lambda n: fastslam.run_pf(ranges[:n], pcfg, seed=0,
                                       device=dev))):
        whole_run_syncs("6c", title, run, len(ranges))
    reset_counts()
    phase_done("6c, profile")

    # ---- 7. kernel times at every shape the main paths launch
    # the building shapes: the museum fine raster centred in a 512^2 grid,
    # 13 theta bins
    occ512 = torch.zeros((512, 512), dtype=torch.bool, device=dev)
    occ512[56:456, 56:456] = fine_occ
    m512 = cuda_edt.edt_clamped_cuda(occ512)
    cx13, cy13 = (v + 56 for v in correlative.base_cells(
        fine_grid, scan.x, scan.y, state.pose, 13, cfg.matcher.fine_r))
    # the graph backend's keyframe rasters and fine-refine rasters
    occ256 = graph_slam._raster_batch(kx[:8], ky[:8], kv[:8],
                                      lc.raster_size, lc.raster_pixel)
    occ448 = scan_odometry._raster_centered(
        kx[:8], ky[:8], kv[:8], lc.fine_pixel, lc.fine_size).occ.contiguous()
    # the scan-odometry pre-pass's pair rasters: museum scans 0..49, gated
    # and rastered as pairwise_odometry does (10 m, 0.05 m, 448^2)
    pscans = [sensor.read_scan(torch.as_tensor(ranges[i], device=dev),
                               angles, cfg.lidar) for i in range(50)]
    px_, py_, pv_ = (torch.stack([getattr(sc, f) for sc in pscans])
                     for f in ("x", "y", "valid"))
    occ50 = scan_odometry._raster_centered(
        px_, py_, pv_ & (px_ * px_ + py_ * py_ <= 100.0), 0.05,
        448).occ.contiguous()
    k1_cases = [("(1,200,200) coarse raster", state.coarse.occ),
                ("(1,400,400) fine raster", fine_occ),
                ("(1,256,256) building coarse grid", occ256[:1]),
                ("(1,512,512) building fine grid", occ512),
                ("(8,256,256) keyframe rasters", occ256),
                ("(8,448,448) fine-refine rasters", occ448),
                ("(50,448,448) scan-odometry pair rasters", occ50),
                ("(49,448,448) scan-odometry tail chunk", occ50[:49])]
    k2_cases = [
        (f"B=1 T={pcfg.particles.vol_theta_bins} half={half} S=400 "
         f"(PF museum)", (fine_metric, cx0, cy0, scan.valid,
                          fine_grid.n_rows, fine_grid.n_cols, half)),
        ("B=1 T=13 half=6 S=512 (PF building)",
         (m512, cx13, cy13, scan.valid, 512, 512, half)),
        (f"B=8 T={lc.n_theta} half={lc.window_half} S={lc.raster_size} "
         f"(closures)", k2b_args)]
    shape_rows = {"K1": [], "K2": []}
    # device time of one launch by the shape key of launches_by_shape
    device_by_shape = {"K1": {}, "K2": {}}
    for label, occ in k1_cases:
        row, err = k1_shape_row(label, occ)
        k1_err = max(k1_err, err)
        shape_rows["K1"].append(row)
        device_by_shape["K1"][row["key"]] = row["device_ms"]
    for label, args in k2_cases:
        metric, ccx_, ccy_, cval_, n_rows, n_cols, khalf = args
        s = metric.shape[-1]
        nr_t = torch.as_tensor(n_rows, dtype=torch.int32, device=dev)
        nc_t = torch.as_tensor(n_cols, dtype=torch.int32, device=dev)
        want = correlative.score_volume_plain(*args)
        got = cuda_match.score_volume_cuda(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K2 differs from plain at {label}")
        k2_err = max(k2_err, (got - want).abs().max().item())
        out = torch.empty_like(want)
        raw = lambda: cuda_match.launch(  # noqa: E731
            metric, ccx_, ccy_, cval_, nr_t, nc_t, khalf, out)
        device_ms = graph_time_ms(raw)
        device_by_shape["K2"][(metric.numel() // (s * s), want.shape[-3],
                               khalf, s)] = device_ms
        require(torch.equal(out, want), f"raw K2 differs at {label}")
        prof_ms = profiler_kernel_ms(raw, K2_KERNEL)
        wrap = lambda: cuda_match.score_volume_cuda(*args)  # noqa: E731
        plain = lambda: correlative.score_volume_plain(*args)  # noqa: E731
        p1, w1, w2, p2 = (cuda_time_ms(f, iters=20, warmup=3)
                          for f in (plain, wrap, wrap, plain))
        conv = conv2d_yardstick(*args)
        conv_equal = torch.equal(conv(), want)
        lib_ms = cuda_time_ms(conv, iters=20, warmup=3)
        # data-dependent adds: valid beams whose (t, dy, dx) cell passes
        # the kernel's bounds test (n_rows - 1 and S both bound a row)
        n_adds = float(correlative.count_volume(
            ccx_, ccy_, cval_, torch.clamp(nr_t, max=s + 1),
            torch.clamp(nc_t, max=s + 1), khalf).sum())
        n_bytes = (metric.numel() * 4 + ccx_.numel() * 8 + cval_.numel()
                   + want.numel() * 4 + 8)
        bnd, by = bound_ms(n_bytes, n_adds)
        shape_rows["K2"].append({
            "shape": label, "device_ms": device_ms, "profiler_ms": prof_ms,
            "wrapper_ms": min(w1, w2), "plain_ms": min(p1, p2),
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "library_equal": conv_equal, "adds": n_adds,
            "bytes": n_bytes})
        print(f"[7] K2 {label}: device {device_ms * 1e3:.2f} us (CUDA graph "
              f"of {GRAPH_LAUNCHES}, memset included; profiler kernel row "
              f"{'n/a' if prof_ms is None else f'{prof_ms * 1e3:.2f}'} us); "
              f"wrapper {w1 * 1e3:.1f} / {w2 * 1e3:.1f} us; plain "
              f"{p1 * 1e3:.1f} / {p2 * 1e3:.1f} us; bound {bnd * 1e3:.3f} us "
              f"({by}: {n_bytes / 1e6:.3f} MB, {n_adds / 1e6:.3f} M adds), "
              f"{bnd / device_ms:.1%} of it reached; conv2d "
              f"{lib_ms * 1e3:.1f} us, == K2: {conv_equal}", flush=True)
    print("[7] order of each wrapper/plain pair: plain, kernel, kernel, "
          "plain; device time and bound are per launch", flush=True)
    # the partial batches the closure and refine passes end on (B < 8):
    # each plans its own band or chunk, so each is held to the plain version
    for occ in (occ256, occ448):
        out = torch.empty(occ.shape, device=dev)
        sweep = {}
        for b in range(1, 8):
            sweep[b] = graph_time_ms(lambda: cuda_edt.launch(  # noqa: B023
                occ[:b], out[:b], 10))
            device_by_shape["K1"][(b,) + tuple(occ.shape[1:])] = sweep[b]
            require(torch.equal(out[:b], edt_ops.edt_clamped(occ[:b])),
                    f"K1 differs from plain at ({b},{occ.shape[1]},"
                    f"{occ.shape[2]})")
        print(f"[7] K1 (B,{occ.shape[1]},{occ.shape[2]}) == plain at B=1..7; "
              f"device us by B: " + ", ".join(
                  f"{b}: {t * 1e3:.2f}" for b, t in sweep.items()),
              flush=True)
    metric, ccx_, ccy_, cval_, n_rows, n_cols, khalf = k2b_args
    nr_t = torch.as_tensor(n_rows, dtype=torch.int32, device=dev)
    nc_t = torch.as_tensor(n_cols, dtype=torch.int32, device=dev)
    out = torch.empty((8, lc.n_theta, 2 * khalf + 1, 2 * khalf + 1),
                      device=dev)
    sweep = {}
    for b in range(1, 8):
        part = (metric[:b], ccx_[:b], ccy_[:b], cval_[:b])
        sweep[b] = graph_time_ms(lambda: cuda_match.launch(  # noqa: B023
            *part, nr_t, nc_t, khalf, out[:b]))
        device_by_shape["K2"][(b, lc.n_theta, khalf, lc.raster_size)] = \
            sweep[b]
        require(torch.equal(out[:b], correlative.score_volume_plain(
            *part, n_rows, n_cols, khalf)),
            f"K2 differs from plain at closures B={b}")
    print(f"[7] K2 closures (B,{lc.n_theta},{khalf},{lc.raster_size}) == "
          f"plain at B=1..7; device us by B: " + ", ".join(
              f"{b}: {t * 1e3:.2f}" for b, t in sweep.items()), flush=True)
    phase_done("7")

    # ---- 8-10. the graph backend (counters zeroed before each run)
    def graph_phase(tag, title, run, ranges_gt, min_closures=None,
                    ate_max=None):
        """One main-path run with its own launch counts; the pins are
        checked unless ``min_closures`` is None."""
        granges, ggt = ranges_gt
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpath, gs = run(granges)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        used = read_counts(title)
        scans_per_s[title] = (len(gpath) - 1) / dt
        require(used["K1"] > 0 and used["K2"] > 0,
                f"{title} launched K1 {used['K1']} / K2 {used['K2']} times")
        pinned = min_closures is not None
        require(np.isfinite(gpath).all() or not pinned,
                f"{title} path is not finite")
        g = gs.graph
        g_err = float(posegraph.graph_error(g)) / max(int(g.n_edges), 1)
        err = ate(gpath, ggt)
        err_s = ate(gs.smoothed_path(gpath), ggt)
        print(f"[{tag}] {title} on cuda: {(len(gpath) - 1) / dt:.1f} scans/s "
              f"({dt:.2f} s); ATE {err:.4f} m, smoothed {err_s:.4f} m; "
              f"closures {len(gs.closures)} (weak {len(gs.weak_closures)}); "
              f"keyframes {int(gs.kf.count)}; graph error per edge "
              f"{g_err:.4f}; launches K1 {used['K1']} K2 {used['K2']}",
              flush=True)
        print(gs.timer.report(), flush=True)
        print(f"[{tag}] {title}: {backend_graphs(gs)}", flush=True)
        graph_runs[title] = (gs, dt)
        if pinned:
            require(len(gs.closures) >= min_closures,
                    f"{title}: {len(gs.closures)} closures < {min_closures}")
            require(err < ate_max, f"{title}: ATE {err:.4f} m >= {ate_max}")
        for k in used:
            launches[k] += used[k]
        final_states[title] = gs.final_state
        phase_done(tag)
        return g_err, err, err_s, gs

    graph_runs = {}   # title -> (GraphSlam, seconds): 14c's references

    def backend_graphs(gs):
        """A captured backend's graphs, pools and capture time."""
        be = gs._backend
        return (f"backend {len(be.graphs)} graphs in one pool of "
                f"{be.graphs.pool_bytes()} bytes, optimize "
                f"{len(be.optimizer.graphs)} graph in a pool of "
                f"{be.optimizer.graphs.pool_bytes()} bytes; their captures "
                f"(warm-up, capture, instantiation) "
                f"{be.graphs.capture_seconds:.3f} + "
                f"{be.optimizer.graphs.capture_seconds:.3f} s of host time")

    def stage_times(gs, seconds):
        """The backend stages' seconds and share of a run."""
        return "; ".join(f"{st} {gs.timer.totals[st]:.3f} "
                         f"({gs.timer.totals[st] / seconds:.1%})"
                         for st in BACKEND_STAGES)

    def run_graph(graph_cfg, feedback=True):
        def run(granges):
            gs = graph_slam.GraphSlam(graph_cfg, device=dev)
            gpath, _ = gs.run(granges, feedback=feedback)
            return gpath, gs
        return run

    g_err, _, _, loop_gs = graph_phase("8", "graph loop-700", run_graph(cfg),
                                 (lranges, lgt), 1, GRAPH_LOOP_ATE_MAX)
    require(g_err < 1.0, f"graph loop-700: graph error per edge {g_err}")

    t0 = time.perf_counter()
    branges, bgt = dataset.ensure_dataset(
        n_scans=simulate.BUILDING_N_SCANS, seed=0, world="building")
    print(f"[9] building-{len(branges)} tour ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # Pinned without frontend feedback. With it, this tour's outcome is
    # chaotic in both packages (a 1e-5 change of the input or another chunk
    # size turns 0.06 m into 0.8-8 m, measured on the CPU), and on the card
    # the run loses the map: the card's optimize rounds otherwise than the
    # CPU's (7.2e-7 at the second feedback), and on the branch that starts
    # the frontend leaves the building, whose closures then move keyframes
    # by 132 m; the JAX package, fed the card's state and graph on the CPU,
    # does the same (tests/_feedback_probe.py --replay). So the feedback
    # run is printed with its chunk records and the cause, not pinned.
    graph_phase("9", f"graph building-{len(branges)} (BUILDING_WIDE_CONFIG, "
                f"no feedback)", run_graph(BUILDING_WIDE_CONFIG, False),
                (branges, bgt), GRAPH_BUILDING_MIN_CLOSURES,
                GRAPH_BUILDING_ATE_MAX)
    _, _, _, fb_gs = graph_phase(
        "9", f"graph building-{len(branges)} (BUILDING_WIDE_CONFIG, "
        f"feedback; not pinned)", run_graph(BUILDING_WIDE_CONFIG),
        (branges, bgt))
    feedback_report(fb_gs, bgt)

    # ---- 9b. fidelity on building-3800 (bench.py's stage_building): the
    # parity window bit-identical to the oracle, the wide window's ATE
    bopath, _ = native.run_oracle_cfg(branges, BUILDING_CONFIG)
    for title, bcfg in (
            (f"fidelity building-{len(branges)} (BUILDING_CONFIG)",
             BUILDING_CONFIG),
            (f"fidelity building-{len(branges)} (BUILDING_WIDE_CONFIG)",
             BUILDING_WIDE_CONFIG)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpath, bstate = scan_matcher.run_scan(branges, bcfg, device=dev)
        bpath = bpath.cpu().numpy()
        dt = time.perf_counter() - t0
        used = read_counts(title)
        for k in used:
            launches[k] += used[k]
        final_states[title] = bstate
        scans_per_s[title] = len(bpath) / dt
        require(used["K1"] > 0, f"{title} launched K1 no time")
        b_ate = ate(bpath, bgt)
        if bcfg is BUILDING_CONFIG:
            require(np.array_equal(bpath, bopath),
                    f"{title} differs from the oracle: max "
                    f"{np.abs(bpath - bopath).max()} at scan "
                    f"{int(np.argmax(np.abs(bpath - bopath).max(axis=1)))}")
            building_occ = bstate.fine.occ
            # the eager loop on the same tour: the same path and launches
            reset_counts()
            t0 = time.perf_counter()
            epath, _ = eager_fidelity(branges, bcfg, dev)
            e_rate = len(epath) / (time.perf_counter() - t0)
            require(np.array_equal(epath, bpath),
                    f"{title}: the eager loop differs from the captured "
                    f"driver: max {np.abs(epath - bpath).max()}")
            require(dict(cuda_edt.launches_by_shape)
                    == path_counts[title]["K1"],
                    f"{title}: K1 launches by shape differ, eager against "
                    f"captured")
            reset_counts()
            verdict = (f"bit-identical to the C++ oracle and to the eager "
                       f"loop ({e_rate:.1f} scans/s), with the same K1 "
                       f"launches by shape")
        else:
            require(b_ate < BUILDING_WIDE_ATE_MAX,
                    f"{title} ATE {b_ate:.4f} m >= {BUILDING_WIDE_ATE_MAX}")
            verdict = f"ATE < {BUILDING_WIDE_ATE_MAX} m"
        print(f"[9b] {title} on cuda: {verdict}; {len(bpath) / dt:.1f} "
              f"scans/s ({dt:.2f} s); ATE {b_ate:.4f} m; K1 launches "
              f"{used['K1']}", flush=True)
    phase_done("9b")

    def run_pf_graph(granges):
        gpath, _, gs = pf_graph_slam.run_pf_graph(granges, pcfg, seed=0,
                                                  device=dev)
        return gpath, gs

    _, err, err_s, _ = graph_phase("10", "PF-1024-graph loop-700",
                                   run_pf_graph, (lranges, lgt), 1,
                                   PF_ATE_MAX)
    require(err_s < err + PF_GRAPH_SMOOTH_MARGIN,
            f"PF-graph smoothed ATE {err_s:.4f} >= online {err:.4f} + "
            f"{PF_GRAPH_SMOOTH_MARGIN}")

    # ---- 10b. PF-1024-graph on building-3800 with BUILDING_CONFIG and
    # closure feedback (bench.py's stage_building_pf): printed, not pinned
    # (feedback on this tour is chaotic); K2's T=13 S=512 shape runs here
    bpcfg = dataclasses.replace(BUILDING_CONFIG, particles=dataclasses.replace(
        BUILDING_CONFIG.particles, n_particles=1024))

    def run_building_pf_graph(granges):
        gpath, _, gs = pf_graph_slam.run_pf_graph(granges, bpcfg, seed=0,
                                                  device=dev)
        return gpath, gs

    title = (f"PF-1024-graph building-{len(branges)} (BUILDING_CONFIG, "
             f"feedback; not pinned)")
    graph_phase("10b", title, run_building_pf_graph, (branges, bgt))
    k2_13 = path_counts[title]["K2"].get((1, 13, 6, 512), 0)
    require(k2_13 > 0, f"{title} launched K2 at B=1 T=13 half=6 S=512 no "
            f"time")
    print(f"[10b] K2 B=1 T=13 half=6 S=512 launches on this path: {k2_13}",
          flush=True)

    # ---- 11-14. the EKF and submap families (counters zeroed per run)
    def timed_run(title, run):
        """One main-path run with its own launch counts: (result, dt)."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        used = read_counts(title)
        for k in used:
            launches[k] += used[k]
        return out, dt, used

    def same_draws(p, n):
        drng = np.random.default_rng(2)
        return [(drng.standard_normal((p, 3)).astype(np.float32),
                 np.float32(drng.random() / p)) for _ in range(n - 1)]

    def cuda_vs_cpu(tag, title, run):
        draws = same_draws(1024, n_cmp)
        got, _ = run(ranges[:n_cmp], dev, draws)
        t0 = time.perf_counter()
        want, _ = run(ranges[:n_cmp], "cpu", draws)
        diff = float(np.abs(got.cpu().numpy() - want.numpy()).max())
        require(diff <= CPU_CUDA_MAX_DIFF,
                f"{title} cuda vs cpu with the same draws: max |dpose| "
                f"{diff}")
        print(f"[{tag}] {title} first {n_cmp} scans, same numpy draws: cuda "
              f"vs cpu max |dpose| {diff} (bar {CPU_CUDA_MAX_DIFF}); cpu run "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    ecfg = ekf_slam.long_tour_config(1024)

    def run_ekf(r, device, draws=None, c=ecfg,
                max_range=ekf_slam.LONG_TOUR_MAX_RANGE):
        return ekf_slam.run_ekf_slam_scan(r, c, lidar_cfg=cfg.lidar, seed=0,
                                          max_range=max_range, device=device,
                                          draws=draws)

    def one_graph(title, made, valid_rows):
        """The step object a filter run made holds one graph, and its WHILE
        node looped over ``valid_rows`` rows: a line of its numbers."""
        require(len(made) == 1, f"{title}: {len(made)} step objects made")
        step = made[0]
        n_loop = loop_iterations(step.graphs)
        require(len(step.graphs) == 1,
                f"{title}: {len(step.graphs)} graphs, not one for every "
                f"detection count")
        require(n_loop == valid_rows,
                f"{title}: the WHILE node ran {n_loop} iterations for "
                f"{valid_rows} valid rows")
        return (f"{len(step.graphs)} graph, pools of "
                f"{step.graphs.pool_bytes()} bytes, captured in "
                f"{step.graphs.capture_seconds:.3f} s of host time; its "
                f"WHILE node ran {n_loop} iterations == the {valid_rows} "
                f"valid rows it looped over")

    def ekf_rows(r):
        """The valid detection rows of the EKF's steps on ``r``."""
        return int(ekf_slam.scan_inputs(
            r, ecfg, cfg.lidar, ekf_slam.LONG_TOUR_MAX_RANGE,
            device=dev)[3].sum())

    def hybrid_rows(r):
        """The valid detection rows of the hybrid's captured steps (scans
        2..T-1; scan 1 is the eager seed step) on ``r``."""
        return int(ekf_hybrid.hybrid_inputs(r, cfg, device=dev)
                   .det.count[2:].sum())

    title = "EKF-1024 museum-1000"
    with StepsMade(ekf_slam, "EkfStepFn") as made:
        (epath, efinal), dt, used = timed_run(title,
                                              lambda: run_ekf(ranges, dev))
    epath = epath.cpu().numpy()
    print(f"[11] {title}: the captured step: "
          f"{one_graph(title, made.made, ekf_rows(ranges))}", flush=True)
    final_states[title] = efinal
    require(used["K1"] > 0, f"{title} launched K1 no time")
    require(np.isfinite(epath).all(), f"{title} path is not finite")
    scans_per_s[title] = len(epath) / dt
    print(f"[11] {title} on cuda: {len(epath) / dt:.1f} scans/s ({dt:.2f} "
          f"s); ATE {ate(epath, gt):.4f} m; landmark slots in use "
          f"{float(efinal.lm_seen.sum(dim=1).float().mean()):.1f}; launches "
          f"K1 {used['K1']} K2 {used['K2']}", flush=True)
    cuda_vs_cpu("11", "EKF-1024", run_ekf)
    pin_cfg = ekf_slam.EkfSlamConfig(
        n_particles=512, max_landmarks=48, r_noise=0.05, b_noise=0.008,
        odo_xy_noise=0.008, odo_th_noise=0.003, new_lm_logp0=-6.0)
    p400, _ = run_ekf(ranges[:400], dev, c=pin_cfg, max_range=18.0)
    e400 = ate(p400.cpu().numpy(), gt[:400])
    require(e400 < EKF_MUSEUM400_ATE_MAX,
            f"EKF museum-400 ATE {e400:.4f} m >= {EKF_MUSEUM400_ATE_MAX}")
    print(f"[11] EKF-512 museum-400 (the museum test's config): ATE "
          f"{e400:.4f} m (< {EKF_MUSEUM400_ATE_MAX})", flush=True)
    phase_done("11")

    def run_hybrid(r, device, draws=None, c=ecfg):
        return ekf_hybrid.run_ekf_hybrid(r, c, cfg, seed=0, device=device,
                                         draws=draws)

    title = "hybrid-EKF-1024 museum-1000"
    with StepsMade(ekf_hybrid, "HybridStepFn") as made:
        (hpath, hfinal), dt, used = timed_run(title,
                                              lambda: run_hybrid(ranges, dev))
    hpath = hpath.cpu().numpy()
    print(f"[12] {title}: the captured step: "
          f"{one_graph(title, made.made, hybrid_rows(ranges))}", flush=True)
    final_states[title] = hfinal
    require(used["K1"] > 0 and used["K2"] > 0,
            f"{title} launched K1 {used['K1']} / K2 {used['K2']} times")
    require(np.isfinite(hpath).all(), f"{title} path is not finite")
    scans_per_s[title] = len(hpath) / dt
    print(f"[12] {title} on cuda: {len(hpath) / dt:.1f} scans/s ({dt:.2f} "
          f"s); ATE {ate(hpath, gt):.4f} m; map {int(hfinal.pmap.size)} "
          f"points; launches K1 {used['K1']} K2 {used['K2']}", flush=True)
    cuda_vs_cpu("12", "hybrid-EKF-1024", run_hybrid)
    c512 = ekf_slam.long_tour_config(512)
    h500, _ = run_hybrid(ranges[:500], dev, c=c512)
    l500, _ = run_ekf(ranges[:500], dev, c=c512)
    eh, el = (ate(p.cpu().numpy(), gt[:500]) for p in (h500, l500))
    require(eh < HYBRID_MUSEUM500_ATE_MAX,
            f"hybrid museum-500 ATE {eh:.4f} m >= {HYBRID_MUSEUM500_ATE_MAX}")
    require(eh < el + HYBRID_OVER_LANDMARK_MARGIN,
            f"hybrid museum-500 ATE {eh:.4f} m >= landmark-only {el:.4f} m "
            f"+ {HYBRID_OVER_LANDMARK_MARGIN}")
    print(f"[12] museum-500 at 512 particles: hybrid ATE {eh:.4f} m (< "
          f"{HYBRID_MUSEUM500_ATE_MAX}), landmark-only {el:.4f} m", flush=True)
    phase_done("12")

    title = "submap museum-1000"
    (spath, sfinal), dt, used = timed_run(
        title, lambda: submap_slam.run_scan(ranges, cfg, device=dev))
    spath = submap_path = spath.cpu().numpy()
    final_states[title] = sfinal
    require(used["K1"] > 0, f"{title} launched K1 no time")
    scans_per_s[title] = len(spath) / dt
    s_ate = ate(spath, gt)
    s_max = max(SUBMAP_ATE_FACTOR * fid_ate, SUBMAP_ATE_FLOOR)
    require(s_ate < s_max, f"{title} ATE {s_ate:.4f} m >= {s_max:.4f}")
    print(f"[13] {title} on cuda: {len(spath) / dt:.1f} scans/s ({dt:.2f} "
          f"s); ATE {s_ate:.4f} m (< {s_max:.4f}); submaps "
          f"{sfinal.atlas.n_submaps}; launches K1 {used['K1']}", flush=True)
    s_cuda, _ = submap_slam.run_scan(ranges[:n_cmp], cfg, device=dev)
    s_cpu, _ = submap_slam.run_scan(ranges[:n_cmp], cfg, device="cpu")
    require(torch.equal(s_cuda.cpu(), s_cpu),
            f"submap cuda vs cpu: max |dpose| "
            f"{(s_cuda.cpu() - s_cpu).abs().max().item()}")
    print(f"[13] submap first {n_cmp} scans: cuda == cpu (torch.equal)",
          flush=True)
    pg_cfg = dataclasses.replace(cfg, submaps=SubmapConfig(
        n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
        spawn_fill_frac=0.8))
    paged = paging.PagedAtlas(near_dist=1.0, keep_free=2)
    title = "submap paged museum-1000"
    (gpath, gfinal), dt, used = timed_run(
        title, lambda: paging.run_host_loop_paged(ranges, pg_cfg, paged,
                                                  manage_every=4,
                                                  device=dev))
    scans_per_s[title] = len(gpath) / dt
    final_states[title] = gfinal
    require(gfinal.atlas.n_submaps <= 4, "paged pool overflowed")
    require(paged.pages_out > 0, "paged run paged nothing out")
    require(np.isfinite(gpath).all(), f"{title} path is not finite")
    print(f"[13] {title} (pool 4 x 512, paging every 4 scans): "
          f"{len(gpath) / dt:.1f} scans/s; ATE {ate(gpath, gt):.4f} m; "
          f"{gfinal.atlas.n_submaps} resident, {len(paged.archive)} archived "
          f"({paged.pages_out} out / {paged.pages_in} in); launches K1 "
          f"{used['K1']}", flush=True)
    # the same loop with the eager slam_step a scan: the paged run's
    # reference (its counts are not the main path's)
    reset_counts()
    epaged = paging.PagedAtlas(near_dist=1.0, keep_free=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epath, efinal = eager_paged(ranges, pg_cfg, epaged, 4, dev)
    torch.cuda.synchronize()
    edt = time.perf_counter() - t0
    eager_counts = {"K1": dict(cuda_edt.launches_by_shape),
                    "K2": dict(cuda_match.launches_by_shape)}
    reset_counts()
    require(np.array_equal(epath, gpath),
            f"{title}: the eager paged loop differs from the captured one: "
            f"max {np.abs(epath - gpath).max()}")
    require(eager_counts == path_counts[title],
            f"{title}: launches by shape, eager {eager_counts} against "
            f"captured {path_counts[title]}")
    require((epaged.pages_out, epaged.pages_in,
             efinal.atlas.n_submaps, efinal.atlas.active)
            == (paged.pages_out, paged.pages_in, gfinal.atlas.n_submaps,
                gfinal.atlas.active),
            f"{title}: the eager paged loop paged otherwise")
    print(f"[13] {title}: the eager paged loop's path == the captured "
          f"step's (np.array_equal), launches by shape, pages and slot ints "
          f"equal; scans/s captured {len(gpath) / dt:.1f} against eager "
          f"{len(epath) / edt:.1f}", flush=True)
    phase_done("13")

    def run_submap_graph(granges):
        gs = SubmapGraphSlam(cfg, device=dev)
        gpath, _ = gs.run(granges)
        return gpath, gs

    g_err, _, _, sgs = graph_phase("14", "submap-graph loop-700",
                                   run_submap_graph, (lranges, lgt), 1,
                                   GRAPH_LOOP_ATE_MAX)
    require(g_err < 1.0, f"submap-graph: graph error per edge {g_err}")
    n_sub = sgs.final_state.atlas.n_submaps
    require(n_sub >= 2 and set(sgs.anchor_assoc) >= set(range(n_sub)),
            f"submap-graph: {n_sub} submaps, associated "
            f"{sorted(sgs.anchor_assoc)}")
    pts = sgs.world_map(sgs.final_state)
    extent = np.abs(lgt[:, :2]).max() + 30.0
    require(len(pts) > 100 and np.isfinite(pts).all()
            and np.abs(pts).max() < extent,
            f"submap-graph map: {len(pts)} points, max |xy| "
            f"{np.abs(pts).max() if len(pts) else 0}")
    print(f"[14] submap-graph: {n_sub} submaps, all tied to keyframes; map "
          f"{len(pts)} points within {extent:.1f} m", flush=True)

    phase_done("14")

    # ---- 14c. the captured graph, submap, EKF and hybrid drivers against
    # their eager loops: graph loop-700, submap museum-1000 and submap-graph
    # loop-700 whole (phases 8, 13 and 14 ran them captured), EKF-1024 and
    # hybrid-EKF-1024 on the first FILTER_SCANS museum scans (captured here,
    # main paths); the same path (np.array_equal) and the same K1/K2
    # launches by shape, then each driver's steady state as in 6c
    fr = ranges[:FILTER_SCANS]
    filter_runs = {}
    for title, run, steps, rows in (
            (f"EKF-1024 museum-{FILTER_SCANS}", lambda: run_ekf(fr, dev),
             (ekf_slam, "EkfStepFn"), ekf_rows),
            (f"hybrid-EKF-1024 museum-{FILTER_SCANS}",
             lambda: run_hybrid(fr, dev), (ekf_hybrid, "HybridStepFn"),
             hybrid_rows)):
        with StepsMade(*steps) as made:
            (fpath, ffinal), dt, used = timed_run(title, run)
        fpath = fpath.cpu().numpy()
        require(used["K1"] > 0, f"{title} launched K1 no time")
        require(np.isfinite(fpath).all(), f"{title} path is not finite")
        final_states[title] = ffinal
        scans_per_s[title] = len(fpath) / dt
        filter_runs[title] = fpath
        print(f"[14c] {title}: {len(fpath) / dt:.1f} scans/s ({dt:.3f} s, "
              f"pre-pass included); the captured step: "
              f"{one_graph(title, made.made, rows(fr))}", flush=True)
    f_ekf, f_hybrid = filter_runs
    # each filter's pre-pass, then its filter from the pre-pass's inputs
    # under the sync debug mode: nothing read on the host between the two
    # but the run's one final read
    for title, prepass, run_filter in (
            (f_ekf, lambda: ekf_slam.scan_inputs(
                fr, ecfg, cfg.lidar, ekf_slam.LONG_TOUR_MAX_RANGE,
                device=dev),
             lambda inp: ekf_slam.run_ml(*inp[:3], ecfg, 0, dev)),
            (f_hybrid, lambda: ekf_hybrid.hybrid_inputs(fr, cfg, device=dev),
             lambda inp: ekf_hybrid.run_hybrid_inputs(inp, ecfg, cfg, 0))):
        with SyncCount() as sc:
            t0 = time.perf_counter()
            inputs = prepass()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            before = sc.count()
            fpath, _ = run_filter(inputs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            after = sc.count() - before
            where = sc.where(before)
        require(np.array_equal(fpath.cpu().numpy(), filter_runs[title]),
                f"{title}: the filter from its pre-pass's inputs differs "
                f"from the whole run")
        require(after <= 1, f"{title}: {after} host syncs between the "
                f"pre-pass and the run's end (the final read is 1): "
                f"{where}")
        print(f"[14c] {title}: pre-pass {t1 - t0:.3f} s ({before} host "
              f"syncs), then the filter {t2 - t1:.3f} s with {after} host "
              f"syncs (sync debug mode \"warn\": {where}), its path == the "
              f"whole run's", flush=True)
    # the pre-pass split: the detector, the batched read and the chunk
    # graphs of the scan-odometry matcher (replays), against the eager
    # loop (read_scan a scan, match_batch a chunk) on the same scans
    fr_t = torch.as_tensor(np.asarray(fr, np.float32), device=dev)
    sangles = scan_matcher.angles_tensor(cfg, dev)
    split = {}

    def clocked(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t0
        return out

    clocked("detector", lambda: landmarks.extract_corners(
        fr_t, sangles, range_min=cfg.lidar.range_min,
        usable_range=cfg.lidar.usable_range,
        max_range=ekf_slam.LONG_TOUR_MAX_RANGE))
    reset_counts()
    scans = clocked("read_scans", lambda: sensor.read_scans(fr_t, sangles,
                                                            cfg.lidar))
    matcher = scan_odometry.pair_matcher(fr_t.device, 50, 10.0, 0.05, 448, 7,
                                         0.03, 0.03)
    deltas = clocked("chunk graphs", lambda: matcher(scans.x, scans.y,
                                                     scans.valid))
    graph_counts = {"K1": dict(cuda_edt.launches_by_shape)}
    reset_counts()
    eager_deltas, t_reads, t_chunks = eager_pairwise(fr_t, sangles,
                                                     cfg.lidar)
    eager_counts = {"K1": dict(cuda_edt.launches_by_shape)}
    reset_counts()
    require(torch.equal(deltas, eager_deltas),
            f"the pre-pass's chunk graphs differ from the eager chunk loop: "
            f"max {(deltas - eager_deltas).abs().max().item()}")
    require(graph_counts == eager_counts,
            f"the pre-pass's K1 launches by shape: graphs {graph_counts}, "
            f"eager {eager_counts}")
    require(len(matcher.graphs) == len(matcher.bufs),
            "the pre-pass matcher: a graph for each chunk width")
    print(f"[14c] the pre-pass on {FILTER_SCANS} scans, s: detector "
          f"{split['detector']:.4f}; batched read_scans "
          f"{split['read_scans']:.4f} against {t_reads:.4f} a scan at a "
          f"time; the matcher's chunk graphs {split['chunk graphs']:.4f} "
          f"(replays) against {t_chunks:.4f} eager; the deltas == the eager "
          f"chunk loop's (torch.equal), K1 launches by shape equal "
          f"{graph_counts['K1']}; the matcher holds {len(matcher.graphs)} "
          f"graphs (chunk widths {sorted(matcher.bufs)}), pools of "
          f"{matcher.graphs.pool_bytes()} bytes, captured in "
          f"{matcher.graphs.capture_seconds:.3f} s of host time", flush=True)

    eager_graphs = {}   # title -> the eager GraphSlam

    def eager_graph(title, make, granges, **kw):
        """The eager frontend and backend (``eager=True``) on a phase's
        tour: its path."""
        def run():
            gs = eager_graphs[title] = make()
            return gs.run(granges, **kw)[0]
        return run

    b9 = (f"graph building-{len(branges)} (BUILDING_WIDE_CONFIG, no "
          f"feedback)")
    drivers14 = {}
    for title, graph_path, run_eager, per_scan in (
            ("graph loop-700", loop_gs._last_path, eager_graph(
                "graph loop-700", lambda: graph_slam.GraphSlam(
                    cfg, device=dev, eager=True), lranges), 1),
            (b9, graph_runs[b9][0]._last_path, eager_graph(
                b9, lambda: graph_slam.GraphSlam(
                    BUILDING_WIDE_CONFIG, device=dev, eager=True), branges,
                feedback=False), 1),
            ("PF-1024-graph loop-700",
             graph_runs["PF-1024-graph loop-700"][0]._last_path,
             eager_graph("PF-1024-graph loop-700",
                         lambda: pf_graph_slam.PFGraphSlam(
                             pcfg, seed=0, device=dev, eager=True), lranges,
                         chunk_size=128), 1),
            ("submap museum-1000", submap_path,
             lambda: eager_submap(ranges, cfg, dev)[0], 0),
            ("submap-graph loop-700", sgs._last_path, eager_graph(
                "submap-graph loop-700", lambda: SubmapGraphSlam(
                    cfg, device=dev, eager=True), lranges), 1),
            (f_ekf, filter_runs[f_ekf],
             lambda: eager_ekf(fr, ecfg, cfg, dev)[0], 0),
            (f_hybrid, filter_runs[f_hybrid],
             lambda: eager_hybrid(fr, ecfg, cfg, dev)[0], 0)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epath = run_eager()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        eager_counts = {"K1": dict(cuda_edt.launches_by_shape),
                        "K2": dict(cuda_match.launches_by_shape)}
        require(np.array_equal(epath, graph_path),
                f"{title}: the eager loop differs from the captured driver: "
                f"max {np.abs(epath - graph_path).max()}")
        require(eager_counts == path_counts[title],
                f"{title}: launches by shape, eager {eager_counts} against "
                f"captured {path_counts[title]}")
        drivers14[title] = {"eager": (len(epath) - per_scan) / dt,
                            "graph": scans_per_s[title]}
        print(f"[14c] {title}: the eager loop's path == the captured "
              f"driver's (np.array_equal), launches by shape equal; "
              f"scans/s captured {scans_per_s[title]:.1f} against eager "
              f"{drivers14[title]['eager']:.1f}", flush=True)
        if title in eager_graphs:
            gs, gdt = graph_runs[title]
            egs = eager_graphs[title]
            require(egs.closures == gs.closures
                    and egs.weak_closures == gs.weak_closures
                    and egs.attempt_log == gs.attempt_log
                    and np.array_equal(np.stack(egs.kf_poses),
                                       np.stack(gs.kf_poses)),
                    f"{title}: the eager backend's closures, attempts or "
                    f"keyframe poses differ from the captured backend's")
            print(f"[14c] {title}: closures, weak closures, attempt log and "
                  f"keyframe poses == the captured backend's; backend "
                  f"stages, s (share of the run): captured "
                  f"{stage_times(gs, gdt)}; eager {stage_times(egs, dt)}",
                  flush=True)
    # graph loop-700 captured once more, in a process whose libraries
    # (cuSOLVER, the pools' first segments) phase 8 already started: the
    # backend's cost on a 700-scan tour without the process's first use
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = graph_slam.GraphSlam(cfg, device=dev)
    again_path, _ = again.run(lranges)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(np.array_equal(again_path, loop_gs._last_path),
            "graph loop-700: a second captured run differs from phase 8's")
    print(f"[14c] graph loop-700 captured again in this process: "
          f"{(len(again_path) - 1) / dt:.1f} scans/s ({dt:.2f} s), path == "
          f"phase 8's; backend stages, s (share of the run): "
          f"{stage_times(again, dt)}; {backend_graphs(again)}", flush=True)
    del again
    reset_counts()
    phase_done("14c")

    # steady state: scans 1..PROFILE_SCANS unprofiled, the next
    # STEADY_SCANS under the profiler; the graph runs count their scans
    # from inside the chunk loop (WindowedFrontend)
    n_steady = PROFILE_SCANS + STEADY_SCANS
    for title, make in (
            ("graph loop-700", lambda eager: graph_slam.GraphSlam(
                cfg, device=dev, eager=eager)),
            ("PF-1024-graph loop-700",
             lambda eager: pf_graph_slam.PFGraphSlam(
                 pcfg, seed=0, device=dev, eager=eager)),
            ("submap-graph loop-700", lambda eager: SubmapGraphSlam(
                cfg, device=dev, eager=eager))):
        rates = drivers14[title]
        for eager in (True, False):
            reserved = torch.cuda.memory_reserved()
            result = {}
            for profile in (False, True):
                gs = make(eager)
                gs.frontend = WindowedFrontend(
                    gs.frontend, PROFILE_SCANS + 1, STEADY_SCANS, profile)
                gs.run(lranges[:n_steady + 1])   # scans 1..n_steady
                require(gs.frontend.result is not None,
                        f"{title}: the measured window did not close")
                result[profile] = gs.frontend.result
            report("14c", f"{title} {'eager' if eager else 'captured'}",
                   result[True], 1 / rates["eager" if eager else "graph"],
                   result[False])
            if not eager:
                graph_report("14c", title, gs.frontend.step, reserved, rates)
    obs14, valid14, odo14, counts14 = ekf_slam.scan_inputs(
        ranges[:n_steady + 1], ecfg, cfg.lidar,
        ekf_slam.LONG_TOUR_MAX_RANGE, device=dev)
    counts14 = counts14.tolist()
    hr14, hdet14, hodo14, _ = ekf_hybrid.hybrid_inputs(
        ranges[:n_steady + 1], cfg, device=dev)
    hcounts14 = hdet14.count.tolist()

    def ekf_inputs(t):
        return obs14[t - 1], valid14[t - 1], odo14[t - 1]

    def hybrid_in(t):
        return (hr14[t], hdet14.rb[t], hdet14.valid[t], hodo14[t - 1],
                hcounts14[t])

    for title, mk_state, eager_step, mk_graph_step in (
            ("submap museum-1000",
             lambda: submap_slam.init_state(mranges[0], cfg),
             lambda s, t: submap_slam.slam_step(s, mranges[t], cfg, sangles),
             lambda: ByScan(submap_slam.make_step_fn(cfg, dev),
                            lambda t: (mranges[t],), advance=True)),
            (f_ekf,
             lambda: ekf_slam.init_ekf_slam(ecfg, 0, dev),
             lambda s, t: ekf_slam.ekf_slam_step_ml(
                 s, *ekf_inputs(t)[:2], ecfg, odo=ekf_inputs(t)[2],
                 n_det=counts14[t - 1]),
             lambda: ByScan(ekf_slam.EkfStepFn(ecfg, dev), ekf_inputs)),
            (f_hybrid,
             lambda: ekf_hybrid.init_hybrid(hr14[0], ecfg, cfg, 0),
             lambda s, t: ekf_hybrid.hybrid_step(
                 s, *hybrid_in(t)[:4], ecfg, cfg, sangles,
                 n_det=hybrid_in(t)[4]),
             lambda: ByScan(ekf_hybrid.HybridStepFn(ecfg, cfg, dev),
                            hybrid_in, advance=True))):
        rates = drivers14[title]
        steady("14c", f"{title} eager",
               lambda: (eager_step, mk_state()),  # noqa: B023
               1 / rates["eager"])
        reserved = torch.cuda.memory_reserved()
        step = steady("14c", f"{title} captured",
                      lambda: (mk_graph_step(), mk_state()),  # noqa: B023
                      1 / rates["graph"])
        graph_report("14c", title, step, reserved, rates)
        del step
    reset_counts()

    def graph_steps(make, **kw):
        """``run(n, sync_count)`` of a graph run over the first n loop
        scans (``GraphSlam.run``'s ``kw``) whose frontend counts its
        steps' syncs."""
        def run(n, sc):
            gs = make()
            gs.frontend = StepSyncs(gs.frontend, sc)
            gs.run(lranges[:n], **kw)
            return gs.frontend.syncs
        return run

    for title, run, n_full, steps_of in (
            ("graph loop-700", graph_steps(
                lambda: graph_slam.GraphSlam(cfg, device=dev)),
             len(lranges), int),
            ("PF-1024-graph loop-700", graph_steps(
                lambda: pf_graph_slam.PFGraphSlam(pcfg, seed=0, device=dev),
                chunk_size=128), len(lranges), int),
            ("submap-graph loop-700", graph_steps(
                lambda: SubmapGraphSlam(cfg, device=dev)), len(lranges), int),
            ("submap museum-1000",
             lambda n: submap_slam.run_scan(ranges[:n], cfg, device=dev),
             len(ranges), None),
            (f_ekf, lambda n: run_ekf(ranges[:n], dev), FILTER_SCANS,
             None),
            (f_hybrid, lambda n: run_hybrid(ranges[:n], dev), FILTER_SCANS,
             None)):
        whole_run_syncs("14c", title, run, n_full, steps_of)
    reset_counts()
    phase_done("14c, profile")

    # ---- 15. streamed fidelity, museum-1000: ScanServer -> RelayServer ->
    # run_streaming_slam on the card (counters zeroed just before)
    import warnings

    from lidar_slam_tpu_torch.io import server

    title = "streamed fidelity museum-1000"
    # the server and the relay run in a process of their own, as the
    # reference's do, so their threads do not share this process's GIL
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    chain = ctx.Process(target=_serve_chain, args=(ranges, child_conn),
                        daemon=True)
    chain.start()

    def ask(msg):
        conn.send(msg)
        require(conn.poll(60), f"the server process did not answer {msg!r}")
        return conn.recv()

    try:
        require(conn.poll(300), "the server process sent no URL")
        relay_url = conn.recv()
        # unpaced: the whole tour as fast as the step takes it (the pins,
        # scans/s, and the queue's latency)
        lat = []
        (spath, sstate), dt, used = timed_run(
            title, lambda: server.run_streaming_slam(
                relay_url, len(ranges), cfg, device=dev, latencies=lat))
        n_relayed, _ = ask("count")
        # host syncs a scan, counted in a shorter pass of their own: the
        # sync debug mode's warnings would weigh on the timed run
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                server.run_streaming_slam(relay_url, STREAM_SYNC_SCANS, cfg,
                                          device=dev)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        # paced at the sensor's rate: the latency a user waits
        ask(STREAM_PACE_S)
        plat = []
        paced_path, _ = server.run_streaming_slam(
            relay_url, STREAM_PACED_SCANS, cfg, device=dev, latencies=plat)
        _, t_row0 = ask("stop")
    finally:
        chain.join(30)
        if chain.is_alive():
            chain.kill()
            chain.join()
    final_states[title] = sstate
    scans_per_s[title] = len(spath) / dt
    require(n_relayed == len(ranges),
            f"{title}: the relay relayed {n_relayed} requests")
    require(used["K1"] > 0, f"{title} launched K1 no time")
    # the protocol serves float32(round(v, 2)); both references get those
    rounded = np.asarray([[round(float(v), 2) for v in row]
                          for row in ranges], np.float32)
    offline, _ = scan_matcher.run_host_loop(rounded, cfg, device=dev)
    require(np.array_equal(spath, offline),
            f"{title} differs from run_host_loop on the rounded ranges: max "
            f"{np.abs(spath - offline).max()}")
    orounded, _ = native.run_oracle_cfg(rounded, cfg)
    require(np.array_equal(spath, orounded),
            f"{title} differs from the oracle on the rounded ranges: max "
            f"{np.abs(spath - orounded).max()}")
    require(np.array_equal(paced_path, spath[:STREAM_PACED_SCANS]),
            f"{title}: the paced stream's path differs from the unpaced one")

    def pcts(ms):
        return (f"p50 {np.percentile(ms, 50):.2f} ms p99 "
                f"{np.percentile(ms, 99):.2f} ms")

    arrival = np.asarray([(c - a) * 1e3 for a, _, c in lat])
    step_ms = np.asarray([(c - b) * 1e3 for _, b, c in lat])
    sensor = np.asarray([(c - t_row0 - t * STREAM_PACE_S) * 1e3
                         for t, (_, _, c) in enumerate(plat, start=1)])
    parrival = np.asarray([(c - a) * 1e3 for a, _, c in plat])
    print(f"[15] {title} on cuda via ScanServer -> RelayServer (both in "
          f"a process of their own), unpaced: "
          f"{len(spath) / dt:.1f} scans/s ({dt:.2f} s); relayed {n_relayed}; "
          f"bit-identical to run_host_loop and to the oracle on the "
          f"protocol-rounded ranges; ATE {ate(spath, gt):.4f} m; with the "
          f"{server.PREFETCH}-deep prefetch queue full: arrival -> pose on "
          f"host {pcts(arrival)}, dequeue -> pose {pcts(step_ms)}; K1 "
          f"launches {used['K1']}", flush=True)
    print(f"[15] paced at {1 / STREAM_PACE_S:.0f} Hz (row N released at row "
          f"0's time + N x {STREAM_PACE_S} s), {STREAM_PACED_SCANS} scans, "
          f"path == the unpaced run's: latency row released -> pose on host "
          f"{pcts(sensor)}; arrival -> pose {pcts(parrival)}; host syncs "
          f"{syncs / (STREAM_SYNC_SCANS - 1):.2f} a scan (a "
          f"{STREAM_SYNC_SCANS}-scan pass under the sync debug mode)",
          flush=True)
    phase_done("15")

    # ---- 16. supervised PF-1024, museum-1000, with a wedge at scan 550
    from lidar_slam_tpu_torch.utils import checkpoint, watchdog

    title = "supervised PF-1024 museum-1000"
    run_dir = os.path.join(_build.BUILD_DIR, "supervised_pf")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    reset_counts()
    sup = watchdog.run_supervised(
        _wedging_pf_worker, (ranges, pcfg, 0, SUP_CKPT_EVERY, "cuda",
                             SUP_WEDGE_AT), run_dir,
        stall_timeout_s=SUP_STALL_S, max_restarts=1,
        boot_grace_s=SUP_BOOT_GRACE_S)
    require(sup.completed and sup.attempts == 2
            and sup.stalls == 1,
            f"{title}: {sup}")
    spf = np.load(os.path.join(run_dir, watchdog.PATH_FILE))
    require(np.array_equal(spf, ppath),
            f"{title}: resumed path differs from phase 6's run_pf: max "
            f"{np.abs(spf - ppath).max()}")
    counts = {"K1": {}, "K2": {}}
    for attempt in (1, 2):
        with open(os.path.join(run_dir, f"launches_{attempt}.json")) as f:
            for key, rows in json.load(f).items():
                for shape, n in rows:
                    counts[key][tuple(shape)] = (
                        counts[key].get(tuple(shape), 0) + n)
    path_counts[title] = counts
    used = {k: sum(v.values()) for k, v in counts.items()}
    require(used["K1"] > 0 and used["K2"] > 0,
            f"{title}: the workers launched K1 {used['K1']} / K2 "
            f"{used['K2']} times")
    for k in used:
        launches[k] += used[k]
    final_states[title] = checkpoint.load_state(
        os.path.join(run_dir, watchdog.CKPT_FILE),
        fastslam.init_particles(torch.as_tensor(ranges[0], device=dev),
                                pcfg, 99))
    print(f"    launches by shape (K1: B,H,W; K2: B,T,half,S): {counts}",
          flush=True)
    print(f"[16] {title}: wedge injected at scan {SUP_WEDGE_AT} of attempt "
          f"1, stall timeout {SUP_STALL_S:.0f} s, checkpoint every "
          f"{SUP_CKPT_EVERY}: completed, attempts {sup.attempts}, stalls "
          f"{sup.stalls}, crashes {sup.crashes}; {sup.seconds:.1f} s "
          f"against phase 6's unsupervised {pf_seconds:.1f} s (restart cost "
          f"{sup.seconds - pf_seconds:.1f} s, the stall timeout and one "
          f"more start-up and resume included); path == phase 6's run_pf "
          f"(np.array_equal); launches K1 {used['K1']} K2 {used['K2']}",
          flush=True)
    phase_done("16")

    # ---- 17. landmark BA at the graph backend's size (a 1536^2 reduced
    # system), the museum landmark tour; the card against the CPU
    from lidar_slam_tpu_torch.models import ba, state_io

    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    bprob = ba.BAProblem(**simulate.generate_ba_problem(n_scans=1000))
    bgpu = state_io.ba_problem_from_numpy(bprob, dev)
    bcpu = state_io.ba_problem_from_numpy(bprob, "cpu")
    e0 = float(ba.ba_error(bgpu))
    bgo = ba.optimize_ba(bgpu, iters=BA_ITERS)
    bgo_eager = ba.optimize_ba_eager(bgpu, iters=BA_ITERS)
    require(torch.equal(bgo.poses, bgo_eager.poses)
            and torch.equal(bgo.landmarks, bgo_eager.landmarks),
            "BA: the captured optimize_ba differs from optimize_ba_eager")
    bco = ba.optimize_ba(bcpu, iters=BA_ITERS)
    e1 = float(ba.ba_error(bgo))
    bdiff = max(float((bgo.poses.cpu() - bco.poses).abs().max()),
                float((bgo.landmarks.cpu() - bco.landmarks).abs().max()))
    require(bdiff <= BA_CPU_CUDA_MAX, f"BA card vs CPU: max {bdiff}")
    require(e1 < BA_ERROR_RATIO * e0, f"BA error {e1} >= {BA_ERROR_RATIO} "
            f"x start {e0}")
    final_states["BA museum K=512"] = bgo
    ms_iter = cuda_time_ms(lambda: ba.optimize_ba(bgpu, iters=BA_ITERS),
                           iters=3, warmup=1) / BA_ITERS
    ms_iter_eager = cuda_time_ms(
        lambda: ba.optimize_ba_eager(bgpu, iters=BA_ITERS), iters=3,
        warmup=1) / BA_ITERS
    ba_fn = next(fn for fn in ba._OPTIMIZE_BA_FNS.values()
                 if fn.problem.poses.is_cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ba.optimize_ba(bgpu, iters=BA_ITERS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    bsyncs = sum("synchroniz" in str(w.message) for w in caught)
    ba_rows = device_rows(lambda: ba.optimize_ba(bgpu, iters=BA_ITERS),
                          BA_ITERS)
    print(f"[17] BA device time an iteration: {ba_rows}", flush=True)
    print(f"[17] BA museum K=512 ({int(bprob.pose_active.sum())} poses, "
          f"{int(bprob.lm_active.sum())} landmarks, "
          f"{int(bprob.obs_active.sum())} observations, "
          f"{int(bprob.odo_active.sum())} odometry factors; 1536^2 reduced "
          f"system), TF32 off: error {e0:.1f} -> {e1:.1f} "
          f"({e1 / e0:.2%} of start, bar {BA_ERROR_RATIO:.0%}) in "
          f"{BA_ITERS} iterations; card vs CPU max {bdiff:.3g} (bar "
          f"{BA_CPU_CUDA_MAX}); captured == optimize_ba_eager bit for bit; "
          f"{ms_iter:.3f} ms a GN iteration captured, {ms_iter_eager:.3f} "
          f"eager (CUDA events); {len(ba_fn.graphs)} graph in a pool of "
          f"{ba_fn.graphs.pool_bytes()} bytes; host syncs "
          f"{bsyncs / BA_ITERS:.2f} an iteration", flush=True)
    phase_done("17")

    # ---- 17b. the robust pose graph, card against CPU: phase 8's loop-700
    # graph plus one bad closure edge (2 m and 0.5 rad off); its Huber chi
    # on the same inputs, card == CPU
    from lidar_slam_tpu_torch.core import se2

    lg = loop_gs.graph
    n_kf = int(lg.n_nodes)
    bad_z = se2.between(lg.poses[0], lg.poses[n_kf // 2]) + torch.tensor(
        [2.0, -1.5, 0.5], device=dev)
    lg = posegraph.add_edge(lg, 0, n_kf // 2, bad_z,
                            torch.tensor([20.0, 20.0, 100.0], device=dev))
    lg_cpu = type(lg)(*[t.cpu() for t in lg])
    pg_card = posegraph.optimize(lg, iters=10, robust=True).poses
    pg_again = posegraph.optimize(lg, iters=10, robust=True).poses
    pg_cpu = posegraph.optimize(lg_cpu, iters=10, robust=True).poses
    require(torch.equal(pg_card, pg_again),
            "robust pose graph: two card runs differ")
    pg_d = (pg_card.cpu() - pg_cpu).abs()[:n_kf]
    require(float(pg_d.max()) <= PG_CPU_CUDA_MAX,
            f"robust pose graph card vs CPU: max {float(pg_d.max())}")
    # the captured optimize (GraphSlam's OptimizeFn) == the eager one
    opt_fn = posegraph.OptimizeFn(lg.poses.shape[0], lg.edge_i.shape[0], dev)
    pg_ms = {}
    for robust in (True, False):
        want = (pg_card if robust else
                posegraph.optimize(lg, iters=10, robust=False).poses)
        got = opt_fn(lg, iters=10, robust=robust).poses
        require(torch.equal(got, want),
                f"pose graph (robust={robust}): the captured optimize "
                f"differs from the eager one")
    for name, fn in (("captured", lambda: opt_fn(lg, iters=10)),
                     ("eager", lambda: posegraph.optimize(lg, iters=10))):
        pg_ms[name] = cuda_time_ms(fn, iters=5, warmup=1)
    print(f"[17b] captured optimize (10 iterations) device time "
          f"{device_rows(lambda: opt_fn(lg, iters=10), 1)}", flush=True)
    # the chi on the CPU's inputs: this graph's edges at its start, then
    # random weights and residuals
    crng = np.random.default_rng(0)
    cw = torch.cat([lg_cpu.edge_w * lg_cpu.edge_active.float()[:, None],
                    torch.as_tensor(crng.uniform(1, 400, (CHI_ROWS, 3)),
                                    dtype=torch.float32)])
    cr = torch.cat([posegraph._edge_residual(
        lg_cpu.poses[lg_cpu.edge_i.long()], lg_cpu.poses[lg_cpu.edge_j.long()],
        lg_cpu.edge_z), torch.as_tensor(crng.normal(0, 0.5, (CHI_ROWS, 3)),
                                        dtype=torch.float32)])
    chi_cpu = posegraph._huber_chi(cw, cr)
    chi_card = posegraph._huber_chi(cw.to(dev), cr.to(dev)).cpu()
    require(torch.equal(chi_card, chi_cpu),
            f"robust pose graph: the Huber chi differs card vs CPU in "
            f"{int((chi_card != chi_cpu).sum())} of {len(chi_cpu)} rows")
    q = torch.clamp((cw * cr * cr).sum(dim=1), min=1e-12)   # as the chi
    chi_f32_off = int((torch.sqrt(q.to(dev)).cpu() != torch.sqrt(q)).sum())
    print(f"[17b] robust pose graph, loop-700 ({n_kf} keyframes, "
          f"{int(lg.n_edges)} edges with one bad closure), 10 iterations: "
          f"card twice equal; card == CPU: "
          f"{torch.equal(pg_card.cpu(), pg_cpu)}"
          f", {int((pg_d > 0).sum())} of {pg_d.numel()} pose values differ, "
          f"max {float(pg_d.max()):.3g} (bar {PG_CPU_CUDA_MAX}); Huber chi "
          f"card == CPU on {len(chi_cpu)} rows (the graph's edges and "
          f"{CHI_ROWS} random); an f32 sqrt would differ in {chi_f32_off}; "
          f"the captured optimize (OptimizeFn, {len(opt_fn.graphs)} graphs "
          f"in a pool of {opt_fn.graphs.pool_bytes()} bytes) == the eager "
          f"one, robust and not; {pg_ms['captured']:.3f} ms an optimize "
          f"captured, {pg_ms['eager']:.3f} eager (CUDA events)", flush=True)
    phase_done("17b")

    # ---- 18. profiling and debug audit
    from lidar_slam_tpu_torch.utils import debug, profiling

    stages = profiling.pf_stage_profile(pcfg, n_scans=120, seed=0,
                                        device=dev)
    print("[18] pf_stage_profile (PF-1024, museum state after 120 scans; "
          "CUDA-event ms a call, median of 5 reps of 10): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    for name, st in final_states.items():
        bad = debug.validate_state(st, name)
        require(bad == [], f"{name}: {bad}")
    checked_step = debug.checked(scan_matcher.slam_step)
    cstate = scan_matcher.init_state(torch.as_tensor(ranges[0], device=dev),
                                     cfg)
    for t in range(1, 21):
        cstate, _ = checked_step(cstate, torch.as_tensor(ranges[t],
                                                         device=dev),
                                 cfg, angles)
    require(debug.validate_state(cstate) == [], "checked steps left an "
            "invalid state")
    print(f"[18] validate_state == [] for the final state of all "
          f"{len(final_states)} main paths ({', '.join(final_states)}); "
          f"debug.checked(slam_step) ran 20 museum scans clean", flush=True)
    phase_done("18")

    import types

    ctx = types.SimpleNamespace(
        dev=dev, cfg=cfg, pcfg=pcfg, ranges=ranges, ppath=ppath,
        pf_seconds=pf_seconds, fine_occ=fine_occ, building_occ=building_occ,
        bgpu=bgpu, bgo=bgo, reset_counts=reset_counts,
        read_counts=read_counts, path_counts=path_counts, launches=launches,
        scans_per_s=scans_per_s, final_states=final_states,
        shape_rows=shape_rows, device_by_shape=device_by_shape,
        k1_err=k1_err)
    parallel_phases(ctx)
    k1_err = ctx.k1_err

    # every launch count is summed over the main paths (phases 5, 6, 8-16)
    kernels = []
    for key, name, source, replaces, err in (
            ("K1", "K1 clamped EDT", K1_SOURCE, K1_REPLACES, k1_err),
            ("K2", "K2 correlation volume", K2_SOURCE, K2_REPLACES, k2_err)):
        head = shape_rows[key][1 if key == "K1" else 0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err, "ms": head["device_ms"],
            "device_ms": head["device_ms"],
            "wrapper_ms": head["wrapper_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "primary_shape": head["shape"],
            "shapes": shape_rows[key],
            "launches_by_path": {p: {str(k): v for k, v in c[key].items()}
                                 for p, c in path_counts.items()}})
    # what the kernels' device time adds up to on each main path: its
    # launches by shape times phase 7's device time of that shape
    for p, counts in path_counts.items():
        parts = []
        for key in ("K1", "K2"):
            known = device_by_shape[key]
            ms = sum(n * known[k] for k, n in counts[key].items() if k in known)
            unmeasured = sum(n for k, n in counts[key].items()
                             if k not in known)
            parts.append(f"{key} {ms:.3f} ms"
                         + (f" (+{unmeasured} launches at unmeasured shapes)"
                            if unmeasured else ""))
        print(f"kernel device time, {p}: " + "; ".join(parts), flush=True)
    print("scans/s by main path: " + "; ".join(
        f"{p} {v:.1f}" for p, v in scans_per_s.items()), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
