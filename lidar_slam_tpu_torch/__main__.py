"""Command-line interface of the port.

  python -m lidar_slam_tpu_torch simulate --scans 1000 --out data/museum.csv
  python -m lidar_slam_tpu_torch run --mode fidelity --scans 1000
  python -m lidar_slam_tpu_torch run --mode pf --particles 1024 --device cuda
  python -m lidar_slam_tpu_torch run --mode pf --checkpoint pf.npz
  python -m lidar_slam_tpu_torch run --mode pf --resume pf.npz
  python -m lidar_slam_tpu_torch run --mode pf --supervised --run-dir run/
  python -m lidar_slam_tpu_torch run --mode graph --loop --scans 700
  python -m lidar_slam_tpu_torch run --mode graph --world building --window 2
  python -m lidar_slam_tpu_torch run --mode pf-graph --loop --scans 700
  python -m lidar_slam_tpu_torch run --mode ekf
  python -m lidar_slam_tpu_torch run --mode ekf-hybrid
  python -m lidar_slam_tpu_torch run --mode submap [--paged]
  python -m lidar_slam_tpu_torch run --mode submap-graph --loop --scans 700
  python -m lidar_slam_tpu_torch oracle --scans 500      # C++ golden pipeline
  python -m lidar_slam_tpu_torch serve --port 8080       # HTTP scan server

``run`` takes a synthesized tour (the museum by default, cached under
``data/``; ``--loop`` the closed loop in the museum's left room; ``--world
building`` the 60x45 m building with ``BUILDING_CONFIG``) or a CSV of range
rows (``--dataset``), runs it through the fidelity scan matcher, the
particle filter (checkpointed, resumable, or under the stall watchdog),
graph SLAM with loop closure, the particle-filter frontend with loop
closure, the scan-driven landmark EKF-FastSLAM (``long_tour_config``), the
hybrid grid + landmark filter, the submap-atlas pipeline (``--paged``: cold
submaps paged to host memory) or graph SLAM over the submap atlas, and
prints the same ``scans/s``, ``ATE`` and per-mode lines as ``python -m
lidar_slam_tpu run``. ``--debug-checks`` audits the final state and path
(exit code 2 on a violation). ``--device`` defaults to ``cuda`` and fails
without a card; pass ``--device cpu`` for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def _load_ranges(args) -> tuple[np.ndarray, np.ndarray | None]:
    """(ranges, ground truth or None for a CSV dataset)."""
    from lidar_slam_tpu_torch.io import dataset, simulate

    if args.dataset:
        from lidar_slam_tpu_torch import native

        with open(args.dataset) as f:
            n_rows = args.scans or sum(1 for _ in f)
        return native.read_csv(args.dataset, n_rows), None
    n = args.scans or (simulate.BUILDING_N_SCANS if args.world == "building"
                       else 1000)
    if args.loop:
        return simulate.generate_dataset(n_scans=n, seed=args.seed,
                                         waypoints=simulate.LOOP_WAYPOINTS)
    return dataset.ensure_dataset(n_scans=n, seed=args.seed,
                                  world=args.world)


def _config(args):
    """The grid/map preset of the world, the matcher window (``--window 2``
    on the building is ``BUILDING_WIDE_CONFIG``) and the particle count.
    Every other field of the preset is kept."""
    from lidar_slam_tpu_torch.config import BUILDING_CONFIG, DEFAULT_CONFIG

    cfg = BUILDING_CONFIG if args.world == "building" else DEFAULT_CONFIG
    if getattr(args, "window", None) is not None:
        cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, window_t=args.window, window_r=args.window))
    if hasattr(args, "particles"):
        cfg = dataclasses.replace(cfg, particles=dataclasses.replace(
            cfg.particles, n_particles=args.particles))
    return cfg


def cmd_simulate(args) -> int:
    from lidar_slam_tpu_torch.io import dataset, simulate

    wps = simulate.LOOP_WAYPOINTS if args.loop else None
    ranges, gt = simulate.generate_dataset(n_scans=args.scans or 1000,
                                           seed=args.seed, waypoints=wps)
    out = args.out or "lidar_dataset.csv"
    dataset.save_csv(out, ranges)
    np.savetxt(out.replace(".csv", "_gt.csv"), gt, delimiter=",", fmt="%.6f")
    print(f"wrote {ranges.shape[0]} scans to {out}")
    return 0


def _run_pf(args, ranges, cfg, device):
    """The pf mode: plain, resumed from ``--resume``, or supervised.
    Returns (path numpy, final state, scan the ATE starts at)."""
    from lidar_slam_tpu_torch.models import fastslam, scan_matcher
    from lidar_slam_tpu_torch.utils import checkpoint, graphs

    def template():
        return fastslam.init_particles(
            torch.as_tensor(ranges[0], device=device), cfg, args.seed)

    if args.supervised:
        # watchdog-contained run: a wedged device kills only the worker;
        # the run resumes from its checkpoint (utils/watchdog)
        from lidar_slam_tpu_torch.utils import watchdog

        run_dir = args.run_dir or ".slam_run"
        path, report = watchdog.run_pf_supervised(
            ranges, cfg, run_dir, seed=args.seed,
            stall_timeout_s=args.stall_timeout, resume=bool(args.resume),
            device=str(device))
        print(f"supervised run: completed={report.completed} "
              f"attempts={report.attempts} stalls={report.stalls} "
              f"({report.seconds:.1f}s)")
        if not report.completed:
            return None, None, 0
        state = checkpoint.load_state(
            os.path.join(run_dir, watchdog.CKPT_FILE), template())
        return path, state, 0
    if args.resume:
        state = checkpoint.load_state(args.resume, template())
        start = state.step
        print(f"resumed from {args.resume} at scan {start}")
        scans = scan_matcher.as_ranges(ranges, device)
        path, state = graphs.host_loop(fastslam.make_pf_step(cfg, device),
                                       state, len(scans),
                                       lambda t: (scans[t],), start)
        return path, state, start
    path, state = fastslam.run_pf(ranges, cfg, seed=args.seed, device=device)
    return path.cpu().numpy(), state, 0


def _map_points(args, state, gs) -> np.ndarray:
    """World-frame map points of a run's final state."""
    if args.mode == "graph":
        from lidar_slam_tpu_torch.models.graph_slam import _np_transform_ref

        k = int(gs.kf.count)
        wx, wy = _np_transform_ref(gs.kf.x[:k], gs.kf.y[:k],
                                   np.stack(gs.kf_poses))
        v = gs.kf.valid[:k]
        return np.stack([wx[v], wy[v]], axis=1)
    return state.pmap.xy[: int(state.pmap.size)].cpu().numpy()


def cmd_run(args) -> int:
    from lidar_slam_tpu_torch.device import resolve_device
    from lidar_slam_tpu_torch.utils.metrics import ate

    device = resolve_device(args.device)
    ranges, gt = _load_ranges(args)
    cfg = _config(args)

    gs = state = final = map_xy = None
    notes = []    # the mode's own lines, printed after the timing
    ate_from = 0  # a resumed run reports ATE over the resumed scans only
    t0 = time.perf_counter()
    if args.mode == "fidelity":
        from lidar_slam_tpu_torch.models import scan_matcher

        path, state = scan_matcher.run_scan(ranges, cfg, device=device)
        path = path.cpu().numpy()   # waits for the device
    elif args.mode == "pf":
        path, state, ate_from = _run_pf(args, ranges, cfg, device)
        if path is None:
            return 1
        if args.checkpoint:
            from lidar_slam_tpu_torch.utils import checkpoint

            checkpoint.save_state(args.checkpoint, state)
            notes.append(f"checkpoint -> {args.checkpoint}")
    elif args.mode == "graph":
        from lidar_slam_tpu_torch.models.graph_slam import GraphSlam

        gs = GraphSlam(cfg, device=device)
        path, _ = gs.run(ranges)
        state = gs.final_state
    elif args.mode == "pf-graph":
        from lidar_slam_tpu_torch.models.pf_graph_slam import run_pf_graph

        path, _, gs = run_pf_graph(ranges, cfg, seed=args.seed, device=device)
        state = gs.final_state
    elif args.mode == "ekf":
        from lidar_slam_tpu_torch.models import ekf_slam

        path, final = ekf_slam.run_ekf_slam_scan(
            ranges, ekf_slam.long_tour_config(args.particles),
            lidar_cfg=cfg.lidar, seed=args.seed,
            max_range=ekf_slam.LONG_TOUR_MAX_RANGE, device=device)
        path = path.cpu().numpy()
        seen = final.lm_seen.cpu().numpy()
        notes.append(f"landmark slots in use (mean over particles): "
                     f"{seen.sum(axis=1).mean():.1f}")
        map_xy = ekf_slam.landmark_estimates(final)[seen.any(axis=0)]
    elif args.mode == "ekf-hybrid":
        from lidar_slam_tpu_torch.models import ekf_slam
        from lidar_slam_tpu_torch.models.ekf_hybrid import run_ekf_hybrid

        path, state = run_ekf_hybrid(
            ranges, ekf_slam.long_tour_config(args.particles), cfg,
            seed=args.seed, device=device)
        path = path.cpu().numpy()
    elif args.mode == "submap":
        from lidar_slam_tpu_torch.core import submap
        from lidar_slam_tpu_torch.models import submap_slam
        from lidar_slam_tpu_torch.utils import paging

        if args.paged:
            paged = paging.PagedAtlas()
            path, state = paging.run_host_loop_paged(ranges, cfg, paged,
                                                     device=device)
            map_xy = paged.world_points(state.atlas)
            notes.append(f"submaps: {state.atlas.n_submaps} resident, "
                         f"{len(paged.archive)} archived "
                         f"({paged.pages_out} out / {paged.pages_in} in)")
        else:
            path, state = submap_slam.run_scan(ranges, cfg, device=device)
            path = path.cpu().numpy()
            wx, wy, mask = (v.cpu().numpy() for v in
                            submap.submap_world_points(state.atlas))
            map_xy = np.stack([wx[mask], wy[mask]], axis=1)
            notes.append(f"submaps: {state.atlas.n_submaps}, "
                         f"{len(map_xy)} map points")
    else:
        from lidar_slam_tpu_torch.models.submap_graph_slam import (
            SubmapGraphSlam)

        gs = SubmapGraphSlam(cfg, device=device)
        path, _ = gs.run(ranges)
        state = gs.final_state
        map_xy = gs.world_map(state)
    dt = time.perf_counter() - t0

    n = len(path)
    print(f"device: {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host CPU'})")
    if gs is not None:
        print(f"keyframes {int(gs.kf.count)}  loop closures {len(gs.closures)}"
              + (f"  submaps {state.atlas.n_submaps}"
                 if args.mode == "submap-graph" else ""))
    for line in notes:
        print(line)
    if args.debug_checks:
        # the audit of utils/debug over the final state and trajectory
        from lidar_slam_tpu_torch.utils import debug

        violations = []
        if not np.isfinite(path).all():
            violations.append("trajectory contains non-finite poses")
        for nm, obj in (("state", state), ("final", final)):
            if obj is not None:
                violations += debug.validate_state(obj, nm)
        if violations:
            print("DEBUG-CHECKS FAILED:\n  " + "\n  ".join(violations))
            return 2
        print("debug-checks: all state invariants hold")
    print(f"{args.mode}: {n} scans in {dt:.2f}s = {n / dt:.1f} scans/s")
    has_gt = gt is not None and len(gt) == n
    if has_gt:
        print(f"ATE vs ground truth: "
              f"{ate(path[ate_from:], gt[ate_from:]):.4f} m")
    if gs is not None:
        if has_gt:
            print(f"smoothed-path ATE: "
                  f"{ate(gs.smoothed_path(path), gt):.4f} m")
        print(gs.timer.report())
    if args.out_map or args.render:
        if map_xy is None:
            map_xy = _map_points(args, state, gs)
        if args.out_map:
            from lidar_slam_tpu_torch.utils import viz

            viz.map_to_csv(map_xy, args.out_map)
            print(f"map ({len(map_xy)} points) -> {args.out_map}")
        if args.render:
            from lidar_slam_tpu_torch.utils import viz

            viz.render_map(map_xy, path=path, out_path=args.render,
                           gt=gt if has_gt else None,
                           title=f"{args.mode} | {n} scans")
            print(f"render -> {args.render}")
    return 0


def cmd_oracle(args) -> int:
    from lidar_slam_tpu_torch import native
    from lidar_slam_tpu_torch.utils.metrics import ate

    ranges, gt = _load_ranges(args)
    t0 = time.perf_counter()
    path, omap = native.run_oracle_cfg(ranges, _config(args),
                                       use_naive_edt=args.naive_edt)
    dt = time.perf_counter() - t0
    print(f"oracle: {len(path)} scans in {dt:.2f}s = {len(path) / dt:.1f} "
          f"scans/s ({'naive' if args.naive_edt else 'separable'} EDT)")
    if gt is not None:
        print(f"ATE vs ground truth: {ate(path, gt):.4f} m")
    if args.out_map:
        np.savetxt(args.out_map, omap, delimiter=",", fmt="%f")
        print(f"map ({len(omap)} points) -> {args.out_map}")
    return 0


def cmd_serve(args) -> int:
    from lidar_slam_tpu_torch.io import server

    ranges, _ = _load_ranges(args)
    srv = server.ScanServer(ranges, port=args.port).start()
    print(f"serving {len(ranges)} scans at {srv.url} (?param=N; Ctrl-C to "
          f"stop)", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lidar_slam_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scans", type=int, default=None,
                        help="scans of the tour (default 1000; 3800 on the "
                        "building; with --dataset, the CSV's rows)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--dataset", type=str, default=None,
                        help="CSV of range rows (default: synthesize)")
        sp.add_argument("--loop", action="store_true",
                        help="use the loop-closure trajectory")
        sp.add_argument("--world", choices=["museum", "building"],
                        default="museum",
                        help="museum (20x15 m) or building (60x45 m, 3800 "
                        "scans; selects BUILDING_CONFIG)")

    sp = sub.add_parser("simulate", help="write a synthetic dataset CSV")
    common(sp)
    sp.add_argument("--out", type=str, default=None)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("run", help="run a SLAM pipeline")
    common(sp)
    sp.add_argument("--mode", choices=["fidelity", "pf", "graph", "pf-graph",
                                       "ekf", "ekf-hybrid", "submap",
                                       "submap-graph"],
                    default="fidelity")
    sp.add_argument("--window", type=int, default=None,
                    help="matcher search window in steps per stage (1 = "
                    "reference-exact; 2 solves the building tour)")
    sp.add_argument("--particles", type=int, default=1024)
    sp.add_argument("--paged", action="store_true",
                    help="submap mode: page cold submaps to host memory")
    sp.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    sp.add_argument("--out-map", type=str, default=None,
                    help="write the final map's points as x,y CSV")
    sp.add_argument("--render", type=str, default=None,
                    help="write a map/trajectory PNG (needs matplotlib)")
    sp.add_argument("--checkpoint", type=str, default=None,
                    help="save the final state (pf mode)")
    sp.add_argument("--resume", type=str, default=None,
                    help="resume from a saved state (pf mode); with "
                    "--supervised, any value resumes the run-dir "
                    "checkpoint when its run identity matches")
    sp.add_argument("--supervised", action="store_true",
                    help="pf mode: run under the stall watchdog (kill + "
                    "restart + checkpoint-resume)")
    sp.add_argument("--run-dir", type=str, default=None,
                    help="supervised mode: heartbeat/checkpoint directory "
                    "(default .slam_run)")
    sp.add_argument("--stall-timeout", type=float, default=120.0,
                    help="supervised mode: seconds without a heartbeat "
                    "before the worker is killed and restarted")
    sp.add_argument("--debug-checks", action="store_true",
                    help="audit the final state and trajectory "
                    "(finiteness, capacities, weight health; utils/debug)")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("oracle", help="run the native C++ golden pipeline")
    common(sp)
    sp.add_argument("--naive-edt", action="store_true")
    sp.add_argument("--out-map", type=str, default=None)
    sp.set_defaults(fn=cmd_oracle)

    sp = sub.add_parser("serve", help="serve scans over HTTP")
    common(sp)
    sp.add_argument("--port", type=int, default=8080)
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
