"""Command-line interface of the port.

  python -m lidar_slam_tpu_torch run --mode fidelity --scans 1000
  python -m lidar_slam_tpu_torch run --mode pf --particles 1024 --device cuda
  python -m lidar_slam_tpu_torch run --mode graph --loop --scans 700
  python -m lidar_slam_tpu_torch run --mode graph --world building --window 2
  python -m lidar_slam_tpu_torch run --mode pf-graph --loop --scans 700
  python -m lidar_slam_tpu_torch run --mode ekf
  python -m lidar_slam_tpu_torch run --mode ekf-hybrid
  python -m lidar_slam_tpu_torch run --mode submap [--paged]
  python -m lidar_slam_tpu_torch run --mode submap-graph --loop --scans 700

Runs a synthesized tour (the museum by default, cached under ``data/``;
``--loop`` the closed loop in the museum's left room; ``--world building``
the 60x45 m building with ``BUILDING_CONFIG``) through the fidelity scan
matcher, the particle filter, graph SLAM with loop closure, the
particle-filter frontend with loop closure, the scan-driven landmark
EKF-FastSLAM (``long_tour_config``), the hybrid grid + landmark filter,
the submap-atlas pipeline (``--paged``: cold submaps paged to host memory)
or graph SLAM over the submap atlas, and prints the same ``scans/s``,
``ATE`` and per-mode lines as ``python -m lidar_slam_tpu run``.
``--device`` defaults to ``cuda`` and
fails without a card; pass ``--device cpu`` for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def _load_ranges(args) -> tuple[np.ndarray, np.ndarray]:
    from lidar_slam_tpu_torch.io import dataset, simulate

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
    if args.window is not None:
        cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, window_t=args.window, window_r=args.window))
    return dataclasses.replace(cfg, particles=dataclasses.replace(
        cfg.particles, n_particles=args.particles))


def cmd_run(args) -> int:
    from lidar_slam_tpu_torch.device import resolve_device
    from lidar_slam_tpu_torch.utils.metrics import ate

    device = resolve_device(args.device)
    ranges, gt = _load_ranges(args)
    cfg = _config(args)

    gs = None
    notes = []    # the mode's own lines, printed after the timing
    map_xy = None
    t0 = time.perf_counter()
    if args.mode == "fidelity":
        from lidar_slam_tpu_torch.models import scan_matcher

        path, state = scan_matcher.run_scan(ranges, cfg, device=device)
        path = path.cpu().numpy()   # waits for the device
    elif args.mode == "pf":
        from lidar_slam_tpu_torch.models import fastslam

        path, state = fastslam.run_pf(ranges, cfg, seed=args.seed,
                                      device=device)
        path = path.cpu().numpy()
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
    print(f"{args.mode}: {n} scans in {dt:.2f}s = {n / dt:.1f} scans/s")
    print(f"ATE vs ground truth: {ate(path, gt):.4f} m")
    if gs is not None:
        print(f"smoothed-path ATE: {ate(gs.smoothed_path(path), gt):.4f} m")
        print(gs.timer.report())
    if args.render:
        from lidar_slam_tpu_torch.utils import viz

        if map_xy is None and args.mode == "graph":
            from lidar_slam_tpu_torch.models.graph_slam import (
                _np_transform_ref)

            k = int(gs.kf.count)
            wx, wy = _np_transform_ref(gs.kf.x[:k], gs.kf.y[:k],
                                       np.stack(gs.kf_poses))
            v = gs.kf.valid[:k]
            map_xy = np.stack([wx[v], wy[v]], axis=1)
        elif map_xy is None:
            map_xy = state.pmap.xy[: int(state.pmap.size)].cpu().numpy()
        viz.render_map(map_xy, path=path, out_path=args.render, gt=gt,
                       title=f"{args.mode} | {n} scans")
        print(f"render -> {args.render}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lidar_slam_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("run", help="run a SLAM pipeline on a synthesized "
                        "tour")
    sp.add_argument("--mode", choices=["fidelity", "pf", "graph", "pf-graph",
                                       "ekf", "ekf-hybrid", "submap",
                                       "submap-graph"],
                    default="fidelity")
    sp.add_argument("--scans", type=int, default=None,
                    help="scans of the tour (default 1000; 3800 on the "
                    "building)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--loop", action="store_true",
                    help="use the loop-closure trajectory")
    sp.add_argument("--world", choices=["museum", "building"],
                    default="museum",
                    help="museum (20x15 m) or building (60x45 m, 3800 "
                    "scans; selects BUILDING_CONFIG)")
    sp.add_argument("--window", type=int, default=None,
                    help="matcher search window in steps per stage (1 = "
                    "reference-exact; 2 solves the building tour)")
    sp.add_argument("--particles", type=int, default=1024)
    sp.add_argument("--paged", action="store_true",
                    help="submap mode: page cold submaps to host memory")
    sp.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    sp.add_argument("--render", type=str, default=None,
                    help="write a map/trajectory PNG (needs matplotlib)")
    sp.set_defaults(fn=cmd_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
