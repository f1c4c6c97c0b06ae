"""A graph run with frontend feedback, chunk by chunk, in either package.

    PYTHONPATH=. python tests/_feedback_probe.py --package {torch,jax}
        [--world building] [--scans N] [--chunk 256] [--max-keyframes 512]
        [--min-gap 10] [--window {1,2}] [--device cpu] [--save run.npz]
        [--snapshot SCAN]
    PYTHONPATH=. python tests/_feedback_probe.py --package {torch,jax}
        --replay run.npz

prints one line a chunk (the port's ``GraphSlam.chunk_log``; for the JAX
package the same record, taken by wrapping its ``GraphSlam``'s methods,
since that package is not edited): the chunk's first scan, the keyframe
store's count, the keyframes the frontend made, the closures accepted, the
optimize's ``delta``, whether a feedback ran and the graph error per edge.
Then the scan at which the store filled, the chunks that fed back, the
ATE, the largest error of the path and the first scan with an error over
1 m; and each feedback's re-anchoring inputs. ``--world building`` (window 2) is the
README's ``run --mode graph --world building --window 2``.

``--snapshot SCAN`` (the port, with ``--save``) keeps the frontend state at
the start of the chunk that begins at SCAN and the pose graph of that
chunk's optimize; ``--replay`` feeds them to either package on the CPU:
the frontend over the chunk's scans and the optimize, each held to the
saved run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _jax_chunk_log(gs):
    """Wrap a JAX ``GraphSlam``'s methods so that ``gs.chunk_log`` and
    ``gs.saturated_at`` fill as the port's do; ``gs.flush_chunk_log()``
    closes the last record after the run."""
    from lidar_slam_tpu.models import posegraph

    gs.chunk_log, gs.saturated_at = [], None
    # keyframe 0 is added before the first chunk, which does not make it
    cur, made, scans = {}, [-1], [1]
    add, closures, optimize, rebuild, post = (
        gs._add_keyframe, gs._try_loop_closures_batch, gs._optimize,
        gs._rebuild_frontend, gs._post_chunk)

    def flush():
        if cur:
            gs.chunk_log.append(dict(cur))
            cur.clear()

    def _add_keyframe(*args, scan_t=0, **kw):
        if gs._kf_count >= gs.max_keyframes and gs.saturated_at is None:
            gs.saturated_at = scan_t
        made[0] += 1
        return add(*args, scan_t=scan_t, **kw)

    def _post_chunk(state):
        # after the chunk's keyframe adds, before its closures
        flush()
        cur.update(first_scan=scans[0], keyframes=gs._kf_count, made=made[0],
                   closures=0, weak=0, delta=None, feedback=False,
                   error_per_edge=None)
        made[0], scans[0] = 0, len(gs.path_epoch)
        return post(state)

    def _try_loop_closures_batch(new_kf):
        n = (len(gs.closures), len(gs.weak_closures))
        out = closures(new_kf)
        cur.update(closures=len(gs.closures) - n[0],
                   weak=len(gs.weak_closures) - n[1])
        return out

    def _optimize():
        delta = optimize()
        if cur:   # a chunk's optimize; the run's final one has no record
            g = gs.graph
            cur.update(delta=delta, error_per_edge=float(
                posegraph.graph_error(g)) / max(int(g.n_edges), 1))
        return delta

    def _rebuild_frontend(state):
        cur["feedback"] = True
        return rebuild(state)

    gs._add_keyframe = _add_keyframe
    gs._post_chunk = _post_chunk
    gs._try_loop_closures_batch = _try_loop_closures_batch
    gs._optimize = _optimize
    gs._rebuild_frontend = _rebuild_frontend
    gs.flush_chunk_log = flush
    return gs


def _record_feedbacks(gs):
    """Wrap ``gs._rebuild_frontend`` so that ``gs.feedbacks`` lists, for
    each feedback, its re-anchoring inputs as host arrays: the store's
    last keyframe (optimized), the frontend's last keyframe pose, the
    frontend's pose, and the frontend's pose after the rebuild."""
    gs.feedbacks = []
    rebuild = gs._rebuild_frontend

    def _rebuild_frontend(state):
        new = rebuild(state)
        gs.feedbacks.append(np.stack([
            np.asarray(gs.kf_poses[-1], np.float32),
            _host(state.pmap.keyframe_pose), _host(state.pose),
            _host(new.pose)]))
        return new

    gs._rebuild_frontend = _rebuild_frontend


def _snapshot(gs, first: int, chunk: int):
    """Wrap a port ``GraphSlam`` so that ``gs.snapshot`` holds, for the
    chunk that starts at scan ``first``: the frontend state it starts from
    (numpy leaves, ``state_io``), the pose graph its optimize solves (host
    arrays, ``PoseGraph``'s order) and the keyframe poses before and after
    that optimize (reference convention)."""
    from lidar_slam_tpu_torch.models import state_io
    from lidar_slam_tpu_torch.utils.graphs import clone_tree

    def host(state):   # the state's tensors are the step's buffers
        return state_io.slam_state_to_numpy(clone_tree(state))

    gs.snapshot = {}
    post, rebuild, optimize = (gs._post_chunk, gs._rebuild_frontend,
                               gs._optimize)

    def chunk_start() -> int:   # chunk_log grows at each chunk's end
        return len(gs.chunk_log) * chunk + 1

    def _post_chunk(state):
        if chunk_start() == first - chunk:
            gs.snapshot["state"] = host(state)
        return post(state)

    def _rebuild_frontend(state):
        new = rebuild(state)
        if chunk_start() == first - chunk:
            gs.snapshot["state"] = host(new)
        return new

    def _optimize():
        if chunk_start() != first:
            return optimize()
        gs.snapshot["graph"] = gs._graph_arrays()
        gs.snapshot["before"] = np.stack(gs.kf_poses)
        delta = optimize()
        gs.snapshot["after"] = np.stack(gs.kf_poses)
        gs.snapshot["delta"] = delta
        return delta

    gs._post_chunk = _post_chunk
    gs._rebuild_frontend = _rebuild_frontend
    gs._optimize = _optimize


def _flat(prefix: str, tree) -> dict:
    """A NamedTuple tree as {"prefix/field/...": numpy array}."""
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat(f"{prefix}/{f}", getattr(tree, f)))
        return out
    return {prefix: np.asarray(tree)}


def _unflat(z, prefix: str, cls):
    """The inverse of ``_flat`` for a NamedTuple class ``cls`` whose nested
    fields are NamedTuple classes of the same package."""
    import typing

    hints = typing.get_type_hints(cls)
    vals = {}
    for f in cls._fields:
        key = f"{prefix}/{f}"
        if key in z:
            vals[f] = z[key]
        else:
            vals[f] = _unflat(z, key, hints[f])
    return cls(**vals)


def replay(fname: str, package: str) -> str:
    """Feed a saved run's snapshot (``--snapshot``, a card run's for
    instance) to ``package`` on the CPU: the fidelity frontend from the
    saved state over the chunk's scans, held to the saved path, and the
    saved pose graph's optimize (if the chunk ran one), held to the saved
    keyframe poses and ``delta``."""
    from lidar_slam_tpu_torch.models.scan_matcher import SlamState

    z = np.load(fname)
    first = int(z["snap_first"])
    ranges = z["snap_ranges"]
    card_path = z["path"][first:first + len(ranges)]
    name = str(z["snap_config"])
    st = _unflat(z, "snap_state", SlamState)
    solved = "snap_graph/0" in z
    graph = [z[f"snap_graph/{i}"] for i in range(9)] if solved else None
    if package == "jax":
        import jax.numpy as jnp
        from _torch_util import jax_slam_state
        from lidar_slam_tpu import config
        from lidar_slam_tpu.models import posegraph, scan_matcher

        cfg = getattr(config, name)
        step = scan_matcher.make_step_fn(cfg)
        state, poses = jax_slam_state(st), []
        for r in ranges:
            state, pose = step(state, jnp.asarray(r))
            poses.append(np.asarray(pose))
        opt = solved and np.asarray(posegraph.optimize(posegraph.PoseGraph(
            *(jnp.asarray(a) for a in graph)), iters=10).poses)
    else:
        import torch
        from lidar_slam_tpu_torch import config
        from lidar_slam_tpu_torch.models import posegraph, scan_matcher
        from lidar_slam_tpu_torch.models import state_io

        cfg = getattr(config, name)
        angles = scan_matcher.angles_tensor(cfg, "cpu")
        state, poses = state_io.slam_state_from_numpy(st, "cpu"), []
        for r in ranges:
            state, pose = scan_matcher.slam_step(
                state, torch.as_tensor(r), cfg, angles)
            poses.append(pose.numpy())
        opt = solved and posegraph.optimize(state_io.posegraph_from_numpy(
            posegraph.PoseGraph(*graph), "cpu"), iters=10).poses.numpy()
    poses = np.stack(poses)
    out = (f"{package} on the CPU from the saved state at scan {first}: "
           f"frontend path over scans {first}..{first + len(poses) - 1} "
           f"max |{package} - saved| {np.abs(poses - card_path).max():.3e} "
           f"m, end pose {poses[-1]} (saved run {card_path[-1]})")
    if not solved:
        return out + "; the chunk ran no optimize"
    before, saved_after = z["snap_before"], z["snap_after"]
    k = len(before)
    after = np.stack([[p[0], p[1], -p[2]] for p in opt[:k]])  # std -> ref
    delta = float(np.max(np.hypot(*(after[:, :2] - before[:, :2]).T)))
    return (out + f"; the chunk's optimize on the saved graph ({k} "
            f"keyframes, {int(graph[8])} edges): delta {delta:.6f} m (saved "
            f"run {float(z['snap_delta']):.6f}), max |{package} - saved| "
            f"{np.abs(after - saved_after).max():.3e}")


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float32)


def run(package: str, world: str, n_scans: int | None, chunk: int,
        max_keyframes: int, min_gap: int, window: int, device: str = "cpu",
        snapshot: int | None = None):
    """The run's (path, ground truth, GraphSlam, chunk records as dicts,
    seconds)."""
    if package == "jax":
        from lidar_slam_tpu import config
        from lidar_slam_tpu.io import dataset
        from lidar_slam_tpu.models import graph_slam
        kw = {}
    else:
        from lidar_slam_tpu_torch import config
        from lidar_slam_tpu_torch.io import dataset
        from lidar_slam_tpu_torch.models import graph_slam
        kw = {"device": device}
    if world == "building":
        from lidar_slam_tpu_torch.io import simulate
        name = "BUILDING_CONFIG" if window == 1 else "BUILDING_WIDE_CONFIG"
        ranges, gt = dataset.ensure_dataset(
            n_scans=n_scans or simulate.BUILDING_N_SCANS, seed=0,
            world="building")[:2]
    else:
        from lidar_slam_tpu_torch.io import simulate
        name = "DEFAULT_CONFIG"
        ranges, gt = simulate.generate_dataset(
            n_scans or 200, seed=1, waypoints=simulate.LOOP_WAYPOINTS)
    cfg = getattr(config, name)
    gs = graph_slam.GraphSlam(cfg, graph_slam.LoopClosureConfig(
        min_gap=min_gap), max_keyframes=max_keyframes, **kw)
    if package == "jax":
        _jax_chunk_log(gs)
    _record_feedbacks(gs)
    if snapshot is not None:
        _snapshot(gs, snapshot, chunk)
        gs.snapshot.update(first=snapshot, config=name,
                           ranges=np.asarray(ranges[snapshot:snapshot + chunk]))
    t0 = time.perf_counter()
    path, _ = gs.run(ranges, chunk_size=chunk)
    seconds = time.perf_counter() - t0
    if package == "jax":
        gs.flush_chunk_log()
        log = gs.chunk_log
    else:
        log = [r._asdict() for r in gs.chunk_log]
    return np.asarray(path), gt, gs, log, seconds


def report(path, gt, gs, log, seconds) -> str:
    from lidar_slam_tpu_torch.utils.metrics import ate

    lines = []
    for r in log:
        d = "-" if r["delta"] is None else f"{r['delta']:.6f}"
        e = ("-" if r["error_per_edge"] is None
             else f"{r['error_per_edge']:.6f}")
        lines.append(f"chunk@{r['first_scan']}: keyframes {r['keyframes']} "
                     f"(made {r['made']}), closures {r['closures']} (weak "
                     f"{r['weak']}), delta {d}, feedback "
                     f"{int(r['feedback'])}, error/edge {e}")
    sat = gs.saturated_at
    err = np.hypot(*(path[:, :2] - gt[:, :2]).T)
    first_m = int(np.argmax(err > 1.0)) if (err > 1.0).any() else None
    lines.append(f"store filled at scan {sat}; feedback chunks "
                 f"{[r['first_scan'] for r in log if r['feedback']]}; "
                 f"closures {len(gs.closures)}; keyframes "
                 f"{int(gs._kf_count)}; ATE {ate(path, gt):.4f} m; largest "
                 f"error {err.max():.4f} m; first scan with error > 1 m "
                 f"{first_m}; {seconds:.1f} s")
    return "\n".join(lines)


def save(fname, path, gt, gs, log) -> None:
    """The run's path, ground truth, optimized keyframe poses, feedback
    inputs, chunk records and snapshot (if one was taken), in one
    ``.npz``."""
    keys = ("first_scan", "keyframes", "made", "closures", "weak", "delta",
            "feedback", "error_per_edge")
    rows = np.asarray([[np.nan if r[k] is None else float(r[k])
                        for k in keys] for r in log], np.float64)
    np.savez(fname, path=path, gt=gt, kf_poses=np.stack(gs.kf_poses),
             feedbacks=np.asarray(gs.feedbacks, np.float32).reshape(-1, 4, 3),
             chunks=rows, chunk_keys=np.asarray(keys),
             saturated_at=-1 if gs.saturated_at is None else gs.saturated_at,
             **snapshot_arrays(gs))


def snapshot_arrays(gs) -> dict:
    snap = getattr(gs, "snapshot", None)
    if not snap:
        return {}
    out = _flat("snap_state", snap["state"])
    if "graph" in snap:   # the chunk ran an optimize
        out.update({f"snap_graph/{i}": np.asarray(a)
                    for i, a in enumerate(snap["graph"])})
        out.update(snap_before=snap["before"], snap_after=snap["after"],
                   snap_delta=snap["delta"])
    out.update(snap_first=snap["first"],
               snap_config=snap["config"], snap_ranges=snap["ranges"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=["torch", "jax"], default="torch")
    ap.add_argument("--world", choices=["building", "loop"],
                    default="building")
    ap.add_argument("--scans", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--max-keyframes", type=int, default=512)
    ap.add_argument("--min-gap", type=int, default=10)
    ap.add_argument("--window", type=int, choices=[1, 2], default=2,
                    help="the building's matcher window: 2 is "
                    "BUILDING_WIDE_CONFIG, 1 BUILDING_CONFIG")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--save", default=None,
                    help="write path, keyframes, feedbacks and chunk "
                    "records to this .npz")
    ap.add_argument("--snapshot", type=int, default=None,
                    help="(port) save the frontend state, pose graph and "
                    "optimize of the chunk starting at this scan with "
                    "--save")
    ap.add_argument("--replay", default=None,
                    help="feed a saved snapshot's state and graph to "
                    "--package on the CPU and compare (building, window 2)")
    a = ap.parse_args()
    if a.replay:
        print(replay(a.replay, a.package), flush=True)
        return
    path, gt, gs, log, seconds = run(a.package, a.world, a.scans, a.chunk,
                                     a.max_keyframes, a.min_gap, a.window,
                                     a.device, a.snapshot)
    print(report(path, gt, gs, log, seconds), flush=True)
    for i, f in enumerate(gs.feedbacks):
        print(f"feedback {i}: store's last keyframe {f[0]}, frontend's "
              f"last keyframe {f[1]}, pose {f[2]} -> {f[3]}", flush=True)
    if a.save:
        save(a.save, path, gt, gs, log)


if __name__ == "__main__":
    main()
