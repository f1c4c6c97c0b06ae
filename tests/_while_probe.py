"""Where the captured EKF step's device time goes with its association loop
as a CUDA graph WHILE node (``utils/graphs.while_loop``), on the card:

    PYTHONPATH=. python tests/_while_probe.py

1. EKF-1024 (``long_tour_config``) on museum scans 101-150 after 100
   unprofiled, through ``EkfStepFn`` (one graph, the WHILE node) and
   through the same step captured as one graph a detection count with the
   loop unrolled on the host (``PerCount``, the form before the WHILE
   node): wall ms a scan (host clock, unprofiled), device ms a scan
   (``torch.profiler``'s device rows), the same final pose, and the kernel
   rows whose device time differs most between the two;
2. the WHILE node's own cost: one graph whose loop body adds to a
   1024-float buffer, replayed 200 times at counts 0 and 16 (CUDA events),
   against the 16 adds unrolled in a graph.

Prints the card's name and power limit first. Needs a CUDA device and
``nvcc``; imports nothing of JAX.
"""

import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
from lidar_slam_tpu_torch.io import dataset
from lidar_slam_tpu_torch.models import ekf_slam
from lidar_slam_tpu_torch.utils import graphs

FIRST, WINDOW = 100, 50   # scans run unprofiled, then measured


class PerCount(ekf_slam.EkfStepFn):
    """``EkfStepFn`` with a graph a detection count ``n``, the association
    loop unrolled on the host (``ekf_slam_step_ml(..., n_det=n)``)."""

    def __call__(self, state, obs, valid, odo, n):
        if state is not self.state:
            self._load(state, obs, valid)
        b = self.bufs
        for buf, x in ((b.obs, obs), (b.valid, valid), (b.odo, odo)):
            buf.copy_(x)
        noise, u0 = ekf_slam.draw(state, self.cfg.n_particles)
        b.noise.copy_(noise)
        b.u0.copy_(u0)

        def body(b):
            new, pose = ekf_slam.ekf_slam_step_ml(
                b.state, b.obs, b.valid, self.cfg, odo=b.odo,
                draws=(b.noise, b.u0), n_det=n)
            graphs.copy_into(b.state, new)
            b.pose.copy_(pose)

        self.graphs.run(n, body, b)
        self.state = b.state._replace(rng=state.rng)
        self.pose = b.pose
        return self.state, b.pose


def device_rows(fn) -> dict:
    """kernel name -> (device ms a scan, launches a scan) of ``fn()``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            rows[ev.key] = (t / WINDOW / 1e3, ev.count / WINDOW)
    return rows


def filter_window(make_step, inputs, dev, ecfg) -> dict:
    """Two fresh runs of scans 1..FIRST + WINDOW: the window unprofiled on
    the host clock, then profiled."""
    out = {}
    for prof in (False, True):
        step = make_step()
        state = ekf_slam.init_ekf_slam(ecfg, 0, dev)
        for t in range(1, FIRST + 1):
            state, _ = step(state, *inputs(t))
        box = [state]

        def window():
            for t in range(FIRST + 1, FIRST + WINDOW + 1):
                box[0], _ = step(box[0], *inputs(t))  # noqa: B023

        if prof:
            out["rows"] = device_rows(window)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            out["wall"] = (time.perf_counter() - t0) / WINDOW * 1e3
        out["pose"], out["graphs"] = step.pose.clone(), len(step.graphs)
    return out


def while_node_cost(dev) -> dict:
    """ms a replay of a graph whose WHILE body adds to a buffer, at counts
    0 and 16, and of the 16 adds unrolled in a graph (CUDA events, 200
    replays)."""
    bufs = {"n": torch.zeros((), dtype=torch.int64, device=dev),
            "x": torch.zeros(1024, device=dev)}

    def looped(b):
        k = torch.zeros((), dtype=torch.int64, device=dev)
        go = b["n"] > k

        def once():
            b["x"].add_(1.0)
            k.add_(1)
            torch.lt(k, b["n"], out=go)

        graphs.while_loop(go, once)

    def unrolled(b):
        for _ in range(16):
            b["x"].add_(1.0)

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = {}
    for label, body, n in (("while n=0", looped, 0),
                           ("while n=16", looped, 16),
                           ("16 adds unrolled", unrolled, 16)):
        runner = graphs.Graphs(dev)
        bufs["n"].fill_(n)
        runner.run(None, body, bufs)
        torch.cuda.synchronize()
        start.record()
        for _ in range(200):
            runner.run(None, body, bufs)
        end.record()
        torch.cuda.synchronize()
        out[label] = start.elapsed_time(end) / 200
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = DEFAULT_CONFIG
    ecfg = ekf_slam.long_tour_config(1024)
    ranges, _ = dataset.ensure_dataset(n_scans=1000, seed=0)
    obs, valid, odo, counts = ekf_slam.scan_inputs(
        ranges[:FIRST + WINDOW + 1], ecfg, cfg.lidar,
        ekf_slam.LONG_TOUR_MAX_RANGE, device=dev)
    counts = counts.tolist()
    print(f"valid rows over scans {FIRST + 1}-{FIRST + WINDOW}: "
          f"{sum(counts[FIRST:FIRST + WINDOW])}", flush=True)
    runs = {
        "a graph a count": filter_window(
            lambda: PerCount(ecfg, dev),
            lambda t: (obs[t - 1], valid[t - 1], odo[t - 1], counts[t - 1]),
            dev, ecfg),
        "WHILE node": filter_window(
            lambda: ekf_slam.EkfStepFn(ecfg, dev),
            lambda t: (obs[t - 1], valid[t - 1], odo[t - 1]), dev, ecfg)}
    a, b = runs["a graph a count"], runs["WHILE node"]
    for label, r in runs.items():
        dev_ms = sum(v[0] for v in r["rows"].values())
        ops = sum(v[1] for v in r["rows"].values())
        print(f"{label} ({r['graphs']} graphs): wall {r['wall']:.4f} ms a "
              f"scan unprofiled, device {dev_ms:.4f} ms a scan, {ops:.1f} "
              f"device ops a scan", flush=True)
    print(f"the same final pose: {torch.equal(a['pose'], b['pose'])}")
    keys = set(a["rows"]) | set(b["rows"])

    def delta(k):
        return b["rows"].get(k, (0, 0))[0] - a["rows"].get(k, (0, 0))[0]

    new = sum(delta(k) for k in keys if k not in a["rows"])
    same = sum(delta(k) for k in keys if k in a["rows"])
    print(f"device ms a scan, WHILE node minus a graph a count: "
          f"{new:+.4f} in kernels only the WHILE step runs, {same:+.4f} in "
          f"kernels both run; the largest rows:")
    for k in sorted(keys, key=lambda k: -abs(delta(k)))[:12]:
        x, y = a["rows"].get(k, (0, 0)), b["rows"].get(k, (0, 0))
        print(f"  {delta(k):+.4f} ms  a graph a count {x[0]:.4f} x{x[1]:.2f}"
              f"  WHILE {y[0]:.4f} x{y[1]:.2f}  {k[:100]}", flush=True)
    cost = while_node_cost(dev)
    print("ms a graph replay: " + "; ".join(f"{k} {v:.5f}"
                                            for k, v in cost.items()))
    print(f"the WHILE node's cost an iteration (a 4-kernel body): "
          f"{(cost['while n=16'] - cost['while n=0']) / 16 * 1e3:.2f} us; "
          f"an add unrolled in a graph "
          f"{cost['16 adds unrolled'] / 16 * 1e3:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
