"""Traffic kind ``paced_stream``, an open loop: the reference's edge
deployment. The benchmark's frozen server (``frozen/server.py``), in a
process of its own, serves the log's rows over the reference's HTTP protocol
(a JSON float array rounded to ``decimals``) through a relay, releasing row N
at row 0's release time + N / ``rate_hz``; the program's
``run_streaming_slam`` is the client.

Set-up makes the log from the seed, starts the server and warms the step
with an unpaced stream of the first ``warm_scans`` rows, a session of its
own. The window is a fresh session from row 0 for ``--seconds`` x
``rate_hz`` rows. Each scan's latency runs from its due release time to its
pose on the host; ``pose_p50_ms`` is taken over every scan after row 0 (row
0 starts the map and has no pose to wait for). A scan whose pose never
comes is failed. How late the server released its rows is printed on
standard error. A ``--trace 1`` run profiles the window.
"""

from __future__ import annotations

import multiprocessing
import sys
import time
import traceback

from slambench import harness
from slambench.frozen import server
from slambench.trace import Tracer


def window_rows(traffic: dict, seconds: float) -> int:
    return int(round(seconds * traffic["rate_hz"]))


def reference_rows(config: dict, traffic: dict, ranges, seconds: float):
    """The rows as served, for the window's scans."""
    n = window_rows(traffic, seconds)
    return server.served_rows(ranges[:n], traffic["decimals"])


class _Chain:
    """The server process and its pipe."""

    def __init__(self, ranges, decimals: int):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=server.serve_chain,
                                args=(ranges, child, decimals), daemon=True)
        self.proc.start()
        if not self.conn.poll(120):
            raise RuntimeError("the server process sent no URL")
        self.url = self.conn.recv()

    def ask(self, *msg):
        self.conn.send(msg)
        if not self.conn.poll(60):
            raise RuntimeError(f"the server process did not answer {msg}")
        return self.conn.recv()

    def close(self) -> None:
        try:
            if self.proc.is_alive():
                self.ask("stop")
        finally:
            self.proc.join(30)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()


def run(system, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float) -> harness.Window:
    ranges, _ = harness.make_tour(config, seed)
    n = window_rows(traffic, seconds)
    if n > ranges.shape[0]:
        raise ValueError(f"{n} rows in the window, the log has "
                         f"{ranges.shape[0]}")
    chain = _Chain(ranges, traffic["decimals"])
    program = None
    try:
        program = system.Program(config, device)
        program.stream(chain.url, traffic["warm_scans"], [])   # warm-up
        harness.sync(device)
        chain.ask("clock")                    # forget the warm-up's rows
        chain.ask("pace", 1.0 / traffic["rate_hz"])
        setup_s = time.perf_counter() - t_start

        lat, outs, errors = [], [], []
        with Tracer(trace) as tr:
            try:
                outs.append(program.stream(chain.url, n, lat))
            except Exception:  # noqa: BLE001 - the missing poses fail
                errors.append(traceback.format_exc())
        t0, due, released = chain.ask("clock")
    finally:
        chain.close()
    peak = harness.memory_peak(device)
    host = [system.to_host(o) for o in outs]
    del program, outs
    # lat[k - 1] is scan k's (arrived, dequeued, pose on host); row k was
    # due at row 0's release + k / rate_hz
    pace = 1.0 / traffic["rate_hz"]
    due_at = [due.get(k, t0 + k * pace) for k in range(1, len(lat) + 1)]
    pose_ms = [(p - d) * 1e3 for (_, _, p), d in zip(lat, due_at)]
    fetch_ms = [(q - d) * 1e3 for (_, q, _), d in zip(lat, due_at)]
    step_ms = [(p - d) * 1e3 for _, d, p in lat]
    late_ms = sorted((released[r] - due[r]) * 1e3 for r in released)
    if late_ms:
        print(f"server: {len(late_ms)} rows released, late by p50 "
              f"{harness.percentile(late_ms, 50):.3f} ms, max "
              f"{late_ms[-1]:.3f} ms", file=sys.stderr)
    failed = (n - 1) - len(lat)
    pose_ms += [float("inf")] * failed     # a pose that never came
    e2e = {"setup_s": setup_s}
    if pose_ms:
        e2e["pose_p50_ms"] = harness.percentile(pose_ms, 50)
    return harness.Window(
        e2e=e2e, attempted=n - 1, failed=failed,
        groups=[(reference_rows(config, traffic, ranges, seconds),
                 host or [None])],
        memory_peak_bytes=peak, trace=tr.summary, traced_group=0,
        data={"fetch_ms": fetch_ms, "step_ms": step_ms,
              "scans_traced": len(lat) if trace else 0},
        errors=errors)
