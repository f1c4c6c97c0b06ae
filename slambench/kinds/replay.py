"""Traffic kind ``replay``, a closed loop: recorded logs mapped by a fresh
session each, back to back, for the whole window.

Set-up makes a pool of ``logs`` logs of the configuration's tour from the
seed (one trajectory, each log its own range noise and dropouts) and maps
the first in one whole session, so the kernel build and every first use
stay out of the window. The window's sessions map the pool's logs in turn
until ``--seconds`` have passed; the last one runs to its end. Many logs a
window keep one seed's work close to another's. ``scans_per_s`` is the
scans of every session over the window's time, up to the end of the last
session's device sync. Two sessions, drawn from the seed once the window
has closed, are held to the plain reference (a ``--trace 1`` run: the
traced first session and one drawn). A ``--trace 1`` run profiles the
window's first session.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from slambench import harness
from slambench.trace import Tracer

CHECKED = 2   # sessions a run holds to the reference


def reference_rows(config: dict, traffic: dict, ranges, seconds: float):
    """The rows the plain reference takes: the whole log."""
    return ranges


def run(system, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float) -> harness.Window:
    logs, _ = harness.make_logs(config, seed, traffic["logs"])
    program = system.Program(config, device)
    program.replay(logs[0])                       # warm-up session
    harness.sync(device)
    setup_s = time.perf_counter() - t_start

    outs, errors, tr = [], [], None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while not outs or time.perf_counter() < deadline:
        tracing = trace and tr is None
        log = logs[len(outs) % len(logs)]
        try:
            with Tracer(tracing) as t:
                out = program.replay(log)
                harness.sync(device)
            outs.append(out)
        except Exception:  # noqa: BLE001 - a failed session is counted
            outs.append(None)
            errors.append(traceback.format_exc())
            if len(errors) >= 3:
                break
        if tracing:
            tr = t
    t1 = time.perf_counter()
    peak = harness.memory_peak(device)
    done = [o for o in outs if o is not None]
    timer = _merged_timers(done)
    # the sessions held to the reference: drawn from the seed, with the
    # traced one in a traced run
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    order = [int(i) for i in rng.permutation(len(outs))]
    if trace:
        order = [0] + [i for i in order if i]
    picked = sorted(order[:CHECKED])
    groups: dict = {}
    for i in picked:
        groups.setdefault(i % len(logs), []).append(
            None if outs[i] is None else system.to_host(outs[i]))
    del program, outs
    n = logs[0].shape[0]
    return harness.Window(
        e2e={"scans_per_s": len(done) * n / (t1 - t0), "setup_s": setup_s},
        attempted=len(done) + len(errors), failed=len(errors),
        groups=[(reference_rows(config, traffic, logs[j], seconds), o)
                for j, o in groups.items()],
        memory_peak_bytes=peak, trace=tr.summary if tr else None,
        data={"timer": timer, "scans_traced": n if tr else 0},
        traced_group=0 if tr else None, errors=errors)


def _merged_timers(outs: list) -> dict | None:
    """The sessions' ``StageTimer`` seconds and calls by stage, summed, or
    None where the system keeps no timer."""
    if not outs or "timer" not in outs[0]:
        return None
    totals, counts = {}, {}
    for o in outs:
        t, c = o["timer"]
        for k, v in t.items():
            totals[k] = totals.get(k, 0.0) + v
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return {"totals": totals, "counts": counts}
