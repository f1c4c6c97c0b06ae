"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and kind, the system's program
entry, plain reference and comparison, and the per-layer readers are found
by name from ``BENCHMARK.json`` (``harness.py``). The run sets up (makes the
log from ``--seed``, builds and warms the program), measures for
``--seconds``, checks what the window produced against the plain reference,
and prints one JSON line as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled stretch of the window. Each number compared
is printed beside its limit as the last lines of standard error and under
the line's last key, ``compared``.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program beside it, or if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def _setup_process() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".slambench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    if sys.path and os.path.abspath(sys.path[0]) == BENCH:
        sys.path.pop(0)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def _finite(v: float) -> float:
    """A number for the JSON line: inf and NaN (a shape that differs, a
    pose that never came) become 1e30."""
    return v if math.isfinite(v) else 1e30


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> tuple[dict, list[str]]:
    """One run of ``cell`` on ``device``: (the result line, the lines for
    standard error)."""
    import torch

    from slambench import harness, roofline
    from slambench.trace import breakdown

    system = harness.system_module(cell.config["system"])
    kind = harness.kind_module(cell.traffic["kind"])
    win = kind.run(system, cell.config, cell.traffic, seed, seconds, trace,
                   device, t_start)
    err = [e.rstrip() for e in win.errors]

    # the plain reference, once the window has closed and its state is gone
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    worst: dict = {}
    work = None
    for i, (rows, outs) in enumerate(win.groups):
        done = [o for o in outs if o is not None]
        if not done:
            continue
        ref = system.reference(cell.config, rows, device, outputs=done)
        for n, v, lim in system.compare(cell.config, done, ref):
            worst[n] = (max(v, worst[n][0]) if n in worst else v, lim)
        if i == win.traced_group:
            work = ref["work"]
    checks = [(n, v, lim) for n, (v, lim) in worst.items()]
    checked = sum(len(o) for _, o in win.groups)
    err.append(f"reference: {time.perf_counter() - t_ref:.3f} s for "
               f"{checked} sessions compared")
    correct = (bool(checks) and win.failed == 0
               and all(o is not None for _, outs in win.groups for o in outs)
               and all(v <= lim for _, v, lim in checks))

    kind_name = (torch.cuda.get_device_name() if device.startswith("cuda")
                 else "cpu")
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": kind_name, "count": cell.chips,
           "memory_peak_bytes": win.memory_peak_bytes}
    metrics = {}
    if trace:
        data = dict(win.data, trace=win.trace, least_s=None)
        peak = roofline.peaks(kind_name)
        if peak is not None and work is not None and win.trace is not None:
            data["least_s"] = roofline.least_seconds(work, peak)
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if win.trace is not None:
            dev["busy_s"] = win.trace.busy_s
            dev["window_s"] = win.trace.window_s
    else:
        for m in cell.end_to_end:
            if m["name"] in win.e2e:
                metrics[m["name"]] = {"value": _finite(win.e2e[m["name"]]),
                                      "unit": m["unit"]}
    line = {"correct": correct, "attempted": win.attempted,
            "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        line["breakdown"] = breakdown(win.trace)
    line["compared"] = {n: {"value": _finite(v), "limit": lim}
                        for n, v, lim in checks}
    err += [f"compared {n} {_finite(v)!r} limit {lim!r}"
            for n, v, lim in checks]
    return line, err


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not readable"
    return "card: " + out.replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_process()

    import torch

    from slambench import harness

    cell = harness.cell(harness.load_spec(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    line, err = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 4
    print(_card_line(), file=sys.stderr)
    print("\n".join(err), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
