"""The readings that the limits of ``correct`` are set from (PERF.md).

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 \
        [--program] [--seconds s] [--device cuda]

For each seed it makes the cell's log and the rows its traffic feeds, runs
the plain reference in float32, and prints the numbers that decide
``correct``, each beside its limit:

- ``control``: the reference computed in bfloat16, the precision below the
  configuration's float32, put in the program's place;
- ``program`` (with ``--program``): one session of the program's timed
  entry on the same log (replay cells; a streamed cell's readings are its
  runs' own).

The benchmark's own runs never run this. On the card it reads a cell at its
own size; the tests run it at small sizes.
"""

from __future__ import annotations

import argparse
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def readings(cell, seed: int, seconds: float, device: str,
             program: bool, control: bool = True) -> dict:
    """{"control": checks, "program": checks or None} for one seed."""
    import torch

    from slambench import harness

    system = harness.system_module(cell.config["system"])
    kind = harness.kind_module(cell.traffic["kind"])
    ranges, _ = harness.make_tour(cell.config, seed)
    rows = kind.reference_rows(cell.config, cell.traffic, ranges, seconds)
    out = {"program": None, "control": None}
    if program:
        prog = system.Program(cell.config, device)
        session = system.to_host(prog.replay(rows))
        del prog
        ref = system.reference(cell.config, rows, device, outputs=[session])
        out["program"] = system.compare(cell.config, [session], ref)
    if control:
        low = system.reference(cell.config, rows, device,
                               dtype=torch.bfloat16)
        ref = system.reference(cell.config, rows, device, outputs=[low])
        out["control"] = system.compare(cell.config, [low], ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == BENCH:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from slambench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.cell(spec, args.workload, ROOT)
    seconds = args.seconds or spec["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control_seeds is None else \
        args.control_seeds
    for i, seed in enumerate(seeds):
        r = readings(cell, seed, seconds, args.device, args.program,
                     control=i < n_control)
        for side in ("program", "control"):
            if r[side] is not None:
                print(f"{cell.name} seed {seed} {side}: " + ", ".join(
                    f"{n} {v!r} (limit {lim!r})" for n, v, lim in r[side]),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
