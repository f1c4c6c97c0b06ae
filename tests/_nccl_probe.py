"""Where the card's NCCL lets the parallel layer's collectives sit inside a
CUDA graph, on an NCCL world of one card, or of ``--world N`` cards of one
host (a rank a card):

    PYTHONPATH=. python tests/_nccl_probe.py [--world N] [--modes M ...]

For each capture mode ("global", "thread_local", "relaxed": the
``cudaStreamCaptureMode`` of ``utils/graphs.Graphs``'s capture) and each
place (the main graph, the body of an IF node from ``graphs.cond``, the
body of a WHILE node from ``graphs.while_loop``, and the main graph after
an IF node whose arm, with no collective, writes the buffers the
collectives read: the sharded PF step's form), a world of its own
(``multihost.launch``: new spawned processes a case, so a refused capture
cannot spoil the next) captures ``Axis.gather`` (an all-gather) and
``Axis.all_reduce`` there on every rank, replays the graph three times and
checks what came out: every rank's gathered rows in rank order, the sums
over the ranks, and the collectives booked per replay (``Axis`` counts as
``graphs.LaunchBook`` books). It prints a line a case, "ok" or the
refusal's last line, and the table. A world of one may take NCCL's
one-rank path; a world of two or more runs the collectives across cards.

Prints the card's name and power limit first. Needs a CUDA device and
``nvcc``; imports nothing of JAX.
"""

import argparse
import subprocess
import sys

import torch

MODES = ("global", "thread_local", "relaxed")
PLACES = ("main graph", "IF body", "WHILE body", "after an IF node")
REPLAYS = 3
LOOPS = 3   # iterations of the WHILE body a replay


def case(mode: str, place: str) -> str:
    """One case, in a spawned rank of the probe's world; raises if the card
    refuses it or the results are wrong."""
    from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
    from lidar_slam_tpu_torch.utils import graphs

    graphs.CAPTURE_MODE = mode
    dev = torch.device("cuda")
    axis = mesh_lib.make_axis("probe", "cuda")
    w, rank = axis.size, axis.rank
    runner = graphs.Graphs(dev, counters=graphs.COUNTED + (axis,))
    bufs = {"x": torch.zeros((256, 3), device=dev),
            "gathered": torch.zeros((256 * w, 3), device=dev),
            "mine": torch.full((64,), float(rank + 1), dtype=torch.float64,
                               device=dev),
            "summed": torch.zeros(64, dtype=torch.float64, device=dev),
            "pred": torch.ones((), dtype=torch.bool, device=dev),
            # what the "after an IF node" arm writes for the collectives
            "x2": torch.zeros((256, 3), device=dev),
            "part": torch.zeros(64, dtype=torch.float64, device=dev),
            "k": torch.zeros((), dtype=torch.int64, device=dev)}

    def collectives(b, x2=None, part=None):
        x2 = b["x"] * 2.0 if x2 is None else x2
        part = b["mine"] if part is None else part
        b["gathered"].copy_(axis.gather(x2))
        b["summed"].add_(axis.all_reduce(part.clone()))

    def arm(b):   # no collective: it writes what the main graph sends
        b["x2"].copy_(b["x"] * 2.0)
        b["part"].copy_(b["mine"])

    def body(b):
        if place == "main graph":
            collectives(b)
        elif place == "IF body":
            graphs.cond(b["pred"], lambda: collectives(b))
        elif place == "after an IF node":
            graphs.cond(b["pred"], lambda: arm(b))
            collectives(b, b["x2"], b["part"])
        else:
            b["k"].zero_()
            go = b["k"] < LOOPS

            def once():
                collectives(b)
                b["k"].add_(1)
                torch.lt(b["k"], LOOPS, out=go)

            graphs.while_loop(go, once)

    for i in range(REPLAYS):
        bufs["x"].fill_(float(i + 1 + 10 * rank))
        runner.run(None, body, bufs)
    graphs.fetch(runners=[runner])
    per = LOOPS if place == "WHILE body" else 1
    want = REPLAYS * per
    # rank r's rows hold 2 (REPLAYS + 10 r) after the last replay; each
    # all-reduce adds 1 + 2 + ... + w
    rows = torch.arange(w, device=dev).repeat_interleave(256)
    if not torch.equal(bufs["gathered"],
                       (2.0 * (REPLAYS + 10 * rows)).to(torch.float32)
                       [:, None].expand(-1, 3)):
        raise AssertionError("the gathered rows are wrong")
    total = float(want * w * (w + 1) // 2)
    if not torch.equal(bufs["summed"], torch.full_like(bufs["summed"],
                                                       total)):
        raise AssertionError(f"the sums are {bufs['summed'][0].item()}, "
                             f"not {total}")
    if axis.calls != 2 * want:
        raise AssertionError(f"{axis.calls} collectives booked, not "
                             f"{2 * want}")
    return (f"ok: {REPLAYS} replays on {w} ranks, gather and all-reduce "
            f"== expected, "
            f"{axis.calls} collectives booked ({len(runner)} graph, "
            f"{len(runner.arms)} conditional bodies)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=1,
                    help="ranks, one card each (default 1)")
    ap.add_argument("--modes", nargs="+", choices=MODES, default=MODES,
                    help="capture modes to probe (default all)")
    args = ap.parse_args()
    world, modes = args.world, tuple(args.modes)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from lidar_slam_tpu_torch import _build
    from lidar_slam_tpu_torch.parallel import multihost

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, a world of "
          f"{world} on {torch.cuda.device_count()} cards", flush=True)
    _build.load_kernels()   # built once here, not by every case
    table = {}
    for mode in modes:
        for place in PLACES:
            try:
                outs = multihost.launch(world, [(case, (mode, place))],
                                        "cuda", timeout_s=120.0)
                out = outs[0][0]
                table[mode, place] = "ok"
            except Exception as e:  # the case's refusal, printed
                lines = [ln.strip() for ln in str(e).splitlines()
                         if "Error: " in ln] or [repr(e)]
                out = "refused: " + lines[-1]
                table[mode, place] = "refused"
            print(f"{mode:>12} / {place}: {out}", flush=True)
    print("capture mode  | " + " | ".join(PLACES))
    for mode in modes:
        print(f"{mode:<13} | " + " | ".join(table[mode, p] for p in PLACES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
