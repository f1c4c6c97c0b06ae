#!/usr/bin/env python3
"""Where the device time of kernels K1 and K2 goes, on one GPU.

    python3 kernel_breakdown.py

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
It builds each kernel of ``lidar_slam_tpu_torch/csrc/`` again with one of
its passes cut out (the condition of each loop tagged ``// pass: NAME`` in
the source set to false), and times every variant at the main paths' shapes (the cases of
``tests/_kernel_cases.py``) the way ``chip_smoke.py`` phase 7 does: 100 raw
launches captured in a CUDA graph, one replay timed with CUDA events. The
difference between a variant and the whole kernel is what the pass costs
(passes overlap, so the differences need not add up). It also sweeps K1's
band height and K2's beams per block and tile budget, and times one tiny
graph node, the floor of any launch in a graph.

K1 variants: no pack (occupancy not loaded), no row pass, no column pass
(nothing stored), neither pass. K2 variants: no staging (tile not loaded),
no gather, neither. Only the whole kernels' results are checked (against
the plain versions, exactly); a variant computes nothing useful.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

K1_SRC = "lidar_slam_tpu_torch/csrc/edt.cu"
K2_SRC = "lidar_slam_tpu_torch/csrc/corr_volume.cu"
K1_VARIANTS = {"whole": (), "no pack": ("pack",), "no row pass": ("row",),
               "no column pass": ("col",),
               "neither pass": ("row", "col")}
K2_VARIANTS = {"whole": (), "no staging": ("stage",),
               "no gather": ("gather",),
               "neither": ("stage", "gather")}
K1_CASES = ("coarse-200", "fine-400", "building-512", "keyframes-8x256",
            "refine-8x448")
K2_CASES = ("pf-400", "pf-building-512", "closure-8x256")


_FOR = re.compile(r"for \(([^;]*);[^;]*;")


def cut(source: str, names) -> str:
    """The source with the condition of every loop tagged ``// pass: NAME``
    for a name in ``names`` set to false."""
    lines = source.split("\n")
    for name in names:
        tagged = [i for i, line in enumerate(lines)
                  if line.rstrip().endswith(f"// pass: {name}")]
        if not tagged or any(not _FOR.search(lines[i]) for i in tagged):
            raise SystemExit(f"kernel_breakdown: no for loop tagged "
                             f"'// pass: {name}' in the source")
        for i in tagged:
            lines[i] = _FOR.sub(r"for (\1; false;", lines[i], count=1)
    return "\n".join(lines)


def build(jobs, out_dir: str) -> dict:
    """Build every (key, source text) into its own library, all nvcc
    processes at once; key -> ctypes library with the launchers declared."""
    from lidar_slam_tpu_torch import _build

    nvcc = _build.find_nvcc()
    procs = []
    for i, (key, text) in enumerate(jobs):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{i}.so")
        procs.append((key, so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stderr=subprocess.PIPE, text=True)))
    libs = {}
    for key, so, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"kernel_breakdown: build of {key} failed:\n"
                             f"{err[-3000:]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "lidar_slam_tpu_torch")):
        raise SystemExit("kernel_breakdown: run from the root of a checkout")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: needs a GPU")
    from _kernel_cases import k1_case, k2_case, to_device
    from chip_smoke import graph_time_ms
    from lidar_slam_tpu_torch import _build
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    k1 = pathlib.Path(HERE, K1_SRC).read_text()
    k2 = pathlib.Path(HERE, K2_SRC).read_text()
    jobs = [(("K1", v), cut(k1, names)) for v, names in K1_VARIANTS.items()]
    jobs += [(("K2", v), cut(k2, names)) for v, names in K2_VARIANTS.items()]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(jobs, tmp)

        def k1_time(lib, occ, out, r, band):
            def go():
                _build.check(lib.slam_edt_clamped(
                    occ.data_ptr(), out.data_ptr(), *occ.shape, r, band,
                    stream()), "slam_edt_clamped")
            return graph_time_ms(go) * 1e3

        for case in K1_CASES:
            occ, r = k1_case(case)
            want = edt_clamped(occ, r).to(dev)
            occ = occ.to(dev)
            out = torch.empty(occ.shape, device=dev)
            band = cuda_edt.plan_band(*occ.shape, r, sms)
            row = {v: k1_time(libs[("K1", v)], occ, out, r, band)
                   for v in K1_VARIANTS}
            k1_time(libs[("K1", "whole")], occ, out, r, band)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"kernel_breakdown: K1 differs at {case}")
            sweep = {b: k1_time(libs[("K1", "whole")], occ, out, r, b)
                     for b in (4, 8, 16, 32)}
            print(f"K1 {case} {tuple(occ.shape)} band {band}: "
                  + ", ".join(f"{v} {t:.2f}" for v, t in row.items())
                  + " us | by band: "
                  + ", ".join(f"{b}: {t:.2f}" for b, t in sweep.items()),
                  flush=True)

        def k2_time(lib, args, out, chunk, tile):
            m, cx, cy, v, nr, nc, half, bits = args
            b = m.numel() // m.shape[-1] ** 2
            t, n = cx.shape[-2:]

            def go():
                _build.check(lib.slam_corr_volume(
                    m.data_ptr(), m.shape[-1], cx.data_ptr(), cy.data_ptr(),
                    v.data_ptr(), b, t, n, nr.data_ptr(), nc.data_ptr(),
                    half, bits, chunk, tile, out.data_ptr(), stream()),
                    "slam_corr_volume")
            return graph_time_ms(go) * 1e3

        for case in K2_CASES:
            args = k2_case(case)
            want = score_volume_plain(*args[:7]).to(dev)
            m, cx, cy, v, nr, nc, half, bits = to_device(args, dev)
            ext = [torch.tensor(e, dtype=torch.int32, device=dev)
                   for e in (nr, nc)]
            dargs = (m, cx, cy, v, *ext, half, bits)
            out = torch.empty(want.shape, device=dev)
            b = m.numel() // m.shape[-1] ** 2
            chunk, tile = cuda_match.plan(b, *cx.shape[-2:], half, sms)
            row = {var: k2_time(libs[("K2", var)], dargs, out, chunk, tile)
                   for var in K2_VARIANTS}
            k2_time(libs[("K2", "whole")], dargs, out, chunk, tile)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"kernel_breakdown: K2 differs at {case}")
            sweep = {(c, tl): k2_time(libs[("K2", "whole")], dargs, out, c,
                                      tl)
                     for c in (chunk // 2, chunk, 2 * chunk)
                     for tl in (tile // 2, tile, 2 * tile)}
            print(f"K2 {case} chunk {chunk} tile {tile}: "
                  + ", ".join(f"{var} {t:.2f}" for var, t in row.items())
                  + " us | by (beams a block, tile codes): "
                  + ", ".join(f"{c}/{tl}: {t:.2f}"
                              for (c, tl), t in sweep.items()), flush=True)
    x = torch.empty(1024, device=dev)
    print(f"floor: one tiny fill_ a graph node "
          f"{graph_time_ms(lambda: x.fill_(1.0)) * 1e3:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
