"""Peaks of the card and the least time the kernels' work needs.

The work is counted from what a session needed, never from how the program
launched it: a field of an (H, W) grid reads its H x W occupancy bytes once
and writes H x W f32 distances once, however the grids are batched into
launches; a correlation volume of T headings, n valid beams and a
(2 half + 1)^2 window adds T x n x (2 half + 1)^2 field values, reads the
field, the beams' base cells and validity once and writes its scores once.
A later change that fuses, batches, renames or replaces the kernels leaves
these counts as they are.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12},
}


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def field_bytes(h: int, w: int, count: int = 1) -> int:
    """A clamped distance field of an (h, w) grid: u8 in, f32 out."""
    return count * h * w * (1 + 4)


def volume_ops(t: int, n: int, half: int) -> int:
    """Field values added into one correlation volume."""
    return t * n * (2 * half + 1) ** 2


def volume_bytes(t: int, n: int, half: int, s: int) -> int:
    """One correlation volume: the (s, s) f32 field, two i32 base cells a
    beam and heading and one validity byte a beam read; (t, W, W) f32
    scores written."""
    return s * s * 4 + t * n * 8 + n + t * (2 * half + 1) ** 2 * 4


def least_seconds(work: dict, peak: dict) -> dict:
    """Least device seconds of ``work`` ({"fields": [(h, w, count)],
    "volumes": [(t, n, half, s)]}) on a card with ``peak``: each volume the
    larger of its operations over the f32 rate and its bytes over the
    memory rate; the fields are bound by bytes."""
    k1 = sum(field_bytes(h, w, c) for h, w, c in work["fields"]) / \
        peak["bytes_per_s"]
    k2 = sum(max(volume_ops(t, n, half) / peak["f32_flop_per_s"],
                 volume_bytes(t, n, half, s) / peak["bytes_per_s"])
             for t, n, half, s in work["volumes"])
    return {"k1": k1, "k2": k2}


def kernel_seconds(device_s_by_name: dict, names: tuple[str, ...]) -> float:
    """Device seconds of the trace's operations whose name contains one of
    ``names``."""
    return sum(s for op, s in device_s_by_name.items()
               if any(n in op for n in names))
