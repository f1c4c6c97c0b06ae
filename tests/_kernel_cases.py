"""Inputs of kernels K1 (clamped EDT), K2 (correlation volume), K3 (the
matcher), K4 (the volume lookups) and K5 (the scan intake) at the shapes the port's main paths launch them with and at their
edges, made with numpy from a seed. Shared by the CPU tests of the kernels'
twins (``test_torch_kernel_twins.py``) and the card's tests
(``test_torch_cuda.py``); imports neither JAX nor the JAX package."""

import zlib

import numpy as np
import torch

from lidar_slam_tpu_torch.ops.correlative import downsample_metric
from lidar_slam_tpu_torch.ops.edt import edt_clamped

# id -> (shape, occupied fraction, R)
K1_CASES = {
    "coarse-200": ((1, 200, 200), 0.01, 10),
    "fine-400": ((1, 400, 400), 0.01, 10),
    "building-512": ((1, 512, 512), 0.005, 10),
    "keyframes-8x256": ((8, 256, 256), 0.01, 10),
    "refine-8x448": ((8, 448, 448), 0.005, 10),
    "empty": ((2, 64, 64), 0.0, 10),
    "full": ((2, 64, 64), 1.0, 10),
    "ragged-37x70": ((3, 37, 70), 0.02, 10),
    "one-row": ((1, 1, 33), 0.1, 10),
    "one-column": ((1, 33, 1), 0.1, 10),
    "wide-5x1100": ((1, 5, 1100), 0.01, 10),
    "r0": ((2, 50, 90), 0.02, 0),
    "r1": ((2, 50, 90), 0.02, 1),
    "r5": ((2, 50, 90), 0.02, 5),
    "r16": ((2, 50, 90), 0.02, 16),
    "r40": ((2, 100, 200), 0.0003, 40),
    "r64": ((1, 160, 200), 0.0005, 64),
}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def k1_case(name: str) -> tuple[torch.Tensor, int]:
    """(occupancy (B, H, W) bool on the CPU, R) of a K1 case."""
    shape, dens, r = K1_CASES[name]
    return torch.as_tensor(_rng(name).random(shape) < dens), r


# id -> (B or None for the unbatched call, T, half, S, extent, cells,
#        cascade factor f, occupied fraction, N)
# extent: "full" (n_rows = n_cols = S), "inside" (S//2 + 3, S - 17) or
# "beyond" (S + 9); cells: "scan" (a scan's beams at every bin, as the
# main paths make them) or "random" (anywhere in [-S/2, 3S/2)).
K2_CASES = {
    "pf-400": (None, 7, 6, 400, "full", "scan", 1, 0.01, 1079),
    "pf-building-512": (None, 13, 6, 512, "full", "scan", 1, 0.005, 1079),
    "closure-8x256": (8, 21, 14, 256, "full", "scan", 1, 0.01, 1079),
    "extent-inside": (None, 7, 6, 128, "inside", "scan", 1, 0.02, 1079),
    "extent-beyond": (2, 5, 6, 128, "beyond", "scan", 1, 0.02, 1079),
    "off-grid": (2, 5, 6, 96, "full", "random", 1, 0.02, 300),
    "half-0": (None, 3, 0, 96, "full", "random", 1, 0.02, 300),
    "half-6": (None, 3, 6, 96, "inside", "random", 1, 0.02, 300),
    "half-14": (2, 3, 14, 96, "full", "random", 1, 0.02, 300),
    "half-20": (None, 3, 20, 96, "beyond", "random", 1, 0.02, 300),
    "cascade-f2": (None, 7, 6, 256, "full", "scan", 2, 0.01, 1079),
    "cascade-f4": (None, 7, 6, 256, "inside", "scan", 4, 0.01, 1079),
    "empty-field": (None, 5, 6, 128, "full", "scan", 1, 0.0, 1079),
    "occupied-field": (None, 5, 6, 128, "full", "scan", 1, 1.0, 1079),
}

# (pixel m, theta step rad, largest range m) of the scan-like cells, by S
_SCAN = {256: (0.2, 0.008727, 24.0)}
_SCAN_DEFAULT = (0.1, 0.004363, 20.0)


def _scan_cells(rng, lead, t_bins, n, s, f):
    """Base cells of a scan seen from the field's centre at every bin: 270
    degrees of beams with ranges that jump between walls, rotated by
    (t - T//2) theta steps, in the (cascade-level) pixel."""
    pixel, step, rmax = _SCAN.get(s * f, _SCAN_DEFAULT)
    pixel, step = pixel * f, step * f
    b = lead[0] if lead else 1
    ang = np.linspace(-2.35, 2.35, n)
    th = (np.arange(t_bins) - t_bins // 2)[:, None] * step
    cx, cy = [], []
    for _ in range(b):
        walls = rng.uniform(1.0, rmax, 6)
        rng_m = walls[(np.floor((ang + 2.35) * 6 / 4.71)).clip(0, 5).astype(int)]
        rng_m = np.clip(rng_m * (1 + 0.3 * np.sin(5 * ang + rng.uniform(0, 6)))
                        + rng.normal(0, 0.05, n), 0.05, rmax)
        cx.append(np.round(s / 2 + rng_m * np.cos(ang + th) / pixel))
        cy.append(np.round(s / 2 + rng_m * np.sin(ang + th) / pixel))
    shape = lead + (t_bins, n)
    return (np.stack(cx).reshape(shape), np.stack(cy).reshape(shape))


def k2_case(name: str):
    """(metric, cx0, cy0, valid, n_rows, n_cols, half, lattice_bits) of a
    K2 case, on the CPU. The field is a clamped EDT on the 2^-10 lattice,
    or for a cascade factor f its min-pooled level on the 2^-(10+l)
    lattice, f = 2^l."""
    b, t_bins, half, s, extent, cells, f, dens, n = K2_CASES[name]
    rng = _rng(name)
    lead = () if b is None else (b,)
    side = s * f
    occ = torch.as_tensor(rng.random(lead + (side, side)) < dens)
    metric = edt_clamped(occ)
    if f > 1:
        from lidar_slam_tpu_torch.core.gridmap import OccGrid

        grid = OccGrid(occ=torch.zeros((side, side), dtype=torch.bool),
                       n_rows=torch.tensor(side), n_cols=torch.tensor(side),
                       origin=torch.zeros(2), pixel=0.1)
        metric = torch.stack([downsample_metric(m, grid, f)[0]
                              for m in metric.reshape(-1, side, side)])
        metric = metric.reshape(lead + (s, s))
    if cells == "scan":
        cx, cy = _scan_cells(rng, lead, t_bins, n, s, f)
    else:
        cx, cy = (rng.integers(-s // 2, 3 * s // 2, lead + (t_bins, n))
                  for _ in range(2))
    n_rows, n_cols = {"full": (s, s), "inside": (s // 2 + 3, s - 17),
                      "beyond": (s + 9, s + 9)}[extent]
    valid = torch.as_tensor(rng.random(lead + (n,)) < 0.9)
    return (metric.contiguous(), torch.as_tensor(cx, dtype=torch.int32),
            torch.as_tensor(cy, dtype=torch.int32), valid, n_rows, n_cols,
            half, 10 + int(np.log2(f)))


def sparse_chunk_case():
    """The "pf-400" case with the first 8-beam chunk split in two halves
    70 cells apart at every bin: its box (83 x 88 cells) fits the planned
    tile but holds more than half as many cells as the chunk's 8 x 7 x 13^2
    gathers."""
    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = k2_case("pf-400")
    cx0, cy0, valid = cx0.clone(), cy0.clone(), valid.clone()
    cx0[:, :4], cy0[:, :4] = 40, 50
    cx0[:, 4:8], cy0[:, 4:8] = 110, 120
    valid[:8] = True
    return metric, cx0, cy0, valid, n_rows, n_cols, half, bits


def batch_prefix(args, b: int):
    """A batched K2 case cut to its first ``b`` fields, as the closure
    passes' last, partial batches are."""
    metric, cx0, cy0, valid, *rest = args
    return (metric[:b], cx0[:b], cy0[:b], valid[:b], *rest)


def to_device(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


# K3 (the matcher): id -> (S, pixel m, window (t and r), field, extent,
# valid, guess). field: "edt" (a clamped EDT of random occupancy), "levels"
# (codes of 0, 1 and 2 px only: frequent exact ties), "flat" (1 px
# everywhere: every candidate that keeps its beams on the grid ties);
# extent: "full" (n_rows = n_cols = S) or "inside" (S//2 + 3, S - 17);
# valid: "prefix" (read_scan's: the first 1000 of 1079 beams) or "none";
# guess: "centre" (the scan's origin at the grid's centre) or "off" (far
# off the grid: every candidate leaves it). At +-4 the kernel's cluster of
# 8 blocks takes 9 headings: one block takes two
K3_CASES = {
    "coarse-200": (200, 0.2, 1, "edt", "full", "prefix", "centre"),
    "fine-400": (400, 0.1, 1, "edt", "full", "prefix", "centre"),
    "wide-256": (256, 0.2, 2, "edt", "full", "prefix", "centre"),
    "wide-512": (512, 0.1, 2, "edt", "inside", "prefix", "centre"),
    "extent-inside": (200, 0.2, 1, "edt", "inside", "prefix", "centre"),
    "levels": (128, 0.2, 1, "levels", "full", "prefix", "centre"),
    "tie-flat": (200, 0.2, 1, "flat", "full", "prefix", "centre"),
    "tie-flat-wide": (200, 0.2, 2, "flat", "full", "prefix", "centre"),
    "all-invalid": (200, 0.2, 1, "edt", "full", "none", "centre"),
    "off-grid": (200, 0.2, 2, "edt", "full", "prefix", "off"),
    "wide-4": (256, 0.2, 4, "edt", "full", "prefix", "centre"),
}
K3_BEAMS, K3_VALID = 1079, 1000
K3_PENALTY = 4.0


def k3_case(name: str):
    """``fast_match``'s arguments for a K3 case, on the CPU: (metric, grid,
    scan_x, scan_y, valid, pose, step_t, step_r, window_t, window_r,
    window_penalty_px). The scan's 270 degrees of
    beams see walls within 0.35 S pixels, from a pose whose heading may lie
    in any quadrant."""
    from lidar_slam_tpu_torch.core.gridmap import OccGrid

    s, pixel, window, field, extent, valid_kind, guess = K3_CASES[name]
    rng = _rng(name)
    if field == "edt":
        metric = edt_clamped(torch.as_tensor(rng.random((s, s)) < 0.01))
    elif field == "levels":
        metric = torch.as_tensor(rng.integers(0, 3, (s, s)), dtype=torch.float32)
    else:
        metric = torch.ones((s, s))
    n = K3_BEAMS
    ang = np.linspace(-2.35, 2.35, n)
    rmax = 0.35 * s * pixel
    walls = rng.uniform(0.2 * rmax, rmax, 6)
    r = walls[np.floor((ang + 2.35) * 6 / 4.71).clip(0, 5).astype(int)]
    r = np.clip(r * (1 + 0.1 * np.sin(5 * ang)) + rng.normal(0, 0.05, n),
                0.05, rmax)
    x = (r * np.cos(ang)).astype(np.float32)
    y = (r * np.sin(ang)).astype(np.float32)
    valid = np.arange(n) < (K3_VALID if valid_kind == "prefix" else 0)
    if valid_kind == "prefix":
        x[~valid], y[~valid] = 0.0, 0.0     # read_scan's zeros past the prefix
    pose = np.asarray([rng.uniform(-20, 20), rng.uniform(-20, 20),
                       rng.uniform(-np.pi, np.pi)], np.float32)
    origin = (pose[:2] - np.float32(s * pixel / 2)).astype(np.float32)
    if guess == "off":
        pose[0] += np.float32(10 * s * pixel)
    n_rows, n_cols = {"full": (s, s), "inside": (s // 2 + 3, s - 17)}[extent]
    grid = OccGrid(occ=torch.zeros((s, s), dtype=torch.bool),
                   n_rows=torch.tensor(n_rows, dtype=torch.int32),
                   n_cols=torch.tensor(n_cols, dtype=torch.int32),
                   origin=torch.as_tensor(origin), pixel=pixel)
    step_t, step_r = pixel / 4, (0.008727 if pixel >= 0.2 else 0.004363)
    return ((metric.contiguous(), grid, torch.as_tensor(x), torch.as_tensor(y),
             torch.as_tensor(valid), torch.as_tensor(pose), step_t, step_r,
             window, window, K3_PENALTY))


def grid_to(grid, device):
    """An ``OccGrid`` with its tensors on ``device``."""
    return grid._replace(**{f: getattr(grid, f).to(device)
                            for f in ("occ", "n_rows", "n_cols", "origin")})


# K4 (the volume lookups): id -> (B, poses a row, T, half, levels, pixel m,
# theta step, spread, volume, mode). B None: an unbatched cascade. spread:
# the poses' offsets from the base pose, uniform within spread x the fine
# window's half-width in x, y and theta (1: all inside it; far beyond it,
# every pose clamps to an edge). volume: "random" (scores and counts, a
# tenth of the counts 0), "zero" (every distance 0: every candidate ties),
# "counts" (the closure's inlier lookup: the counts as scores, ones as
# counts). mode: "cascade" (lookup_cascade) or "distance"
# (lookup_avg_distance, the first level alone). "nan" puts a NaN in a
# tenth of the poses
K4_CASES = {
    "pf-1024": (None, 1024, 7, 6, 1, 0.1, 0.004363, 1.3, "random", "cascade"),
    "building-1024": (None, 1024, 13, 6, 1, 0.1, 0.004363, 1.3, "random",
                      "cascade"),
    "levels-2": (None, 1024, 7, 6, 2, 0.1, 0.004363, 2.6, "random",
                 "cascade"),
    "levels-3": (None, 1024, 7, 6, 3, 0.1, 0.004363, 5.0, "random",
                 "cascade"),
    "closure-8x27": (8, 27, 21, 14, 1, 0.2, 0.008727, 1.3, "random",
                     "distance"),
    "closure-counts-8x1": (8, 1, 21, 14, 1, 0.2, 0.008727, 1.0, "counts",
                           "distance"),
    "far-outside": (None, 256, 7, 6, 1, 0.1, 0.004363, 40.0, "random",
                    "cascade"),
    "far-outside-3": (None, 256, 7, 6, 3, 0.1, 0.004363, 40.0, "random",
                      "cascade"),
    "zero": (None, 64, 7, 6, 1, 0.1, 0.004363, 1.3, "zero", "cascade"),
    "nan": (None, 256, 7, 6, 2, 0.1, 0.004363, 2.6, "random", "cascade"),
}
# the refinement (refine_estimate): the case's volumes, its first pose as
# the estimate, the PF's 27 offsets (fine_t, fine_t, fine_r)
K4_REFINE_CASES = ("pf-1024", "building-1024", "levels-2", "levels-3",
                   "far-outside", "far-outside-3", "zero", "nan")
K4_OFFS27 = np.stack(np.meshgrid(*([np.asarray([-1.0, 0.0, 1.0],
                                               np.float32)] * 3),
                                 indexing="ij"), axis=-1).reshape(27, 3)


def k4_case(name: str):
    """(vols, poses) of a K4 case on the CPU: the cascade's ScoreVolumes,
    finest first, and the poses, (K, 3) or (B, K, 3)."""
    from lidar_slam_tpu_torch.ops.correlative import ScoreVolume

    b, k, t, half, levels, pixel, step, spread, kind, _ = K4_CASES[name]
    rng = _rng(name)
    lead = () if b is None else (b,)
    w = 2 * half + 1
    base = np.stack([rng.uniform(-20, 20, lead), rng.uniform(-20, 20, lead),
                     rng.uniform(-np.pi, np.pi, lead)], -1).astype(np.float32)
    vols = []
    for lvl in range(levels):
        f = 2 ** lvl
        counts = rng.integers(0, 1080, lead + (t, w, w)).astype(np.float32)
        counts[rng.random(counts.shape) < 0.1] = 0.0
        scores = np.round(rng.uniform(0, 8, counts.shape) * counts * 1024
                          ) / np.float32(1024)
        if kind == "zero":
            scores, counts = np.zeros_like(scores), np.ones_like(counts)
        if kind == "counts":
            scores, counts = counts, np.ones_like(counts)
        vols.append(ScoreVolume(
            scores=torch.as_tensor(scores.astype(np.float32)),
            counts=torch.as_tensor(counts), base_pose=torch.as_tensor(base),
            theta_step=float(step * f),
            ipixel=float(np.float32(1.0 / (pixel * f))), half=half))
    reach = np.asarray([half * pixel, half * pixel, (t // 2) * step],
                       np.float32) * np.float32(spread)
    offs = rng.uniform(-1, 1, lead + (k, 3)).astype(np.float32) * reach
    poses = (base[..., None, :] + offs).astype(np.float32)
    if name == "nan":
        poses[rng.random(poses.shape[:-1]) < 0.1, rng.integers(0, 3)] = np.nan
    return vols, torch.as_tensor(poses)


def k4_refine_case(name: str):
    """(vols, est_pose, offs) of a K4 refinement case on the CPU; "nan"
    starts from a NaN heading, so every candidate's distance is NaN."""
    vols, poses = k4_case(name)
    est = poses[0].clone()
    if name == "nan":
        est[2] = float("nan")
    offs = torch.as_tensor(K4_OFFS27 * np.asarray([0.025, 0.025, 0.004363],
                                                  np.float32))
    return vols, est, offs


def vols_to(vols, device):
    """A cascade's ScoreVolumes with their tensors on ``device``."""
    return [v._replace(scores=v.scores.to(device), counts=v.counts.to(device),
                       base_pose=v.base_pose.to(device)) for v in vols]


def vols_prefix(vols, b: int):
    """A batched cascade cut to its first ``b`` rows."""
    return [v._replace(scores=v.scores[:b], counts=v.counts[:b],
                       base_pose=v.base_pose[:b]) for v in vols]


# K5 (the scan intake). Edge cases of one scan at the museum's 1079 beams:
# ranges exactly at the gate's bounds and their float32 neighbours, 0,
# negative ones (-0.0 among them), NaN, +-inf, a scan that keeps no beam and
# one that keeps every beam
K5_EDGES = ("range_min", "usable_range", "zero", "negative", "nan", "inf",
            "all-dropped", "all-valid")
# beams a scan: 1, a warp's 31, the block's 1024, the museum's 1079, and
# the most the kernel's block takes (8 a thread)
K5_BEAMS = (1, 31, 1024, 1079, 8192)


def k5_inputs(ranges, n_beams: int = 1079):
    """``read_scan``'s arguments for K5 on the CPU: (ranges, angles, cfg),
    the angle table of a sensor of ``n_beams`` beams (the museum's
    increment: past 1079 the table turns through several quadrants)."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.core.sensor import beam_angles

    cfg = dataclasses.replace(DEFAULT_CONFIG.lidar, n_beams=n_beams)
    return (torch.as_tensor(np.asarray(ranges, np.float32)),
            torch.as_tensor(beam_angles(cfg)), cfg)


def k5_edge_case(name: str):
    """One scan of the museum's 1079 beams for a K5 edge case: the edge's
    values on every third beam, the others in range."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG

    lc = DEFAULT_CONFIG.lidar
    n = lc.n_beams
    rng = _rng("k5-" + name)
    r = rng.uniform(0.5, 20.0, n).astype(np.float32)
    f32 = np.float32
    lo, hi = f32(lc.range_min), f32(lc.usable_range)
    edge = {
        "range_min": [np.nextafter(lo, f32(0)), lo, np.nextafter(lo, hi)],
        "usable_range": [np.nextafter(hi, lo), hi,
                         np.nextafter(hi, f32(np.inf))],
        "zero": [0.0],
        "negative": [-0.0, -lo, -1.0, -hi],
        "nan": [np.nan],
        "inf": [np.inf, -np.inf],
    }
    if name == "all-dropped":
        r = np.where(np.arange(n) % 2 == 0, f32(0.0), f32(30.0))
    elif name == "all-valid":
        r[::7] = lo
        r[3::7] = hi
    else:
        vals = np.asarray(edge[name], np.float32)
        r[::3] = vals[np.arange(len(r[::3])) % len(vals)]
    return k5_inputs(r.astype(np.float32), n)


def k5_beams_case(n: int):
    """One scan of ``n`` beams: uniform ranges from -1 to 30 m (about a
    fifth gated out), a NaN on every 17th beam."""
    rng = _rng(f"k5-beams-{n}")
    r = rng.uniform(-1.0, 30.0, n).astype(np.float32)
    r[::17] = np.nan
    return k5_inputs(r, n)


def k5_log(n_scans: int = 1000, seed: int = 11):
    """A museum log of ``n_scans`` scans (T, 1079) float32 with dropouts
    added to the simulator's: on about 3% of the beams 0, NaN, +inf, a
    negative range, one past ``usable_range`` or one exactly at either
    bound."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate

    lc = DEFAULT_CONFIG.lidar
    ranges, _ = simulate.generate_dataset(n_scans, seed=seed)
    ranges = np.array(ranges, np.float32)
    rng = np.random.default_rng(seed)
    drop = rng.random(ranges.shape) < 0.03
    vals = np.asarray([0.0, np.nan, np.inf, -2.0, 30.0, lc.range_min,
                       lc.usable_range], np.float32)
    ranges[drop] = vals[rng.integers(0, len(vals), int(drop.sum()))]
    return ranges
