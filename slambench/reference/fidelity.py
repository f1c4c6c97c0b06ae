"""Plain reference of the fidelity scan-to-map pipeline, written from the
reference program's description (``Subsystem_1/main.c``, SURVEY.md §3) in
plain PyTorch: no kernel, no capture, no batching, nothing of the program.

Per scan (main.c:842-961): gate the beams (``range_min <= r <= 24 m``) and
compact them in beam order; on a keyframe step, crop the point map to the
scan's box plus a 1 m border, raster it on the 0.2 m and the 0.1 m grid and
take each grid's clamped distance field; predict with constant velocity;
match on the coarse field (keyframe steps) or the fine one, then on the fine
field, each a first-minimum search over 3 x 3 x 3 candidates; if the match
moved 0.3 m or 5 degrees from the last keyframe, append the beams that land
more than 1.5 cells from the map.

Arithmetic: every float is of ``dtype`` (float32, as the configuration
states; the control runs bfloat16). The reference program's quirks are
kept because they shape the trajectory: the transposed rotation, C
``roundf`` cell snapping, the sin/cos polynomial (Cody-Waite and cephes, the
oracle's ``sincos32``), distances snapped to the 2^-10 lattice, the map
update's use of the last candidate's hits with the best candidate's count
(hits past the last candidate's count read as 0), and the stale world-frame
scan after a keyframe refresh. Square roots are taken in float64 and rounded
once, and no division by a Python number is made, so the result does not
depend on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# sincos32's constants, each exactly its f32 value
_TWO_OVER_PI = float(np.float32(0.63661975))
_H = [float(np.float32(c)) for c in (1.5703125, 4.837512969970703e-4,
                                     7.549789415861596e-8)]
_S = [float(np.float32(c)) for c in (-1.6666654611e-1, 8.3321608736e-3,
                                     -1.9515295891e-4)]
_C = [float(np.float32(c)) for c in (4.166664568298827e-2,
                                     -1.388731625493765e-3,
                                     2.443315711809948e-5)]


def f32(v: float) -> float:
    """A Python float holding ``v`` rounded to f32."""
    return float(np.float32(v))


def roundf(x: torch.Tensor) -> torch.Tensor:
    """C ``roundf``: half away from zero."""
    return torch.trunc(x + torch.sign(x) * 0.5)


def sincos(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin x, cos x): Cody-Waite reduction by pi/2 and cephes minimax
    polynomials, each operation rounded to ``x``'s dtype."""
    t = x * _TWO_OVER_PI
    k = roundf(t)
    r = ((x - k * _H[0]) - k * _H[1]) - k * _H[2]
    r2 = r * r
    sinr = (((r2 * _S[2] + _S[1]) * r2 + _S[0]) * r2) * r + r
    cosr = (((r2 * _C[2] + _C[1]) * r2 + _C[0]) * r2) * r2 + (1.0 - r2 * 0.5)
    q = torch.remainder(k.to(torch.int64), 4)
    sin = torch.where(q == 0, sinr, torch.where(q == 1, cosr, torch.where(
        q == 2, -sinr, -cosr)))
    cos = torch.where(q == 0, cosr, torch.where(q == 1, -sinr, torch.where(
        q == 2, -cosr, sinr)))
    return sin, cos


def quantize(d: torch.Tensor) -> torch.Tensor:
    """Snap a distance to the 2^-10 lattice (roundf semantics)."""
    return torch.trunc(d * 1024.0 + 0.5) * f32(1.0 / 1024.0)


def clamped_edt(occ: torch.Tensor, max_dist: int, dtype) -> torch.Tensor:
    """Clamped Euclidean distance field of a bool grid (..., H, W): 0 on
    occupied cells, else min(distance to the nearest occupied cell,
    max_dist) on the 2^-10 lattice; cells outside the array are free. Two
    windowed passes, squared column then squared row offsets, exact under
    the clamp."""
    r = int(max_dist)
    h, w = occ.shape[-2:]
    big = torch.tensor(3.0e38, dtype=dtype, device=occ.device)
    pad = torch.nn.functional.pad(occ.to(torch.uint8), (r, r)).bool()
    d1 = torch.full(occ.shape, 3.0e38, dtype=dtype, device=occ.device)
    for dx in range(-r, r + 1):
        hit = pad[..., :, dx + r:dx + r + w]
        d1 = torch.minimum(d1, torch.where(hit, float(dx * dx), big))
    d1p = torch.nn.functional.pad(d1, (0, 0, r, r), value=3.0e38)
    d2 = torch.full(occ.shape, 3.0e38, dtype=dtype, device=occ.device)
    for dy in range(-r, r + 1):
        d2 = torch.minimum(d2, d1p[..., dy + r:dy + r + h, :] + float(dy * dy))
    dist = torch.sqrt(d2.to(torch.float64)).to(dtype)
    dist = torch.clamp(dist, max=float(max_dist))
    return torch.where(occ, torch.zeros((), dtype=dtype, device=occ.device),
                       quantize(dist))


class Grid(NamedTuple):
    metric: torch.Tensor   # (S, S) distance field
    n_rows: int
    n_cols: int
    origin_x: torch.Tensor  # () scalar of dtype
    origin_y: torch.Tensor
    pixel: float


class Match(NamedTuple):
    pose: torch.Tensor       # (3,)
    best_count: int
    last_hits: torch.Tensor  # (n,) hits of the last candidate, compacted


class Fidelity:
    """The pipeline on one device in one precision. ``cfg`` is the
    configuration file's ``slam`` dict."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        lid = cfg["lidar"]
        n = lid["n_beams"]
        ang = np.empty(n, np.float32)
        a, inc = np.float32(lid["angle_min"]), np.float32(
            lid["angle_increment"])
        for i in range(n):
            ang[i] = a
            a = np.float32(a + inc)
        self.angles = torch.as_tensor(ang, device=self.device).to(dtype)
        self.sin_a, self.cos_a = sincos(self.angles)

    def t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device).to(self.dtype)

    # -- the scan ------------------------------------------------------------
    def read_scan(self, ranges: torch.Tensor):
        """Gate and compact: (x, y) of the kept beams in beam order."""
        lid = self.cfg["lidar"]
        r = ranges.to(self.device).to(self.dtype)
        ok = (r >= f32(lid["range_min"])) & (r <= f32(lid["usable_range"]))
        return (r * self.cos_a)[ok], (r * self.sin_a)[ok]

    def transform(self, x, y, pose):
        s, c = sincos(pose[2])
        return (c * x + s * y) + pose[0], ((-s) * x + c * y) + pose[1]

    # -- the map ---------------------------------------------------------------
    def grids(self, map_xy, wx, wy):
        """The keyframe arm: crop the map around the scan, raster both
        grids from one set of bounds, and their fields."""
        g = self.cfg["grid"]
        border = f32(g["border_size"])
        min_x, max_x = wx.min() - border, wx.max() + border
        min_y, max_y = wy.min() - border, wy.max() + border
        mx, my = map_xy[:, 0], map_xy[:, 1]
        inside = (mx > min_x) & (mx < max_x) & (my > min_y) & (my < max_y)
        lx, ly = mx[inside], my[inside]
        out = []
        for pixel, size in ((g["coarse_pixel"], g["coarse_size"]),
                            (g["fine_pixel"], g["fine_size"])):
            margin = f32(np.float32(g["margin_pixels"]) * np.float32(pixel))
            x0, y0 = lx.min() - margin, ly.min() - margin
            x1, y1 = lx.max() + margin, ly.max() + margin
            ipix = f32(np.float32(1.0) / np.float32(pixel))
            n_cols = int(roundf((x1 - x0) * ipix).item()) + 1
            n_rows = int(roundf((y1 - y0) * ipix).item()) + 1
            col = roundf((lx - x0) * ipix)
            row = roundf((ly - y0) * ipix)
            keep = (row >= 0) & (row < size) & (col >= 0) & (col < size)
            occ = torch.zeros((size, size), dtype=torch.bool,
                              device=self.device)
            occ[row[keep].long(), col[keep].long()] = True
            metric = clamped_edt(occ, int(g["max_dist_px"]), self.dtype)
            out.append(Grid(metric, n_rows, n_cols, x0, y0, float(pixel)))
        return out

    # -- the matcher ---------------------------------------------------------
    def match(self, grid: Grid, x, y, pose, step_t: float, step_r: float
              ) -> Match:
        """First minimum of the summed field over the 27 candidates, in
        theta, then x, then y order."""
        ipix = f32(np.float32(1.0) / np.float32(grid.pixel))
        px, py = x * ipix, y * ipix
        st_, sr_ = f32(step_t), f32(step_r)
        offs = self.t([-1.0, 0.0, 1.0])
        th = pose[2] + offs * sr_                       # (3,)
        tx = pose[0] + offs * st_
        ty = pose[1] + offs * st_
        s, c = sincos(th)
        rx = px[None] * c[:, None] + py[None] * s[:, None]       # (3, n)
        ry = (-px[None]) * s[:, None] + py[None] * c[:, None]
        offx = (tx - grid.origin_x) * ipix                       # (3,)
        offy = (ty - grid.origin_y) * ipix
        cx = roundf(rx[:, None, None, :] + offx[None, :, None, None]
                    ).to(torch.int64) + 1                        # (3,3,1,n)
        cy = roundf(ry[:, None, None, :] + offy[None, None, :, None]
                    ).to(torch.int64) + 1                        # (3,1,3,n)
        cx, cy = torch.broadcast_tensors(cx, cy)                 # (3,3,3,n)
        inb = (cx > 1) & (cy > 1) & (cx < grid.n_cols) & (cy < grid.n_rows)
        s_ = grid.metric.shape[0]
        vals = grid.metric[(cy - 1).clamp(0, s_ - 1), (cx - 1).clamp(0, s_ - 1)]
        hits = torch.where(inb, vals, torch.zeros((), dtype=self.dtype,
                                                   device=self.device))
        scores = hits.sum(dim=-1).reshape(27)
        best = int(torch.argmin(scores).item())      # the first minimum
        a, b, d = best // 9, (best // 3) % 3, best % 3
        counts = inb.sum(dim=-1).reshape(27)
        last = hits[2, 2, 2][inb[2, 2, 2]]
        last_hits = torch.zeros_like(x)
        last_hits[: last.shape[0]] = last
        return Match(torch.stack([tx[b], ty[d], th[a]]),
                     int(counts[best].item()), last_hits)

    # -- a whole log -----------------------------------------------------------
    def start(self, ranges0) -> "FState":
        x, y = self.read_scan(ranges0)
        pose = self.t([0.0, 0.0, 0.0])
        wx, wy = self.transform(x, y, pose)
        cap = self.cfg["map"]["map_capacity"]
        xy = torch.stack([wx, wy], 1)[:cap]
        return FState(pose=pose, prev=pose, keypose=pose, map_xy=xy,
                      mini=True, grids=None, wx=wx, wy=wy, t=1)

    def step(self, st: "FState", ranges) -> tuple["FState", bool, tuple]:
        """One scan: (next state, keyframe test, (x, y) of the gated
        scan)."""
        cfg = self.cfg
        m, mc = cfg["map"], cfg["matcher"]
        x, y = self.read_scan(ranges)
        wx, wy, grids = st.wx, st.wy, st.grids
        if st.mini:
            wx, wy = self.transform(x, y, st.pose)
            grids = self.grids(st.map_xy, wx, wy)
        coarse, fine = grids
        guess = st.pose + (st.pose - st.prev) if st.t > 1 else st.pose
        m1 = self.match(coarse if st.mini else fine, x, y, guess,
                        mc["coarse_t"], mc["coarse_r"])
        m2 = self.match(fine, x, y, m1.pose, mc["fine_t"], mc["fine_r"])
        new = m2.pose
        dp = torch.abs(new - st.keypose)
        test = bool(((dp[0] > f32(m["mini_update_dt"]))
                     | (dp[1] > f32(m["mini_update_dt"]))
                     | (dp[2] > f32(m["mini_update_dr"]))).item())
        map_xy, keypose = st.map_xy, st.keypose
        if test:
            if not st.mini:
                wx, wy = self.transform(x, y, new)
            n = min(m2.best_count, wx.shape[0])
            sel = m2.last_hits[:n] > f32(m["new_point_threshold"])
            add = torch.stack([wx[:n][sel], wy[:n][sel]], 1)
            room = m["map_capacity"] - map_xy.shape[0]
            map_xy = torch.cat([map_xy, add[:max(room, 0)]])
            keypose = new
        nxt = FState(pose=new, prev=st.pose, keypose=keypose, map_xy=map_xy,
                     mini=test, grids=grids, wx=wx, wy=wy, t=st.t + 1)
        return nxt, test, (x, y)

    def run(self, ranges) -> tuple[np.ndarray, "FState", int]:
        """The whole log: (path (T, 3) f32, final state, keyframe
        refreshes made)."""
        ranges = torch.as_tensor(np.asarray(ranges, np.float32),
                                 device=self.device)
        st = self.start(ranges[0])
        path = [st.pose]
        refreshes = 0
        for t in range(1, ranges.shape[0]):
            refreshes += st.mini
            st, _, _ = self.step(st, ranges[t])
            path.append(st.pose)
        return (torch.stack(path).to(torch.float32).cpu().numpy(), st,
                refreshes)


class FState(NamedTuple):
    pose: torch.Tensor
    prev: torch.Tensor
    keypose: torch.Tensor
    map_xy: torch.Tensor     # (size, 2) map points in insertion order
    mini: bool               # the next step refreshes the grids
    grids: list | None       # [coarse, fine] of the last refresh
    wx: torch.Tensor         # the cached world-frame scan
    wy: torch.Tensor
    t: int                   # index of the next scan


def final_fields(st: FState) -> tuple[np.ndarray, np.ndarray]:
    """The coarse and fine fields of the last refresh, f32 numpy."""
    return tuple(g.metric.to(torch.float32).cpu().numpy() for g in st.grids)
