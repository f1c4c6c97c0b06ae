"""Plain reference of graph SLAM with loop closure, in plain PyTorch and
NumPy, written from the JAX package's description of its graph mode
(``lidar_slam_tpu/models/graph_slam.py``'s documented behaviour): nothing of
the program.

The frontend is the fidelity pipeline (``reference.fidelity``). Every scan
whose keyframe test passes becomes a keyframe: a node with an odometry edge
(information 100, 100, 400; a jump far beyond the running speed is clamped
and softened to 4, 4, 16). Scans run in chunks; after each chunk every new
keyframe at least ``min_gap`` keyframes on is matched against its
``max_candidates`` nearest old keyframes within ``max_dist``: the old
keyframe's scan is rastered around its sensor (256 cells of 0.2 m) and
distance-transformed, the new scan's correlation volume (21 headings of
0.5 degrees x 29 x 29 cells) is summed around the odometry guess, and the
guess descends through the volume by trilinear lookups at halving steps. A
match is accepted when its average distance is at most 1.1 cells, at least
75% of its beams land in the window, at most 8 of the volume's cells lie
within 0.25 of its best, and its correction stays inside the window and
inside the drift budget (0.15 m + 3% of the path between the keyframes). An
accepted match is refined on a 448-cell raster of 0.05 m and becomes an edge
(information 50, 50, 200). A chunk with a new closure is followed by ten
damped, Huber-weighted Gauss-Newton iterations over the graph (float64
here), and, when the solve moved a keyframe by more than 1 cm, by a rebuild
of the frontend's map from the keyframe scans at their optimized poses. A
last solve follows the final chunk.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference.fidelity import (FState, Fidelity, Grid,
                                          clamped_edt, f32, roundf)


# -- host SE(2) arithmetic in f32, reference and standard conventions -------
def _f(v):
    return np.asarray(v, np.float32)


def ref_to_std(p):
    return _f([p[0], p[1], -p[2]])


def between_std(p1, p2):
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ct, st = np.cos(p1[2]), np.sin(p1[2])
    dth = p2[2] - p1[2]
    dth = dth - 2.0 * np.pi * np.floor((dth + np.pi) / (2.0 * np.pi))
    return _f([ct * dx + st * dy, -st * dx + ct * dy, dth])


def between_ref(a, b):
    dx, dy = b[0] - a[0], b[1] - a[1]
    ct, st = np.cos(a[2]), np.sin(a[2])
    return _f([ct * dx - st * dy, st * dx + ct * dy, b[2] - a[2]])


def compose_ref(a, z):
    ct, st = np.cos(a[2]), np.sin(a[2])
    return _f([a[0] + ct * z[0] + st * z[1], a[1] - st * z[0] + ct * z[1],
               a[2] + z[2]])


# -- the pose graph ----------------------------------------------------------
def _wrap(a):
    return a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 (kept as float32)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def optimize(poses_std: np.ndarray, edges: list, iters: int = 10,
             damping: float = 1e-4, huber_delta: float = 3.0,
             dtype=np.float64) -> np.ndarray:
    """Damped Gauss-Newton over the SE(2) graph: node 0 held by a prior of
    1e6, each edge's residual ``between(x_i, x_j) - z`` (heading wrapped)
    weighted by its information, scaled by min(1, delta / ||r||_W).
    ``dtype`` "bfloat16" rounds the poses, measurements, residuals,
    Jacobians, normal equations and each update to bfloat16, solving in
    float32."""
    low = isinstance(dtype, str)
    rnd = _bf16 if low else (lambda a: a)
    dtype = np.float32 if low else dtype
    x = rnd(np.asarray(poses_std, dtype))
    k = len(x)
    ei = np.asarray([e[0] for e in edges], np.int64)
    ej = np.asarray([e[1] for e in edges], np.int64)
    z = rnd(np.asarray([e[2] for e in edges], dtype))
    w = rnd(np.asarray([e[3] for e in edges], dtype))
    for _ in range(iters):
        xi, xj = x[ei], x[ej]
        ct, st = rnd(np.cos(xi[:, 2])), rnd(np.sin(xi[:, 2]))
        dx, dy = rnd(xj[:, 0] - xi[:, 0]), rnd(xj[:, 1] - xi[:, 1])
        r = rnd(np.stack([ct * dx + st * dy - z[:, 0],
                          -st * dx + ct * dy - z[:, 1],
                          _wrap(_wrap(xj[:, 2] - xi[:, 2]) - z[:, 2])], 1))
        chi = np.sqrt(np.maximum((w * r * r).sum(1), 1e-12))
        wr = rnd(w * np.minimum(1.0, huber_delta / chi)[:, None])
        zero, one = np.zeros_like(ct), np.ones_like(ct)
        ji = rnd(np.stack([np.stack([-ct, -st, -st * dx + ct * dy], -1),
                           np.stack([st, -ct, -ct * dx - st * dy], -1),
                           np.stack([zero, zero, -one], -1)], 1))
        jj = np.stack([np.stack([ct, st, zero], -1),
                       np.stack([-st, ct, zero], -1),
                       np.stack([zero, zero, one], -1)], 1)
        wji = wr[:, :, None] * ji
        wjj = wr[:, :, None] * jj
        hb = np.zeros((k, k, 3, 3), dtype)
        np.add.at(hb, (ei, ei), np.einsum("eab,eac->ebc", ji, wji))
        np.add.at(hb, (ej, ej), np.einsum("eab,eac->ebc", jj, wjj))
        hij = np.einsum("eab,eac->ebc", ji, wjj)
        np.add.at(hb, (ei, ej), hij)
        np.add.at(hb, (ej, ei), hij.transpose(0, 2, 1))
        b = np.zeros((k, 3), dtype)
        np.add.at(b, ei, np.einsum("eab,ea->eb", ji, wr * r))
        np.add.at(b, ej, np.einsum("eab,ea->eb", jj, wr * r))
        h = rnd(hb.transpose(0, 2, 1, 3).reshape(3 * k, 3 * k))
        b = rnd(b.reshape(-1))
        h[np.arange(3), np.arange(3)] += 1e6
        h[np.arange(3 * k), np.arange(3 * k)] += damping
        x = rnd(x + rnd(np.linalg.solve(h, -b).reshape(k, 3)))
        x[:, 2] = rnd(_wrap(x[:, 2]))
    return x


# -- the closure backend -----------------------------------------------------
class Backend:
    """Keyframe rasters, closure volumes and fine refinement on one device
    in one precision. ``lc`` is the configuration file's ``loop_closure``
    dict."""

    def __init__(self, fid: Fidelity, lc: dict):
        self.fid, self.lc = fid, lc
        self.dev, self.dtype = fid.device, fid.dtype

    def raster_field(self, x, y, pixel: float, size: int, origin: float,
                     true_div: bool) -> torch.Tensor:
        """A scan (n,) rastered in its own frame into (size, size) cells
        (``origin`` the grid's low corner) and its clamped field. Keyframe
        rasters take the cell as roundf(x / pixel) + size / 2 (a negative
        index wraps once, as JAX's drop mode does); refine rasters
        roundf((x - origin) / pixel) by the f32 reciprocal."""
        if true_div:
            div = torch.tensor(pixel, dtype=self.dtype, device=self.dev)
            col = roundf(x / div).to(torch.int64) + size // 2
            row = roundf(y / div).to(torch.int64) + size // 2
            col = torch.where(col < 0, col + size, col)
            row = torch.where(row < 0, row + size, row)
        else:
            ipix = f32(np.float32(1.0) / np.float32(pixel))
            col = roundf((x - origin) * ipix).to(torch.int64)
            row = roundf((y - origin) * ipix).to(torch.int64)
        keep = (row >= 0) & (row < size) & (col >= 0) & (col < size)
        occ = torch.zeros((size, size), dtype=torch.bool, device=self.dev)
        occ[row[keep], col[keep]] = True
        return clamped_edt(occ, 10, self.dtype)

    def keyframe_field(self, x, y) -> torch.Tensor:
        lc = self.lc
        return self.raster_field(x, y, lc["raster_pixel"], lc["raster_size"],
                                 0.0, true_div=True)

    def volume(self, field, x, y, guess):
        """Scores and counts (T, W, W) of the scan around ``guess`` (3,)."""
        lc = self.lc
        size, half, n_t = lc["raster_size"], lc["window_half"], lc["n_theta"]
        ipix = f32(1.0 / lc["raster_pixel"])
        origin = f32(-(size // 2) * lc["raster_pixel"])
        bins = torch.arange(n_t, device=self.dev).to(self.dtype)
        th = guess[2] + (bins - n_t // 2) * f32(lc["theta_step"])
        ct = torch.cos(th.to(torch.float64)).to(self.dtype)[:, None]
        st = torch.sin(th.to(torch.float64)).to(self.dtype)[:, None]
        px, py = (x * ipix)[None], (y * ipix)[None]
        rx = px * ct + py * st
        ry = (-px) * st + py * ct
        cx0 = roundf(rx + (guess[0] - origin) * ipix).to(torch.int64)
        cy0 = roundf(ry + (guess[1] - origin) * ipix).to(torch.int64)
        offs = torch.arange(-half, half + 1, device=self.dev)
        rows = cy0[:, :, None] + offs                   # (T, n, W)
        cols = cx0[:, :, None] + offs
        row_ok = (rows >= 1) & (rows < size - 1)
        col_ok = (cols >= 1) & (cols < size - 1)
        vals = field[rows.clamp(0, size - 1)[:, :, :, None],
                     cols.clamp(0, size - 1)[:, :, None, :]]  # (T, n, W, W)
        ok = row_ok[:, :, :, None] & col_ok[:, :, None, :]
        zero = torch.zeros((), dtype=self.dtype, device=self.dev)
        scores = torch.where(ok, vals, zero).sum(1)
        counts = ok.sum(1).to(self.dtype)
        return scores, counts

    def lookup(self, scores, counts, guess, poses):
        """Trilinear average distance of ``poses`` (m, 3) in the volume
        around ``guess``; poses beyond the window read its edge."""
        lc = self.lc
        n_t, w = scores.shape[0], scores.shape[1]
        ipix = f32(1.0 / lc["raster_pixel"])
        step = torch.tensor(f32(lc["theta_step"]), dtype=self.dtype,
                            device=self.dev)
        fx = (poses[:, 0] - guess[0]) * ipix + lc["window_half"]
        fy = (poses[:, 1] - guess[1]) * ipix + lc["window_half"]
        ft = (poses[:, 2] - guess[2]) / step + n_t // 2
        ft = torch.clamp(ft, 0.0, float(n_t - 1))
        fy = torch.clamp(fy, 0.0, float(w - 1))
        fx = torch.clamp(fx, 0.0, float(w - 1))
        t0, y0, x0 = torch.floor(ft), torch.floor(fy), torch.floor(fx)
        at, ay, ax = ft - t0, fy - y0, fx - x0
        t0, y0, x0 = t0.long(), y0.long(), x0.long()
        num = torch.zeros_like(fx)
        den = torch.zeros_like(fx)
        for dt in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    wgt = ((at if dt else 1 - at) * (ay if dy else 1 - ay)
                           * (ax if dx else 1 - ax))
                    ti = torch.clamp(t0 + dt, 0, n_t - 1)
                    yi = torch.clamp(y0 + dy, 0, w - 1)
                    xi = torch.clamp(x0 + dx, 0, w - 1)
                    num = num + wgt * scores[ti, yi, xi]
                    den = den + wgt * counts[ti, yi, xi]
        return num / torch.clamp(den, min=1.0)

    def match(self, field, x, y, guess_np):
        """(relative pose (3,), average distance, inlier share, cells
        within the ambiguity margin of the best)."""
        lc = self.lc
        guess = torch.as_tensor(guess_np, device=self.dev).to(self.dtype)
        scores, counts = self.volume(field, x, y, guess)
        offs = torch.as_tensor(np.stack(np.meshgrid(
            *([np.asarray([-1.0, 0.0, 1.0], np.float32)] * 3),
            indexing="ij"), -1).reshape(27, 3), device=self.dev
        ).to(self.dtype)
        steps0 = np.asarray([lc["raster_pixel"], lc["raster_pixel"],
                             lc["theta_step"]], np.float32)
        est, avg = guess, None
        for i in range(lc["refine_iters"]):
            step = torch.as_tensor(steps0 * np.float32(2.0 ** -(i // 2)),
                                   device=self.dev).to(self.dtype)
            cands = est[None] + offs * step
            d = self.lookup(scores, counts, guess, cands)
            k = int(torch.argmin(d).item())
            est, avg = cands[k], d[k]
        n_valid = torch.tensor(float(max(x.shape[0], 1)), dtype=self.dtype,
                               device=self.dev)
        inl = self.lookup(counts, torch.ones_like(counts), guess, est[None])[0]
        cell = torch.where(counts > 0.5 * n_valid,
                           scores / torch.clamp(counts, min=1.0),
                           torch.tensor(math.inf, dtype=self.dtype,
                                        device=self.dev))
        near = int((cell <= cell.min() + f32(lc["ambiguity_margin"])).sum())
        # the gates compare f32 values, as the JAX package's host does
        return (est.to(torch.float32).cpu().numpy(),
                np.float32(avg.float().item()),
                np.float32((inl / n_valid).float().item()), near)

    def refine(self, x0, y0, x1, y1, guess_np):
        """The accepted pair re-matched on the fine raster: the new scan
        descends from the coarse estimate in ``fine_iters`` first-minimum
        searches of 27 candidates at halving steps."""
        lc = self.lc
        mr2 = f32(lc["fine_range"] * lc["fine_range"])
        a = (x0 * x0 + y0 * y0) <= mr2
        b = (x1 * x1 + y1 * y1) <= mr2
        size, pixel = lc["fine_size"], lc["fine_pixel"]
        origin = f32(-0.5 * size * pixel)
        field = self.raster_field(x0[a], y0[a], pixel, size, origin,
                                  true_div=False)
        dev = self.dev
        o = torch.tensor(origin, device=dev).to(self.dtype)
        grid = Grid(field, size, size, o, o, pixel)
        pose = torch.as_tensor(guess_np, device=dev).to(self.dtype)
        st_, sr_ = lc["fine_step_t0"], lc["fine_step_r0"]
        for _ in range(lc["fine_iters"]):
            pose = self.fid.match(grid, x1[b], y1[b], pose, st_, sr_).pose
            st_, sr_ = st_ * 0.5, sr_ * 0.5
        return pose.to(torch.float32).cpu().numpy()


# -- the keyframe graph -------------------------------------------------------
class KeyframeGraph:
    """Keyframes, their edges, closures and solves: the graph mode's
    bookkeeping, on the host as the JAX package keeps it."""

    def __init__(self, be: Backend, max_keyframes: int, gn_dtype):
        self.be, self.lc = be, be.lc
        self.max_keyframes, self.gn_dtype = max_keyframes, gn_dtype
        self.scans: list = []       # (x, y) gated scan of each keyframe
        self.fields: list = []      # its 256^2 raster field
        self.poses: list = []       # reference convention, optimized
        self.times: list = []       # scan index of each keyframe
        self.cum: list = []         # path length at each keyframe
        self.edges: list = []
        self.speeds: list = []
        self.jump_kf: set = set()
        self.closures: list = []
        self.jumps: list = []
        self.attempts = self.refined = 0
        self.vol_beams: list = []

    def add(self, x, y, pose, t):
        """A keyframe and its odometry edge (a jump far beyond the running
        speed clamped and softened); None once the store is full."""
        k = len(self.poses)
        if k >= self.max_keyframes:
            return None
        pose = _f(pose)
        if k > 0:
            z = between_std(ref_to_std(self.poses[-1]), ref_to_std(pose))
            w = _f([100.0, 100.0, 400.0])
            step = float(np.hypot(z[0], z[1]))
            gap = max(t - self.times[-1], 1)
            speed = step / gap
            hist = self.speeds[-100:]
            if (len(hist) >= 10 and step > 0.5
                    and speed > 4.0 * float(np.median(hist))):
                bound = 4.0 * float(np.median(hist)) * gap
                z = z.copy()
                z[:2] *= bound / step
                w = _f([4.0, 4.0, 16.0])
                self.jumps.append((k - 1, k, t))
                self.jump_kf.add(k)
            else:
                self.speeds.append(speed)
            self.edges.append((k - 1, k, z, w))
            self.cum.append(self.cum[-1] + float(np.hypot(
                *(pose[:2] - self.poses[-1][:2]))))
        else:
            self.cum.append(0.0)
        self.scans.append((x, y))
        self.poses.append(pose)
        self.times.append(t)
        self.fields.append(self.be.keyframe_field(x, y))
        return k

    def candidates(self, k):
        lc = self.lc
        if k < lc["min_gap"]:
            return []
        wide = any(0 <= k - j <= 6 for j in self.jump_kf)
        radius = lc["max_dist"] * (3.0 if wide else 1.0)
        n_cand = 2 * lc["max_candidates"] if wide else lc["max_candidates"]
        cur = self.poses[k]
        old = [(i, float(np.hypot(*(p[:2] - cur[:2]))))
               for i, p in enumerate(self.poses[: k - lc["min_gap"] + 1])]
        old = sorted([c for c in old if c[1] < radius], key=lambda c: c[1])
        return [i for i, _ in old[:n_cand]]

    def close(self, new_kf) -> bool:
        """Match the new keyframes against their candidates, gate, refine
        the accepted matches and add their edges; True if one was."""
        lc, be = self.lc, self.be
        n_cells = lc["n_theta"] * (2 * lc["window_half"] + 1) ** 2
        strong = []
        for k in new_kf:
            for i in self.candidates(k):
                guess = between_ref(self.poses[i], self.poses[k])
                x, y = self.scans[k]
                rel, avg, inl, near = be.match(self.fields[i], x, y, guess)
                self.attempts += 1
                self.vol_beams.append(int(x.shape[0]))
                off = rel - guess
                max_xy = 0.85 * lc["window_half"] * lc["raster_pixel"]
                max_th = 0.85 * (lc["n_theta"] // 2) * lc["theta_step"]
                if (abs(off[0]) > max_xy or abs(off[1]) > max_xy
                        or abs(off[2]) > max_th):
                    continue
                budget = (lc["consistency_abs"] + lc["consistency_rel"]
                          * abs(self.cum[k] - self.cum[i]))
                if (abs(off[0]) > budget or abs(off[1]) > budget
                        or abs(off[2]) > budget):
                    continue
                if (avg <= lc["accept_avg_dist"]
                        and inl >= lc["min_inlier_frac"]
                        and min(near, n_cells) <= lc["max_ambiguous_cells"]):
                    strong.append((i, k, rel))
        for i, k, rel in strong:
            if lc["fine_refine"]:
                rel = be.refine(*self.scans[i], *self.scans[k], rel)
                self.refined += 1
            self.edges.append((i, k, _f([rel[0], rel[1], -rel[2]]),
                               _f([50.0, 50.0, 200.0])))
            self.closures.append((i, k))
        return bool(strong)

    def solve(self) -> float:
        """Ten Gauss-Newton iterations; the largest keyframe move (m), or
        -1 where the solve is not finite (the poses are kept)."""
        std = np.stack([ref_to_std(p) for p in self.poses])
        opt = optimize(std, self.edges, dtype=self.gn_dtype).astype(
            np.float32)
        if not np.isfinite(opt).all():
            return -1.0
        delta = float(np.max(np.hypot(opt[:, 0] - std[:, 0],
                                      opt[:, 1] - std[:, 1])))
        self.poses[:] = [ref_to_std(p) for p in opt]
        return delta

    def result(self) -> dict:
        return {"kf_poses": np.stack(self.poses).astype(np.float32),
                "kf_times": list(self.times), "closures": list(self.closures),
                "weak_closures": [], "attempts": self.attempts,
                "refined": self.refined, "vol_beams": list(self.vol_beams),
                "fields_made": len(self.fields)}


def _rebuild(fid: Fidelity, kg: KeyframeGraph, st: FState, cap: int
             ) -> FState:
    """The frontend after a solve: re-anchored on the last keyframe's
    optimized pose, its map rebuilt from the keyframe scans at their
    optimized poses (subsampled to capacity)."""
    old_last = st.keypose.to(torch.float32).cpu().numpy()
    cur = st.pose.to(torch.float32).cpu().numpy()
    prev = st.prev.to(torch.float32).cpu().numpy()
    new_last = kg.poses[-1]

    def correct(p):
        return compose_ref(new_last, between_ref(old_last, p))

    poses = np.stack(kg.poses)
    cs = np.cos(poses[:, 2:3], dtype=np.float32)
    sn = np.sin(poses[:, 2:3], dtype=np.float32)
    pts = []
    for (x, y), p, c, s in zip(kg.scans, poses, cs, sn):
        xh = x.to(torch.float32).cpu().numpy()
        yh = y.to(torch.float32).cpu().numpy()
        pts.append(np.stack([c * xh + s * yh + p[0:1],
                             -s * xh + c * yh + p[1:2]], 1))
    allpts = np.concatenate(pts).astype(np.float32)
    if len(allpts) > cap:
        allpts = allpts[:: int(np.ceil(len(allpts) / cap))][:cap]
    pose = fid.t(correct(cur))
    return st._replace(pose=pose, prev=fid.t(correct(prev)), keypose=pose,
                       map_xy=torch.as_tensor(allpts, device=fid.device
                                              ).to(fid.dtype), mini=True)


def _setup(cfg, lc, max_keyframes, device, dtype, gn_dtype):
    if lc["weak_closures"]:
        raise ValueError("the weak closure tier is not in this reference")
    fid = Fidelity(cfg, device, dtype)
    return fid, KeyframeGraph(Backend(fid, lc), max_keyframes, gn_dtype)


def run_graph(ranges, cfg: dict, lc: dict, max_keyframes: int,
              chunk_size: int, device, dtype=torch.float32,
              gn_dtype=np.float64) -> dict:
    """The whole graph mode on a log: frontend, keyframes, closures, solves
    and the frontend's rebuilds. Returns the path (T, 3), the keyframe
    graph's ``result`` and the frontend's keyframe refreshes and
    rebuilds."""
    fid, kg = _setup(cfg, lc, max_keyframes, device, dtype, gn_dtype)
    ranges = torch.as_tensor(np.asarray(ranges, np.float32),
                             device=fid.device)
    st = fid.start(ranges[0])
    kg.add(*fid.read_scan(ranges[0]), np.zeros(3, np.float32), 0)
    path = [np.zeros(3, np.float32)]
    refreshes = feedbacks = 0
    t = 1
    while t < ranges.shape[0]:
        n_real = min(chunk_size, ranges.shape[0] - t)
        new_kf = []
        for i in range(n_real):
            refreshes += st.mini
            st, test, (x, y) = fid.step(st, ranges[t + i])
            pose = st.pose.to(torch.float32).cpu().numpy()
            path.append(pose)
            if test and (k := kg.add(x, y, pose, t + i)) is not None:
                new_kf.append(k)
        if kg.close(new_kf) and kg.solve() > 0.01:
            st = _rebuild(fid, kg, st, cfg["map"]["map_capacity"])
            feedbacks += 1
        t += n_real
    if kg.closures or kg.jumps:
        kg.solve()
    return dict(kg.result(), path=np.stack(path).astype(np.float32),
                refreshes=refreshes, feedbacks=feedbacks)


def follow_backend(ranges, kf_times: list, kf_raw: np.ndarray, cfg: dict,
                   lc: dict, max_keyframes: int, chunk_size: int, device,
                   dtype=torch.float32, gn_dtype=np.float64) -> dict:
    """The backend alone on another run's keyframes: the keyframes at scans
    ``kf_times`` with the frontend poses ``kf_raw``, added chunk by chunk
    as the graph mode adds them, with this reference's own closures and
    solves. Returns the keyframe graph's ``result``."""
    fid, kg = _setup(cfg, lc, max_keyframes, device, dtype, gn_dtype)
    ranges = torch.as_tensor(np.asarray(ranges, np.float32),
                             device=fid.device)
    for t0 in range(1, ranges.shape[0], chunk_size):
        new_kf = []
        for k, t in enumerate(kf_times):
            if (t == 0 and t0 == 1) or t0 <= t < t0 + chunk_size:
                kk = kg.add(*fid.read_scan(ranges[t]), kf_raw[k], t)
                if kk is not None and t > 0:
                    new_kf.append(kk)
        if kg.close(new_kf):
            kg.solve()
    if kg.closures or kg.jumps:
        kg.solve()
    return kg.result()
