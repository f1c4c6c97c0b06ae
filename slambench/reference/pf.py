"""Plain reference of the grid-based Rao-Blackwellized particle filter
(the program's ``run_pf``), written from the filter's description
(Grisetti, Stachniss and Burgard, "Improved Techniques for Grid Mapping with
Rao-Blackwellized Particle Filters", IEEE T-RO 23(1), 2007: Gaussian
proposal, importance weights from the scan's fit, systematic resampling
when N_eff < N/2) and the project's own statement of it
(``lidar_slam_tpu_torch/models/fastslam.py``'s docstring), in plain PyTorch:
no kernel, no capture, no fixed-shape buffers, nothing of the program.

Per scan after the first:

1. draw the proposal noise ``randn((P, 3))`` and the resampling offset
   ``rand(()) / P`` from the session's generator (``torch.Generator`` on
   the program's device, seeded with ``pf_seed``): the deployment's data,
   drawn in the program's order;
2. propagate every particle with constant velocity plus the noise scaled
   by (sigma_xy, sigma_xy, sigma_theta);
3. build the correlation volume around the particles' mean: for each of
   the 7 headings and each (dy, dx) of the 13 x 13 window, the plain sum of
   the masked fine field over the beams' base cells;
4. look every particle up in the volume by trilinear interpolation (its
   summed field over its in-bounds count), and weight it by
   ``exp(-d / temperature)`` (a log weight);
5. if the effective sample size falls below ``resample_threshold x P``,
   resample systematically: ancestor i is the number of CDF entries below
   ``u0 + i / P``; the weights reset;
6. estimate the pose as the weighted mean, then move it three times to the
   best of the 27 neighbours (+-1 fine step in x, y and heading) by the
   volume's lookup, the first minimum;
7. if the estimate moved 0.3 m or 5 degrees from the last keyframe (and on
   the first scan), refresh: the beams that land more than 1.5 cells from
   the current field are appended to the point map, the map is cropped to
   the scan's box plus 1 m, rastered on the 400^2 grid at 0.1 m and its
   clamped distance field taken.

Arithmetic: every float is of ``dtype`` (float32, as the configuration
states; the control runs bfloat16); the reductions over the particles (the
mean, the softmax, the CDF, the weighted sums) and the volume's cos/sin are
taken in float64 and rounded once, as the configuration states. The scan
geometry (beam angles, C ``roundf`` cells, the transposed rotation, the
sin/cos polynomial, the 2^-10 distance lattice) is the fidelity
reference's (``reference/fidelity.py``).

Departures from the JAX package's ``fastslam.py``, each kept because it
shapes the trajectory and the program has it too:

- the first scan is scored on a field that is still empty: every pose reads
  0, so each of the three refinements takes the first of the 27 neighbours
  (-1, -1, -1 steps), and the refresh appends every valid beam;
- the interpolation clamps the fractional index into the window (the JAX
  package clamps the corner indices: the same function) and adds the eight
  corners in (heading, y, x) order, the program's, so that the float32
  sums agree bit for bit;
- the volume is summed directly over the beams (the JAX package correlates
  a bfloat16 histogram with the field on the TPU); the two are exact on the
  lattice, so they agree.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.fidelity import (Fidelity, Grid, clamped_edt, f32,
                                          roundf, sincos)

# the 27 neighbours of the refinement, x offset slowest, heading fastest
_OFFS27 = np.stack(np.meshgrid(*([np.asarray([-1.0, 0.0, 1.0], np.float32)]
                                 * 3), indexing="ij"), -1).reshape(27, 3)


class ParticleFilter:
    """The filter on one device in one precision. ``cfg`` is the
    configuration file's ``slam`` dict, ``seed`` its ``pf_seed``."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed = cfg, int(seed)
        self.device, self.dtype = torch.device(device), dtype
        self.geo = Fidelity(cfg, device, dtype)   # beams, sin/cos, transform
        pc = cfg["particles"]
        self.n = int(pc["n_particles"])
        self.sigma = self.geo.t([pc["sigma_xy"], pc["sigma_xy"],
                             pc["sigma_theta"]])
        mc = cfg["matcher"]
        self.offs27 = self.geo.t(_OFFS27 * np.asarray(
            [mc["fine_t"], mc["fine_t"], mc["fine_r"]], np.float32))
        self.resamples = 0
        self.refreshes = 0
        self.vol_beams: list[int] = []

    def div(self, x: torch.Tensor, d: float) -> torch.Tensor:
        """``x / d``, an IEEE division on every device (a divisor of the
        device's own: a Python number may become a reciprocal's
        product)."""
        return x / self.geo.t(d)

    # -- the map --------------------------------------------------------------
    def empty_grid(self) -> Grid:
        s = self.cfg["grid"]["fine_size"]
        z = self.geo.t(0.0)
        return Grid(torch.zeros((s, s), dtype=self.dtype, device=self.device),
                    0, 0, z, z, float(self.cfg["grid"]["fine_pixel"]))

    def raster(self, map_xy: torch.Tensor, wx, wy) -> Grid:
        """Crop the map to the scan's box plus the border, raster it on the
        fine grid and take its clamped distance field."""
        g = self.cfg["grid"]
        border = f32(g["border_size"])
        min_x, max_x = wx.min() - border, wx.max() + border
        min_y, max_y = wy.min() - border, wy.max() + border
        mx, my = map_xy[:, 0], map_xy[:, 1]
        inside = (mx > min_x) & (mx < max_x) & (my > min_y) & (my < max_y)
        lx, ly = mx[inside], my[inside]
        pixel, size = g["fine_pixel"], g["fine_size"]
        if not lx.numel():   # nothing to raster (a control gone astray)
            free = torch.zeros((size, size), dtype=torch.bool,
                               device=self.device)
            return self.empty_grid()._replace(metric=clamped_edt(
                free, int(g["max_dist_px"]), self.dtype))
        margin = f32(np.float32(g["margin_pixels"]) * np.float32(pixel))
        x0, y0 = lx.min() - margin, ly.min() - margin
        x1, y1 = lx.max() + margin, ly.max() + margin
        ipix = f32(np.float32(1.0) / np.float32(pixel))
        n_cols = int(roundf((x1 - x0) * ipix).item()) + 1
        n_rows = int(roundf((y1 - y0) * ipix).item()) + 1
        col = roundf((lx - x0) * ipix)
        row = roundf((ly - y0) * ipix)
        keep = (row >= 0) & (row < size) & (col >= 0) & (col < size)
        occ = torch.zeros((size, size), dtype=torch.bool, device=self.device)
        occ[row[keep].long(), col[keep].long()] = True
        metric = clamped_edt(occ, int(g["max_dist_px"]), self.dtype)
        return Grid(metric, n_rows, n_cols, x0, y0, float(pixel))

    def novel(self, grid: Grid, x, y, pose) -> torch.Tensor:
        """The beams (in scan order) that land in bounds more than
        ``new_point_threshold`` cells from the field, at ``pose``."""
        ipix = f32(np.float32(1.0) / np.float32(grid.pixel))
        px, py = x * ipix, y * ipix
        s, c = sincos(pose[2])
        cx = roundf((px * c + py * s) + (pose[0] - grid.origin_x) * ipix
                    ).to(torch.int64) + 1
        cy = roundf(((-px) * s + py * c) + (pose[1] - grid.origin_y) * ipix
                    ).to(torch.int64) + 1
        inb = (cx > 1) & (cy > 1) & (cx < grid.n_cols) & (cy < grid.n_rows)
        n = grid.metric.shape[0]
        hits = torch.where(inb, grid.metric[(cy - 1).clamp(0, n - 1),
                                            (cx - 1).clamp(0, n - 1)],
                           torch.zeros((), dtype=self.dtype,
                                       device=self.device))
        return (hits > f32(self.cfg["map"]["new_point_threshold"])) & inb

    # -- the correlation volume -----------------------------------------------
    def volume(self, grid: Grid, x, y, base):
        """(scores, counts), each (T, W, W): the summed field and the
        in-bounds beams of the scan at each heading bin and cell offset
        around ``base``."""
        pc = self.cfg["particles"]
        n_t, half = int(pc["vol_theta_bins"]), int(pc["vol_half"])
        ipix = f32(np.float32(1.0 / grid.pixel))
        bins = torch.arange(n_t, dtype=self.dtype, device=self.device)
        th = base[2] + (bins - n_t // 2) * self.cfg["matcher"]["fine_r"]
        ct = torch.cos(th.to(torch.float64)).to(self.dtype)[:, None]
        st = torch.sin(th.to(torch.float64)).to(self.dtype)[:, None]
        px, py = (x * ipix)[None], (y * ipix)[None]
        cx0 = roundf((px * ct + py * st) + (base[0] - grid.origin_x) * ipix)
        cy0 = roundf(((-px) * st + py * ct) + (base[1] - grid.origin_y) * ipix)
        offs = torch.arange(-half, half + 1, device=self.device)
        rows = cy0.to(torch.int64)[..., None] + offs     # (T, n, W)
        cols = cx0.to(torch.int64)[..., None] + offs
        # a cell inside the grid's live extent counts; past the fixed
        # array it reads 0
        row_in = (rows >= 1) & (rows < grid.n_rows - 1)       # (T, n, W)
        col_in = (cols >= 1) & (cols < grid.n_cols - 1)
        counts = (row_in[..., :, None] & col_in[..., None, :]).to(
            self.dtype).sum(dim=1)
        s = grid.metric.shape[0]
        ok = (row_in & (rows < s))[..., :, None] & (col_in & (cols < s))[
            ..., None, :]                                       # (T, n, W, W)
        vals = grid.metric[rows.clamp(0, s - 1)[..., :, None],
                           cols.clamp(0, s - 1)[..., None, :]]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        scores = torch.where(ok, vals, zero).sum(dim=1)
        return scores, counts

    def lookup(self, vol, base, poses) -> torch.Tensor:
        """Average field distance of poses (K, 3): trilinear in the
        volume's scores and counts, the fractional index clamped into the
        window."""
        scores, counts = vol
        n_t, w = scores.shape[0], scores.shape[1]
        half = w // 2
        ipix = f32(np.float32(1.0 / self.cfg["grid"]["fine_pixel"]))
        ft = self.div(poses[:, 2] - base[2], self.cfg["matcher"]["fine_r"]) \
            + n_t // 2
        fy = (poses[:, 1] - base[1]) * ipix + half
        fx = (poses[:, 0] - base[0]) * ipix + half
        ft = torch.clamp(ft, 0.0, float(n_t - 1))
        fy = torch.clamp(fy, 0.0, float(w - 1))
        fx = torch.clamp(fx, 0.0, float(w - 1))
        t0, y0, x0 = torch.floor(ft), torch.floor(fy), torch.floor(fx)
        at, ay, ax = ft - t0, fy - y0, fx - x0
        t0, y0, x0 = t0.long(), y0.long(), x0.long()
        # the eight corners, heading slowest and x fastest: (2, 2, 2, K)
        wgt = (torch.stack([1 - at, at])[:, None, None]
               * torch.stack([1 - ay, ay])[None, :, None]
               * torch.stack([1 - ax, ax])[None, None, :])
        ti = torch.stack([t0, t0 + 1]).clamp(0, n_t - 1)
        yi = torch.stack([y0, y0 + 1]).clamp(0, w - 1)
        xi = torch.stack([x0, x0 + 1]).clamp(0, w - 1)
        flat = ((ti[:, None, None] * w + yi[None, :, None]) * w
                + xi[None, None, :])
        num = (wgt * scores.reshape(-1)[flat]).reshape(8, -1)
        den = (wgt * counts.reshape(-1)[flat]).reshape(8, -1)
        # summed corner by corner, in that order
        total_num, total_den = num[0], den[0]
        for k in range(1, 8):
            total_num = total_num + num[k]
            total_den = total_den + den[k]
        return total_num / torch.clamp(total_den, min=1.0)

    # -- weights --------------------------------------------------------------
    def normalized(self, logw: torch.Tensor) -> torch.Tensor:
        """The normalized weights in float64."""
        return torch.softmax(logw.to(torch.float64), dim=0)

    def ancestors(self, u0: torch.Tensor, logw: torch.Tensor) -> torch.Tensor:
        """Systematic resampling: ancestor i counts the CDF entries below
        the comb's tooth ``u0 + i / P``."""
        p = self.n
        w = self.normalized(logw).to(self.dtype)
        cdf = torch.cumsum(w.to(torch.float64), dim=0).to(self.dtype)
        comb = u0 + self.div(torch.arange(p, dtype=self.dtype,
                                          device=self.device), p)
        idx = (cdf[None, :] < comb[:, None]).sum(dim=1)
        return torch.clamp(idx, 0, p - 1)

    # -- a whole log ----------------------------------------------------------
    def run(self, ranges) -> dict:
        """The whole log: the path (T, 3), the final particles and log
        weights, the point map and the fine field (f32 numpy), with the
        refreshes, resamples and volumes (valid beams of each) made."""
        ranges = torch.as_tensor(np.asarray(ranges, np.float32),
                                 device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        p, m = self.n, self.cfg["map"]
        x, y = self.geo.read_scan(ranges[0])
        zero = self.geo.t([0.0, 0.0, 0.0])
        wx, wy = self.geo.transform(x, y, zero)
        map_xy = torch.stack([wx, wy], 1)[:m["map_capacity"]]
        keypose, grid = zero, self.empty_grid()
        poses = zero.repeat(p, 1)
        prev = zero.repeat(p, 1)
        logw = torch.zeros(p, dtype=self.dtype, device=self.device)
        path = [zero]
        tau = self.cfg["particles"]["score_temperature"]
        for t in range(1, ranges.shape[0]):
            noise = torch.randn((p, 3), generator=gen, device=self.device)
            u0 = torch.rand((), generator=gen, device=self.device) / p
            noise, u0 = noise.to(self.dtype), u0.to(self.dtype)
            x, y = self.geo.read_scan(ranges[t])
            prop = (poses + (poses - prev)) + noise * self.sigma
            base = prop.to(torch.float64).mean(dim=0).to(self.dtype)
            vol = self.volume(grid, x, y, base)
            self.vol_beams.append(int(x.shape[0]))
            logw = logw - self.div(self.lookup(vol, base, prop), tau)
            w = self.normalized(logw)
            ess = (1.0 / torch.sum(w * w)).to(self.dtype)
            if bool(ess < self.cfg["particles"]["resample_threshold"] * p):
                idx = self.ancestors(u0, logw)
                poses, prev = prop[idx], poses[idx]
                logw = torch.zeros_like(logw)
                self.resamples += 1
            else:
                poses, prev = prop, poses
            logw = logw - logw.max()
            w = self.normalized(logw)
            est = torch.sum(w[:, None] * poses.to(torch.float64),
                            dim=0).to(self.dtype)
            for _ in range(3):
                cands = est[None] + self.offs27
                est = cands[int(torch.argmin(self.lookup(vol, base,
                                                         cands)).item())]
            dp = torch.abs(est - keypose)
            moved = bool(((dp[0] > f32(m["mini_update_dt"]))
                          | (dp[1] > f32(m["mini_update_dt"]))
                          | (dp[2] > f32(m["mini_update_dr"]))).item())
            if t == 1 or moved:
                wx, wy = self.geo.transform(x, y, est)
                add = torch.ones_like(x, dtype=torch.bool) if t == 1 \
                    else self.novel(grid, x, y, est)
                room = max(m["map_capacity"] - map_xy.shape[0], 0)
                map_xy = torch.cat([map_xy, torch.stack(
                    [wx[add], wy[add]], 1)[:room]])
                keypose = est
                grid = self.raster(map_xy, wx, wy)
                self.refreshes += 1
            path.append(est)

        def host(v):
            return v.to(torch.float32).cpu().numpy()

        return {"path": host(torch.stack(path)), "poses": host(poses),
                "logw": host(logw), "map_xy": host(map_xy),
                "fine": host(grid.metric)}
