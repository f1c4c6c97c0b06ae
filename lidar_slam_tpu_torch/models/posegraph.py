"""SE(2) pose graph and damped Gauss-Newton optimization (counterpart of
``lidar_slam_tpu.models.posegraph``).

The graph has fixed capacity (K nodes, E edges) with activity masks, as in
the JAX package; ``add_node``/``add_edge`` past capacity write nothing (JAX's
``mode="drop"``), by masking the slot instead of indexing out of range.

Each Gauss-Newton iteration takes the per-edge 3x3 Jacobians in closed form
(the JAX package differentiates ``_edge_residual`` with ``jacfwd``), applies
the Huber reweighting, assembles the normal equations by scatter-add into
(K, K, 3, 3) blocks, adds the gauge prior on node 0, identity rows for
inactive nodes and the damping, and solves the dense (3K, 3K) system.

Determinism: a CUDA scatter-add sums in an order that changes from run to
run, so the blocks are accumulated in float64 and rounded to float32 once;
two runs on the card then give the same system. The dense solve is a library
call, as in the JAX package (a plain product outside any kernel); TF32 plays
no part in it.

``OptimizeFn`` is the counterpart of JAX's jitted ``optimize``: its loop
body, one iteration, as a CUDA graph over a static graph of fixed capacity
(``utils/graphs``), replayed once an iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_tpu_torch.core import se2
from lidar_slam_tpu_torch.device import resolve_device, rounded64
from lidar_slam_tpu_torch.utils import graphs


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (K, 3) standard convention
    node_active: torch.Tensor  # (K,) bool
    n_nodes: torch.Tensor      # () i32
    edge_i: torch.Tensor       # (E,) i32
    edge_j: torch.Tensor       # (E,) i32
    edge_z: torch.Tensor       # (E, 3) measured relative pose (frame i)
    edge_w: torch.Tensor       # (E, 3) diagonal information (wx, wy, wtheta)
    edge_active: torch.Tensor  # (E,) bool
    n_edges: torch.Tensor      # () i32


def empty_graph(max_nodes: int, max_edges: int,
                device: str | torch.device = "cuda") -> PoseGraph:
    f32, i32 = torch.float32, torch.int32
    device = resolve_device(device)
    return PoseGraph(
        poses=torch.zeros((max_nodes, 3), dtype=f32, device=device),
        node_active=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        n_nodes=torch.zeros((), dtype=i32, device=device),
        edge_i=torch.zeros(max_edges, dtype=i32, device=device),
        edge_j=torch.zeros(max_edges, dtype=i32, device=device),
        edge_z=torch.zeros((max_edges, 3), dtype=f32, device=device),
        edge_w=torch.ones((max_edges, 3), dtype=f32, device=device),
        edge_active=torch.zeros(max_edges, dtype=torch.bool, device=device),
        n_edges=torch.zeros((), dtype=i32, device=device))


def add_node(g: PoseGraph, pose: torch.Tensor
             ) -> tuple[PoseGraph, torch.Tensor]:
    """Append a node (nothing is written at capacity). Returns (graph,
    node_id)."""
    k = g.n_nodes
    kmax = g.poses.shape[0]
    hit = torch.arange(kmax, device=g.poses.device) == k
    poses = torch.where(hit[:, None], pose.to(g.poses.dtype), g.poses)
    return g._replace(poses=poses, node_active=g.node_active | hit,
                      n_nodes=torch.clamp(k + 1, max=kmax).to(torch.int32)), k


def add_edge(g: PoseGraph, i, j, z: torch.Tensor, w: torch.Tensor,
             valid=True) -> PoseGraph:
    """Append an edge with measurement z = (i (-) j) and diagonal info w.

    ``valid=False`` burns no slot (masked insertion); at capacity nothing
    is written."""
    dev = g.edge_i.device
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    e = g.n_edges
    emax = g.edge_i.shape[0]
    slot = torch.where(valid, e, emax)
    hit = torch.arange(emax, device=dev) == slot
    i = torch.as_tensor(i, device=dev).to(torch.int32)
    j = torch.as_tensor(j, device=dev).to(torch.int32)
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    return g._replace(
        edge_i=torch.where(hit, i, g.edge_i),
        edge_j=torch.where(hit, j, g.edge_j),
        edge_z=torch.where(hit[:, None], z, g.edge_z),
        edge_w=torch.where(hit[:, None], w, g.edge_w),
        edge_active=g.edge_active | hit,
        n_edges=torch.clamp(e + valid.to(torch.int32), max=emax).to(
            torch.int32))


def _edge_residual(xi: torch.Tensor, xj: torch.Tensor, z: torch.Tensor
                   ) -> torch.Tensor:
    r = se2.between(xi, xj) - z
    return torch.cat([r[..., :2], se2.wrap_angle(r[..., 2:3])], dim=-1)


def _edge_jacobians(xi: torch.Tensor, xj: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """d residual / d xi and d residual / d xj, (E, 3, 3) each, in closed
    form (the angle wraps have unit slope)."""
    ct, st = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    one, zero = torch.ones_like(ct), torch.zeros_like(ct)
    ji = torch.stack([
        torch.stack([-ct, -st, -st * dx + ct * dy], -1),
        torch.stack([st, -ct, -ct * dx - st * dy], -1),
        torch.stack([zero, zero, -one], -1)], dim=1)
    jj = torch.stack([
        torch.stack([ct, st, zero], -1),
        torch.stack([-st, ct, zero], -1),
        torch.stack([zero, zero, one], -1)], dim=1)
    return ji, jj


def _huber_chi(wmask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each edge's weighted residual norm ||r||_W, the same bits on the card
    as on the CPU: its three terms added left to right, as the CPU's row
    sum adds them (the card's reduction adds in another order), and the
    sqrt taken in float64 and rounded once (the card's f32 sqrt is not
    correctly rounded; the CPU's is, and equals this)."""
    q = wmask * r * r
    return rounded64(torch.sqrt, torch.clamp(q[:, 0] + q[:, 1] + q[:, 2],
                                             min=1e-12))


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-4,
             robust: bool = True, huber_delta: float = 3.0) -> PoseGraph:
    """Damped Gauss-Newton over all active nodes and edges, fixed shapes.

    ``robust=True`` scales each edge's weight by min(1, delta/||r||_W)
    (Huber-style iteratively reweighted least squares), so a single bad
    loop closure cannot drag the whole graph."""
    poses = g.poses
    for _ in range(iters):
        poses = _gn_step(g, poses, damping, robust, huber_delta)
    return g._replace(poses=poses)


def _gn_step(g: PoseGraph, poses: torch.Tensor, damping: float,
             robust: bool, huber_delta: float) -> torch.Tensor:
    """One damped Gauss-Newton iteration of ``g`` from ``poses``: the new
    poses."""
    kmax = g.poses.shape[0]
    dev = g.poses.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    active = g.edge_active.to(torch.float32)[:, None]
    node = g.node_active.to(torch.float32)
    diag = torch.arange(3 * kmax, device=dev)
    extra = (torch.where(diag < 3, 1e6, 0.0)
             + (1.0 - node)[:, None].expand(kmax, 3).reshape(-1) + damping)
    xi, xj = poses[ei], poses[ej]
    ji, jj = _edge_jacobians(xi, xj)
    r = _edge_residual(xi, xj, g.edge_z)
    wmask = g.edge_w * active
    if robust:
        chi = _huber_chi(wmask, r)
        wmask = wmask * torch.clamp(huber_delta / chi, max=1.0)[:, None]
    wji = wmask[:, :, None] * ji
    wjj = wmask[:, :, None] * jj
    h_ii = torch.einsum("eab,eac->ebc", ji, wji)
    h_jj = torch.einsum("eab,eac->ebc", jj, wjj)
    h_ij = torch.einsum("eab,eac->ebc", ji, wjj)
    b_i = torch.einsum("eab,ea->eb", ji, wmask * r)
    b_j = torch.einsum("eab,ea->eb", jj, wmask * r)

    f64 = torch.float64
    hb = torch.zeros((kmax, kmax, 3, 3), dtype=f64, device=dev)
    hb.index_put_((ei, ei), h_ii.to(f64), accumulate=True)
    hb.index_put_((ej, ej), h_jj.to(f64), accumulate=True)
    hb.index_put_((ei, ej), h_ij.to(f64), accumulate=True)
    hb.index_put_((ej, ei), h_ij.transpose(1, 2).to(f64), accumulate=True)
    b = torch.zeros((kmax, 3), dtype=f64, device=dev)
    b.index_put_((ei,), b_i.to(f64), accumulate=True)
    b.index_put_((ej,), b_j.to(f64), accumulate=True)

    h = hb.to(torch.float32).permute(0, 2, 1, 3).reshape(3 * kmax, 3 * kmax)
    h = h + torch.diag(extra)
    delta, _ = torch.linalg.solve_ex(h, -b.to(torch.float32).reshape(-1))
    new = poses + delta.reshape(kmax, 3) * node[:, None]
    return torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1)


class OptimizeFn:
    """``fn(g, iters, ...) -> PoseGraph``: ``optimize`` over one static
    ``PoseGraph`` of ``max_nodes`` nodes and ``max_edges`` edges,
    ``fn.graph``, as JAX's ``fori_loop`` runs it: one Gauss-Newton
    iteration captured as a CUDA graph (``utils/graphs``) per
    ``(damping, robust, huber_delta)``, replayed ``iters`` times over the
    static poses ``fn.poses``.

    Fill ``fn.graph`` on the host with ``load`` and pass it, or pass a
    graph of its shapes, which is copied in. The result is ``fn.graph``
    with its poses replaced by ``fn.poses``, which holds them until the
    next call. On the CPU the same iteration runs uncaptured on the same
    buffers."""

    def __init__(self, max_nodes: int, max_edges: int,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.graph = empty_graph(max_nodes, max_edges, self.device)
        self.poses = torch.zeros_like(self.graph.poses)
        self.graphs = graphs.Graphs(self.device)

    def load(self, arrays) -> PoseGraph:
        """Write host arrays (numpy, ``PoseGraph``'s fields in order) into
        ``fn.graph`` without a host sync; returns ``fn.graph``."""
        for buf, a in zip(self.graph, arrays, strict=True):
            graphs.upload(buf, a)
        return self.graph

    def __call__(self, g: PoseGraph, iters: int = 10, damping: float = 1e-4,
                 robust: bool = True, huber_delta: float = 3.0) -> PoseGraph:
        if g is not self.graph:
            graphs.copy_into(self.graph, g)
        self.poses.copy_(self.graph.poses)

        def body(bufs) -> None:
            static, poses = bufs
            poses.copy_(_gn_step(static, poses, damping, robust,
                                 huber_delta))

        for _ in range(iters):
            self.graphs.run((damping, robust, huber_delta), body,
                            (self.graph, self.poses))
        return self.graph._replace(poses=self.poses)


def graph_error(g: PoseGraph) -> torch.Tensor:
    """Total weighted squared residual over active edges (diagnostics)."""
    r = _edge_residual(g.poses[g.edge_i.long()], g.poses[g.edge_j.long()],
                       g.edge_z)
    return torch.sum(g.edge_w * r * r * g.edge_active.to(torch.float32)[:, None])

