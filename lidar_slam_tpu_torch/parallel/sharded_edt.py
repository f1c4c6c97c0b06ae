"""Row-block sharded clamped EDT, kernel K1 on every block (counterpart of
``lidar_slam_tpu.parallel.sharded_edt``).

The clamp bounds what a cell sees: its distance is the minimum over
occupied cells within R = max_dist rows and columns. So a block of rows
needs only R rows of occupancy above and below it. Each rank all-gathers
the first and last R rows of its block (uint8, R x W bytes each), takes its
neighbours' as halos (an edge rank pads with empty rows: outside the grid
is free), runs ``ops/edt.edt`` unchanged on its (h + 2R, W) block (kernel
K1 on a CUDA tensor) and crops R rows at each end. The result is the
whole-grid transform's rows exactly.

The JAX package exchanges the row pass's f32 output instead and runs a jnp
min-plus column pass, held to 1e-5. ``edt_row_block`` is the pure per-block
body, so D blocks can also run in one process.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.parallel.mesh import Axis


def edt_row_block(occ_ext: torch.Tensor, max_dist: int = 10) -> torch.Tensor:
    """The clamped EDT of the middle rows of a block extended by
    ``max_dist`` halo rows above and below: (..., h + 2R, W) -> (..., h, W).
    K1 on a CUDA tensor, the plain version on a CPU one."""
    r = int(max_dist)
    return edt_ops.edt(occ_ext, r)[..., r:occ_ext.shape[-2] - r, :]


def _check_height(h: int, n: int, max_dist: int) -> None:
    if h < max_dist:
        raise ValueError(
            f"shard height {h * n}//{n} < max_dist {max_dist}: one-hop halo "
            "exchange needs shard_height >= max_dist")


def extended_blocks(occ: torch.Tensor, n: int, max_dist: int = 10
                    ) -> torch.Tensor:
    """The ``n`` equal row blocks of a whole grid (H, W), each with its
    ``max_dist`` halo rows (empty beyond the grid): (n, H/n + 2R, W)."""
    h_all, w = occ.shape
    if h_all % n:
        raise ValueError(f"{h_all} rows do not split into {n} equal blocks")
    h, r = h_all // n, int(max_dist)
    _check_height(h, n, r)
    pad = F.pad(occ.to(torch.uint8), (0, 0, r, r)).to(torch.bool)
    return torch.stack([pad[i * h:(i + 1) * h + 2 * r] for i in range(n)])


def edt_blocks(occ: torch.Tensor, n: int, max_dist: int = 10
               ) -> torch.Tensor:
    """A whole grid's field computed as ``n`` row blocks in one process,
    one ``edt_row_block`` (one K1 launch on a card) a block: what ``n``
    ranks of ``edt_sharded`` compute, concatenated."""
    return torch.cat([edt_row_block(b, max_dist)
                      for b in extended_blocks(occ, n, max_dist)])


def edt_sharded(occ_local: torch.Tensor, axis: Axis, max_dist: int = 10
                ) -> torch.Tensor:
    """The clamped EDT of this rank's block (h, W) of a grid split into
    equal row blocks over ``axis`` (rank order top to bottom): one
    all-gather of every block's edge rows, then K1 on the extended block."""
    h, w = occ_local.shape
    r = int(max_dist)
    _check_height(h, axis.size, r)
    edges = axis.gather(torch.stack([occ_local[:r], occ_local[h - r:]]))
    empty = torch.zeros((r, w), dtype=torch.bool, device=occ_local.device)
    above = edges[2 * axis.rank - 1] if axis.rank > 0 else empty
    below = edges[2 * axis.rank + 2] if axis.rank < axis.size - 1 else empty
    return edt_row_block(torch.cat([above, occ_local.to(torch.bool), below]),
                         r)


def edt_replicated(occ: torch.Tensor, axis: Axis, max_dist: int = 10
                   ) -> torch.Tensor:
    """A replicated grid's field computed in row blocks over ``axis`` and
    gathered back whole (the sharded PF's ``edt_fn`` on its map axis)."""
    if occ.shape[0] % axis.size:
        raise ValueError(f"{occ.shape[0]} rows do not split into "
                         f"{axis.size} equal blocks")
    return axis.gather(edt_sharded(axis.rows(occ), axis, max_dist))


def replicated_job(occ, max_dist: int = 10, device_type: str = "cuda"
                   ) -> torch.Tensor:
    """``edt_replicated`` of a whole grid on a new "map" mesh over the whole
    world: a job for ``multihost.launch``."""
    from lidar_slam_tpu_torch.parallel.mesh import make_axis

    return edt_replicated(torch.as_tensor(occ, device=device_type),
                          make_axis("map", device_type), max_dist)
