"""Wrapper of kernel K2, the correlation volume in ``csrc/corr_volume.cu``.

Replaces the TPU kernel ``lidar_slam_tpu/ops/pallas_match.py::
correlate_volume`` (``_corr_kernel``, fed by ``ops/correlative.py::
_volume_pallas``). The TPU correlated a one-hot beam histogram with the whole
field to avoid gathers; on the H100 the direct gather does far less work, so
the kernel gathers directly. One block per (beam chunk, batch element) loops
over every theta bin: it stages the bounding box of its beams' windows in
shared memory once, as exact uint16 lattice codes with the bounds test
folded in (failing cells are 0), sums each (bin, offset) in int32 registers
and adds it to the output with one float atomic — exact, since every addend
is on the field's 2^-q lattice. ``csrc/corr_volume.cu`` has the details.

The kernel takes a leading batch axis (one launch matches a scan against B
fields, as loop closure does with its candidates); the particle filter's
unbatched call is the case B = 1. Held to the plain
``ops.correlative.score_volume_plain`` with ``torch.equal`` on EDT fields.
"""

from __future__ import annotations

import collections
import functools

import torch

from lidar_slam_tpu_torch import _build

# kernel launches made through this wrapper since the last reset; a replay
# of a captured graph adds the launches it holds (``utils/graphs``)
launches = 0
# the same launches keyed by (B, T, half, S)
launches_by_shape: collections.Counter = collections.Counter()

TILE_CELLS = 16 * 1024     # default tile budget: 32 KB of uint16 codes
SMEM_BYTES = 232448        # shared memory one block may use on Hopper
BASE_INTS = 2048           # cap on a block's (bin, beam) cells, T * chunk
BLOCKS_PER_SM = 2          # the grid the chunk size aims at
LATTICE_BITS = 10          # EDT fields are on the 2^-10 lattice


def tile_pitch(width: int) -> int:
    """Row pitch of a staged tile, in codes: >= width and = 32 (mod 64)."""
    return (width + 31) // 64 * 64 + 32


def window_cells(half: int) -> int:
    """Codes of the largest tile one window can need (W rows of a width
    rounded out to whole quads): the least tile budget."""
    w = 2 * half + 1
    return w * tile_pitch((w + 6) & ~3)


def smem_bytes(t_bins: int, chunk: int, tile_cells: int) -> int:
    """A block's shared memory: window origins (bins padded to 4), clamped
    base cells and live list, padded to 16 bytes, then the tile (the
    formula of ``csrc/corr_volume.cu``)."""
    cpad = -(-chunk // 4) * 4
    ints = t_bins * cpad + 2 * t_bins * chunk + chunk
    return 4 * -(-ints // 4) * 4 + 2 * tile_cells


def plan(b: int, t_bins: int, n: int, half: int, sms: int
         ) -> tuple[int, int]:
    """(beams per block, tile budget in codes) for a launch: at most
    ``BLOCKS_PER_SM`` blocks an SM (one wave) where 8 beams a block allow
    it, and a budget of at least one window. Raises for a window that no
    block's shared memory can hold."""
    per_b = max(1, BLOCKS_PER_SM * sms // max(b, 1))
    chunk = max(8, -(-n // per_b))
    chunk = max(1, min(chunk, BASE_INTS // max(t_bins, 1)))
    w = 2 * half + 1
    tile = max(TILE_CELLS, window_cells(half))
    if smem_bytes(t_bins, chunk, tile) > SMEM_BYTES:
        raise ValueError(f"half {half}: one {w}x{w} window does not fit "
                         f"the kernel's shared memory")
    return chunk, tile


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _extent(v, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int32, device=device)
    if t.shape != () or t.device != device:
        raise ValueError("n_rows/n_cols must be ints or 0-dim int32 tensors "
                         "on the metric's device")
    return t.contiguous()


def launch(metric: torch.Tensor, cx0: torch.Tensor, cy0: torch.Tensor,
           valid: torch.Tensor, n_rows: torch.Tensor, n_cols: torch.Tensor,
           half: int, scores: torch.Tensor,
           lattice_bits: int = LATTICE_BITS, chunk: int | None = None,
           tile_cells: int | None = None) -> None:
    """One raw launch on the current stream into the preallocated
    ``scores`` (B, T, W, W): metric (B, S, S), cx0/cy0 (B, T, N), valid
    (B, N), n_rows/n_cols 0-dim int32 tensors, all contiguous on one card.
    No checks and no count; ``score_volume_cuda`` is the checked entry.
    ``chunk`` and ``tile_cells`` override the planned beams per block and
    tile budget (at least one window). Allocates and copies nothing, so a
    CUDA graph can capture it."""
    dev = metric.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(metric, cx0, cy0, valid, n_rows, n_cols, half,
                          scores, lattice_bits, chunk, tile_cells)
    s = metric.shape[-1]
    t_bins, n = cx0.shape[-2:]
    b = metric.numel() // (s * s)
    planned, tile = plan(b, t_bins, n, half, _sm_count(dev.index))
    err = _build.load_kernels().slam_corr_volume(
        metric.data_ptr(), s, cx0.data_ptr(), cy0.data_ptr(),
        valid.data_ptr(), b, t_bins, n, n_rows.data_ptr(), n_cols.data_ptr(),
        half, lattice_bits, chunk or planned, tile_cells or tile,
        scores.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slam_corr_volume")


def score_volume_cuda(metric: torch.Tensor, cx0: torch.Tensor,
                      cy0: torch.Tensor, valid: torch.Tensor,
                      n_rows, n_cols, half: int,
                      lattice_bits: int = LATTICE_BITS) -> torch.Tensor:
    """K2 on CUDA tensors: metric (S, S) f32, cx0/cy0 (T, N) i32, valid (N,)
    bool -> scores (T, W, W) f32; or, batched, metric (B, S, S), cx0/cy0
    (B, T, N), valid (B, N) -> scores (B, T, W, W). n_rows/n_cols are ints
    or 0-dim i32 tensors shared by the batch. The field must lie on the
    2^-lattice_bits lattice (an EDT field at 10; a cascade level min-pooled
    and divided by 2^l at 10 + l): a volume whose field is off it comes
    back NaN. Raises for anything the kernel does not take; never falls
    back."""
    global launches
    dev = metric.device
    if not metric.is_cuda:
        raise ValueError("score_volume_cuda takes CUDA tensors; CPU tensors "
                         "go through ops.correlative.score_volume_plain")
    if metric.dtype != torch.float32 or metric.dim() not in (2, 3) \
            or metric.shape[-1] != metric.shape[-2]:
        raise ValueError(f"metric must be square f32 (S, S) or (B, S, S), "
                         f"got {metric.dtype} {tuple(metric.shape)}")
    lead = tuple(metric.shape[:-2])
    if cx0.dtype != torch.int32 or cy0.dtype != torch.int32 \
            or cx0.dim() != len(lead) + 2 or cx0.shape != cy0.shape \
            or tuple(cx0.shape[:-2]) != lead:
        raise ValueError("cx0/cy0 must be int32 tensors of one shape, (T, N) "
                         "or (B, T, N) with the metric's B")
    if valid.dtype != torch.bool or tuple(valid.shape) != lead + (cx0.shape[-1],):
        raise ValueError("valid must be a bool (N,) or (B, N) tensor")
    if half < 0:
        raise ValueError(f"half {half} < 0")
    if not 0 <= lattice_bits <= 30:
        raise ValueError(f"lattice_bits {lattice_bits} outside 0..30")
    for name, t in (("metric", metric), ("cx0", cx0), ("cy0", cy0),
                    ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, metric on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t_bins = cx0.shape[-2]
    w = 2 * half + 1
    _build.load_kernels()   # built at first use, before anything is allocated
    scores = torch.empty(lead + (t_bins, w, w), dtype=torch.float32,
                         device=dev)
    launch(metric, cx0, cy0, valid, _extent(n_rows, dev),
           _extent(n_cols, dev), half, scores, lattice_bits)
    launches += 1
    launches_by_shape[(lead[0] if lead else 1, t_bins, half,
                       metric.shape[-1])] += 1
    return scores
