"""Wrapper of kernel K1, the clamped EDT in ``csrc/edt.cu``.

Replaces the TPU kernel ``lidar_slam_tpu/ops/pallas_edt.py::
edt_clamped_pallas`` (``_edt_kernel`` and ``_edt_kernel_blocked``). On the
H100 the transform is bound by bytes (1 in, 4 out a cell) and, for one grid,
by the launch; the kernel does the whole transform in one launch for a whole
batch of grids, with no whole-grid/strip split — that existed only for the
TPU's 16 MB VMEM. A block owns a band of whole rows: it packs their
occupancy into bit words, finds each cell's nearest occupied cell in its row
by bit scans into shared memory (two 16-bit cells a word), and takes the
column pass's 2R+1 min-adds two cells an instruction (Hopper's DPX
``__viaddmin_u16x2``), eight cells a thread. ``csrc/edt.cu`` has the
details.

Held to the plain ``ops.edt.edt_clamped`` with ``torch.equal``.
"""

from __future__ import annotations

import collections
import functools

import torch

from lidar_slam_tpu_torch import _build

# kernel launches made through this wrapper since the last reset; a replay
# of a captured graph adds the launches it holds (``utils/graphs``)
launches = 0
# the same launches keyed by the (B, H, W) they transformed
launches_by_shape: collections.Counter = collections.Counter()

MAX_R = 64            # the kernel's bit scans reach two words each side
MIN_BAND, MAX_BAND = 4, 32
SMEM_BYTES = 232448   # shared memory one block may use on Hopper


def smem_bytes(w: int, r: int, band: int) -> int:
    """A block's shared memory: its packed rows, its d1 rows and the
    tail's table (the formula of ``csrc/edt.cu``)."""
    rows = band + 2 * r
    words = -(-rows * (-(-w // 32) + 4) // 4) * 4
    return 4 * (words + rows * 4 * -(-w // 8) + r * r + 2)


def plan_band(b: int, h: int, w: int, r: int, sms: int,
              band: int | None = None) -> int:
    """Output rows a block: ``band`` if given, else the fewest rows that
    keep the grid to one block an SM (one wave), between ``MIN_BAND`` and
    ``MAX_BAND`` rows; at most ``h``, and fewer where a block's shared
    memory would overflow. Raises for rows too wide for any band."""
    if band is None:
        band = max(MIN_BAND, min(MAX_BAND, -(-h // max(1, sms // b))))
    band = min(h, band)
    while band > 1 and smem_bytes(w, r, band) > SMEM_BYTES:
        band -= 1
    if smem_bytes(w, r, band) > SMEM_BYTES:
        raise ValueError(f"rows of {w} cells do not fit the kernel's "
                         f"shared memory")
    return band


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(occ3: torch.Tensor, out: torch.Tensor, r: int,
           band: int | None = None) -> None:
    """One raw launch on the current stream: occ3 (B, H, W) bool/uint8 and
    out (B, H, W) f32, both contiguous on one card; ``band`` overrides the
    planned rows a block (cut to what fits). No checks and no count;
    ``edt_clamped_cuda`` is the checked entry. Allocates nothing, so a CUDA
    graph can capture it."""
    dev = occ3.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(occ3, out, r, band)
    b, h, w = occ3.shape
    band = plan_band(b, h, w, r, _sm_count(dev.index), band)
    err = _build.load_kernels().slam_edt_clamped(
        occ3.data_ptr(), out.data_ptr(), b, h, w, r, band,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slam_edt_clamped")


def edt_clamped_cuda(occ: torch.Tensor, max_dist: int = 10) -> torch.Tensor:
    """K1 on a CUDA tensor: occ (B, H, W) or (H, W), bool or uint8 ->
    f32 of the same shape. Raises for anything the kernel does not take;
    never falls back to the plain version."""
    global launches
    if not occ.is_cuda:
        raise ValueError("edt_clamped_cuda takes a CUDA tensor; CPU tensors "
                         "go through ops.edt.edt_clamped")
    if occ.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"occupancy must be bool or uint8, got {occ.dtype}")
    if occ.dim() not in (2, 3):
        raise ValueError(f"occupancy must be (H, W) or (B, H, W), got "
                         f"{tuple(occ.shape)}")
    if not occ.is_contiguous():
        raise ValueError("occupancy must be contiguous")
    r = int(max_dist)
    if not 0 <= r <= MAX_R:
        raise ValueError(f"max_dist {max_dist} outside the kernel's "
                         f"0..{MAX_R}")
    occ3 = occ.view((-1,) + tuple(occ.shape[-2:]))
    _build.load_kernels()   # built at first use, before anything is allocated
    out = torch.empty(occ3.shape, dtype=torch.float32, device=occ.device)
    launch(occ3, out, r)
    launches += 1
    launches_by_shape[tuple(occ3.shape)] += 1
    return out.reshape(occ.shape)
