"""Device resolution: an explicit device, never a silent CPU fallback; and
the helpers that make an f32 result the same bits on every device."""

from __future__ import annotations

import functools

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"``/``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    A CUDA request raises when ``torch.cuda.is_available()`` is false: a run
    asked for the card must not quietly measure the CPU instead.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


@functools.cache
def constant(value, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant tensor on ``device``, copied there once per process.

    A host->device copy of a freshly made tensor from pageable memory
    synchronizes the stream, so per-step constants come from here, copied
    from pinned memory without a sync: a captured step's warm-up, which
    runs under the sync debug mode "error", may make the first one. The
    cache never drops a constant, since a captured graph reads it by its
    address. ``value`` is a number or a (nested) tuple; callers must never
    write to the returned tensor.
    """
    host = torch.tensor(value, dtype=dtype)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def rounded64(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` of f32 tensors evaluated in float64 and rounded once to f32.

    The CPU's and the card's f32 transcendentals differ in the last bit
    (and the card's f32 ``sqrt`` is not correctly rounded); their float64
    results differ far below an f32 ulp, so the rounded f32 agrees."""
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)
