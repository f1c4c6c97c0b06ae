"""Debug checks (counterpart of ``lidar_slam_tpu.utils.debug``).

Numeric hazards the fixed-shape pipeline does not rule out by construction:
NaN/Inf poses from a degenerate solve, weight collapse, a fixed-capacity
store past its bounds. This module makes them checkable:

- :func:`validate_state` — host-side audit of any state of the port
  (every float tensor finite, the point map's size within its capacity,
  particle weights not all collapsed, the step counter non-negative);
  generators and host ints are skipped by the finiteness walk.
- :func:`checked` — runs a function and then tests every float tensor it
  returned, raising on a NaN or Inf with the output's path. The JAX package
  instruments the compiled program with ``checkify`` instead, which also
  traps division by zero at the dividing op; torch has no such trap, so
  that check is left out: a division by zero shows here only as the
  Inf or NaN it leaves in an output.
- ``run --debug-checks`` (CLI) audits the final state and trajectory.

Nothing on a main path calls these unless ``--debug-checks`` is given.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from lidar_slam_tpu_torch.utils.tree import leaves_with_path, map_with_path


def _nonfinite(leaf) -> tuple[int, int] | None:
    """(non-finite count, size) of a float leaf, else None."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return None
        return int((~torch.isfinite(leaf)).sum()), leaf.numel()
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                      np.floating):
        return int((~np.isfinite(leaf)).sum()), leaf.size
    if isinstance(leaf, (float, np.floating)):
        return int(not math.isfinite(leaf)), 1
    return None


def validate_state(state, name: str = "state") -> list:
    """Audit a state; returns a list of violation strings (empty when every
    invariant holds)."""
    bad: list = []
    for path, leaf in leaves_with_path(state):
        found = _nonfinite(leaf)
        if found is not None and found[0]:
            bad.append(f"{name}{path}: {found[0]} non-finite of {found[1]}")
    pmap = getattr(state, "pmap", None)
    if pmap is not None and hasattr(pmap, "size") and hasattr(pmap, "xy"):
        size = int(pmap.size)
        cap = int(pmap.xy.shape[-2])
        if not 0 <= size <= cap:
            bad.append(f"{name}.pmap.size={size} outside [0, {cap}]")
    logw = getattr(state, "logw", None)
    if isinstance(logw, torch.Tensor) and logw.numel() \
            and not bool(torch.isfinite(logw).any()):
        bad.append(f"{name}.logw: all weights collapsed (-inf/NaN)")
    step = getattr(state, "step", None)
    if step is not None and int(step) < 0:
        bad.append(f"{name}.step={int(step)} negative")
    return bad


def assert_valid(state, name: str = "state") -> None:
    """Raise ``AssertionError`` listing every violated invariant."""
    bad = validate_state(state, name)
    if bad:
        raise AssertionError("state invariants violated:\n  "
                             + "\n  ".join(bad))


def checked(fn):
    """``fn`` with its outputs checked: a NaN or Inf in any float tensor it
    returns raises ``RuntimeError`` naming the output's path and the counts.
    The counts of all outputs on one device come to the host in one copy.
    (No division check: see the module docstring.)"""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        floats = [(p, t) for p, t in leaves_with_path(out)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        by_device: dict = {}
        for p, t in floats:
            by_device.setdefault(t.device, []).append((p, t))
        for items in by_device.values():
            counts = torch.stack([torch.stack([torch.isnan(t).sum(),
                                               torch.isinf(t).sum()])
                                  for _, t in items]).cpu()
            for (p, t), (n_nan, n_inf) in zip(items, counts.tolist()):
                if n_nan or n_inf:
                    raise RuntimeError(
                        f"checked({getattr(fn, '__name__', 'fn')}): "
                        f"output{p} has {n_nan} nan and {n_inf} inf of "
                        f"{t.numel()} values")
        return out

    return wrapper


def check(pred, msg: str, **fmt) -> None:
    """Raise ``RuntimeError(msg.format(**fmt))`` unless every element of the
    predicate is true (a host sync when it is a device tensor)."""
    if not bool(torch.as_tensor(pred).all()):
        raise RuntimeError(msg.format(**fmt) if fmt else msg)


def finite_or_revert(new, old):
    """Return ``new`` where every float tensor of it is finite, else ``old``
    (whole-tree revert), with no host sync: the choice is a ``torch.where``
    on each tensor of matching shape. Leaves that are not tensors (host
    ints, generators) are kept from ``new``."""
    flags = [torch.isfinite(t).all() for _, t in leaves_with_path(new)
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not flags:
        return new
    ok = torch.stack([f.to(flags[0].device) for f in flags]).all()

    def pick(_path, a, b):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
                and a.shape == b.shape:
            return torch.where(ok.to(a.device), a, b.to(a.device))
        return a

    return map_with_path(pick, new, old)
