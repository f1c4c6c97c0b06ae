"""SE(2) geometry (counterpart of ``lidar_slam_tpu.core.se2``).

``transform_ref`` is the reference's transposed-rotation convention
(``wx = ct*x + st*y + tx``, ``wy = -st*x + ct*y + ty``) on the shared trig32
sin/cos, so fidelity-path transforms are bit-comparable with the C++ oracle.
The rest is the standard-convention algebra as plain torch.
"""

from __future__ import annotations

import math

import torch

from lidar_slam_tpu_torch.core.trig32 import sincos32
from lidar_slam_tpu_torch.device import constant


def transform_ref(x: torch.Tensor, y: torch.Tensor, pose: torch.Tensor):
    """Reference-convention rigid transform (rotation by -theta).

    pose: (..., 3) = (tx, ty, theta); x, y: (..., N).
    """
    tx, ty, theta = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]
    st, ct = sincos32(theta)
    wx = (ct * x + st * y) + tx
    wy = ((-st) * x + ct * y) + ty
    return wx, wy


def transform(x: torch.Tensor, y: torch.Tensor, pose: torch.Tensor):
    """Standard SE(2) action: R(theta) @ p + t."""
    tx, ty, theta = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]
    ct, st = torch.cos(theta), torch.sin(theta)
    return ct * x - st * y + tx, st * x + ct * y + ty


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]. The division is by a device tensor: CUDA turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which can differ from the CPU's quotient in the last bit."""
    turns = (a + math.pi) / constant(2.0 * math.pi, a.device, a.dtype)
    return a - 2.0 * math.pi * torch.floor(turns)


def compose_ref(a: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Reference-convention composition: world pose of ``z`` given in ``a``'s
    frame (translation composes through R(-theta_a))."""
    ct, st = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ct * z[..., 0] + st * z[..., 1]
    y = a[..., 1] - st * z[..., 0] + ct * z[..., 1]
    return torch.stack([x, y, a[..., 2] + z[..., 2]], dim=-1)


def compose(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Standard-convention pose composition: p1 (+) p2 (p2 in p1's frame)."""
    ct, st = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    x = p1[..., 0] + ct * p2[..., 0] - st * p2[..., 1]
    y = p1[..., 1] + st * p2[..., 0] + ct * p2[..., 1]
    return torch.stack([x, y, p1[..., 2] + p2[..., 2]], dim=-1)


def between(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Standard-convention relative pose p1 (-) p2: the transform taking
    p1's frame to p2's, heading wrapped."""
    dx = p2[..., 0] - p1[..., 0]
    dy = p2[..., 1] - p1[..., 1]
    ct, st = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    return torch.stack([ct * dx + st * dy, -st * dx + ct * dy,
                        wrap_angle(p2[..., 2] - p1[..., 2])], dim=-1)


def between_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference-convention relative pose: z with ``compose_ref(a, z) == b``."""
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    ct, st = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([ct * dx - st * dy, st * dx + ct * dy,
                        b[..., 2] - a[..., 2]], dim=-1)
