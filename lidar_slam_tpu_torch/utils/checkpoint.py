"""Checkpoint/resume of SLAM state (counterpart of
``lidar_slam_tpu.utils.checkpoint``).

Any state of the port — ``SlamState``, ``ParticleState``, ``EkfSlamState``,
``PoseGraph``, ``SubmapSlamState``, ``BAProblem``: ``NamedTuple``s of
tensors, host ints and bools, and ``torch.Generator``s — is saved atomically
to one ``.npz`` (a temporary file, then ``os.replace``) and restored into a
template of the same structure, so a long run resumes mid-tour with the same
bits. Keys are the leaves' field paths; the structure (container types,
field names, leaf kinds and dtypes) is stored beside them and checked on
load, and every tensor's shape is checked against the template's.

A generator's state is saved with its device type and restored into the
template's generator, so the draws after a resume are the draws the
unbroken run would have made. A CPU generator's state (Mersenne Twister)
and a CUDA generator's (Philox seed and offset) are different things: one is
never restored into the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from lidar_slam_tpu_torch.utils.tree import (is_generator, leaves_with_path,
                                             map_with_path, structure)

_STRUCTURE = "__structure__"


def _key(path: str) -> str:
    return path.lstrip(".") or "leaf"


def save_state(path: str, state) -> None:
    """Atomically save ``state`` to ``path`` (.npz)."""
    arrays = {_STRUCTURE: np.asarray(structure(state))}
    for p, leaf in leaves_with_path(state):
        key = _key(p)
        if isinstance(leaf, torch.Tensor):
            arrays[key] = leaf.detach().cpu().numpy()
        elif is_generator(leaf):
            arrays[key] = leaf.get_state().cpu().numpy()
            arrays[key + "@device"] = np.asarray(leaf.device.type)
        elif leaf is not None:
            arrays[key] = np.asarray(leaf)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, template):
    """Restore a state saved by ``save_state`` into ``template``'s structure:
    tensors land on the template's devices, generators are restored in
    place. Raises ``ValueError`` on a structure or shape mismatch, or on a
    generator state of another device type."""
    with np.load(path, allow_pickle=False) as blob:
        stored = str(blob[_STRUCTURE])
        want = structure(template)
        if stored != want:
            raise ValueError(f"checkpoint structure mismatch:\n saved: "
                             f"{stored}\n want:  {want}")

        def restore(p, leaf):
            key = _key(p)
            if leaf is None:
                return None
            arr = blob[key]
            if isinstance(leaf, torch.Tensor):
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(f"{key}: shape {arr.shape} != template "
                                     f"{tuple(leaf.shape)}")
                return torch.as_tensor(arr, device=leaf.device)
            if is_generator(leaf):
                saved = str(blob[key + "@device"])
                if saved != leaf.device.type:
                    raise ValueError(
                        f"{key}: a {saved} generator's state cannot restore "
                        f"a {leaf.device.type} generator")
                leaf.set_state(torch.from_numpy(arr.copy()))
                return leaf
            return type(leaf)(arr.item())

        return map_with_path(restore, template)
