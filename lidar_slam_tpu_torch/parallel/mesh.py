"""Process groups, meshes and the collectives of the parallel layer
(counterpart of ``lidar_slam_tpu.parallel.mesh``).

The JAX package shards over a ``jax.sharding.Mesh`` with axes
``("particles", "map")``: particles on one (propagation and scoring split
cleanly), row blocks of the grid on the other (the sharded EDT, whose halo
the 10 px clamp bounds). Here the mesh is a ``torch.distributed``
``DeviceMesh`` of processes, one rank a device, with the same axis names.

This module is the only code of the port that calls ``torch.distributed``:
``init_world``/``destroy_world`` set the process group up and down, and
``Axis`` holds one mesh dimension's group with the two collectives every
other module uses, ``gather`` (all-gather and concatenate along dim 0) and
``all_reduce`` (sum). The default group dispatches by the tensor's device:
NCCL for a CUDA tensor, gloo for a CPU tensor; no tensor is moved to the
host to be communicated. A world of one still runs every collective
through its group: the one-card machine checks this code that way.

There is no ``NamedSharding``: a placed state is this rank's rows of its
per-particle leaves, the rest replicated, and the ``Axis`` it was cut
along (``shard_particle_state``).
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import torch
import torch.distributed as dist

from lidar_slam_tpu_torch.device import resolve_device

PARTICLE_LEAVES = ("poses", "prev_poses", "logw")

# all-gather into one tensor: ``all_gather_single`` where torch has it,
# else its older name (deprecated where the newer exists)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


def device_type_of(device_type: str) -> str:
    """``"cuda"`` or ``"cpu"``; a CUDA request raises without a card
    (``device.resolve_device``): no world quietly runs on the host."""
    return resolve_device(device_type).type


def backend_for(device_type: str) -> str:
    """gloo for a CPU world; NCCL for CUDA tensors beside gloo for CPU ones
    on a card."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA world needs NCCL, which this torch "
                               "build lacks")
        return "cpu:gloo,cuda:nccl"
    if device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}")
    return "gloo"


def init_world(rank: int, world_size: int, init_method: str,
               device_type: str = "cuda") -> None:
    """Join the default process group (rank and size given explicitly; the
    store at ``init_method``: ``tcp://host:port`` or ``file://path``). A
    collective that waits 10 minutes for its peers fails."""
    device_type = device_type_of(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(device_type), init_method=init_method, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(minutes=10))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of the default group."""
    return dist.get_rank(), dist.get_world_size()


def destroy_world() -> None:
    if is_initialized():
        dist.destroy_process_group()


class Axis:
    """One mesh dimension: its process group (None: the default group),
    this rank's place in it and its size. ``gather`` and ``all_reduce`` are
    the layer's collectives; ``rows`` slices this rank's block of an
    every-rank tensor, so an ``Axis`` over the particles is the sharded
    counterpart of ``models.fastslam.AllRows``. The counters record what
    the collectives moved: ``gathered_bytes`` the size of every gathered
    result, ``reduced_bytes`` of every summed tensor."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.calls = 0
        self.gathered_bytes = 0
        self.reduced_bytes = 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order. A bool
        tensor travels as uint8 and a 0-dim one as one element."""
        flag = x.dtype == torch.bool
        send = (x.to(torch.uint8) if flag else x).reshape(
            (1,) if x.dim() == 0 else x.shape).contiguous()
        out = torch.empty((self.size * send.shape[0],) + send.shape[1:],
                          dtype=send.dtype, device=send.device)
        _all_gather_single(out, send, group=self.group)
        self.calls += 1
        self.gathered_bytes += out.numel() * out.element_size()
        return out.to(torch.bool) if flag else out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the group, in place; returns it."""
        dist.all_reduce(x, group=self.group)
        self.calls += 1
        self.reduced_bytes += x.numel() * x.element_size()
        return x

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of equal row blocks of ``x``."""
        n = x.shape[0] // self.size
        return x[self.rank * n:(self.rank + 1) * n]

    def reset_counts(self) -> None:
        self.calls = self.gathered_bytes = self.reduced_bytes = 0


def bytes_per_rank(gathered: int, reduced: int, d: int) -> float:
    """Bytes a rank receives in a world of ``d`` for collectives whose
    results hold ``gathered`` and ``reduced`` bytes: an all-gather brings
    the other ranks' (d - 1) / d of its result, a ring all-reduce twice
    that share of its tensor."""
    return (gathered + 2 * reduced) * (d - 1) / d


class Mesh(NamedTuple):
    """A (particles x map) mesh of processes and an ``Axis`` for each."""

    device_mesh: object
    particles: Axis
    map: Axis

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type


def make_mesh(n_particles_shards: int | None = None, n_map_shards: int = 1,
              device_type: str = "cuda") -> Mesh:
    """A 2-D ``init_device_mesh`` over every rank of the world, dims
    ("particles", "map"); ``n_particles_shards`` defaults to the world
    size over ``n_map_shards``. Every rank calls it, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type_of(device_type)
    n = dist.get_world_size()
    if n_particles_shards is None:
        n_particles_shards = n // n_map_shards
    if n_particles_shards * n_map_shards != n:
        raise ValueError(f"{n_particles_shards}x{n_map_shards} != {n} ranks")
    dm = init_device_mesh(device_type, (n_particles_shards, n_map_shards),
                          mesh_dim_names=("particles", "map"))
    return Mesh(dm, Axis(dm.get_group("particles")),
                Axis(dm.get_group("map")))


def make_axis(name: str, device_type: str = "cuda") -> Axis:
    """A 1-D mesh over every rank of the world (the BA's "graph" axis, the
    EDT's "map" axis)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type_of(device_type)
    dm = init_device_mesh(device_type, (dist.get_world_size(),),
                          mesh_dim_names=(name,))
    return Axis(dm.get_group(name))


def shard_particle_state(state, mesh: Mesh, leaves=PARTICLE_LEAVES):
    """This rank's rows of a state's per-particle leaves (``leaves``), the
    rest replicated as they are."""
    return state._replace(**{f: mesh.particles.rows(getattr(state, f))
                             for f in leaves})
