"""Process-group start-up, a launcher of local worlds, and the scaling run
(counterpart of ``lidar_slam_tpu.parallel.multihost``).

The JAX package joins ``jax.distributed`` under a multi-host launcher and
is a no-op in one process. ``torch.distributed`` needs a process group
before any mesh exists, so ``initialize`` makes a world of one itself when
nothing names another. ``launch`` starts a world of n local processes
(``spawn`` context, explicit rank and size, a ``file://`` store in a fresh
temporary directory so concurrent worlds never race for a port), runs a
list of the port's functions in every rank and returns their results; the
tests and ``scaling_report`` start their worlds with it. A spawned rank
imports only the port. Every entry point runs on the card unless the
caller asks for the CPU (``device_type="cpu"``, as the tests do), and a
request for the card raises without one.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from lidar_slam_tpu_torch.parallel import mesh as mesh_lib


_store_dir: str | None = None   # the world of one's store, until shutdown


def initialize(rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None, device_type: str = "cuda"
               ) -> tuple[int, int]:
    """Join the default process group; returns (rank, world size).

    Resolution order: explicit arguments > ``MASTER_ADDR``/``MASTER_PORT``/
    ``RANK``/``WORLD_SIZE`` (a ``tcp://`` store) > a world of one on a
    ``file://`` store in a fresh temporary directory, which ``shutdown``
    removes. A process already in a group keeps it."""
    global _store_dir
    device_type = mesh_lib.device_type_of(device_type)
    if mesh_lib.is_initialized():
        return mesh_lib.world()
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = (f"tcp://{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if init_method is None:
        if (world_size or 1) != 1:
            raise ValueError("a world of more than one process needs an "
                             "init_method or MASTER_ADDR")
        _store_dir = tempfile.mkdtemp(prefix="lidar_slam_world_")
        init_method = "file://" + os.path.join(_store_dir, "store")
    mesh_lib.init_world(rank or 0, world_size or 1, init_method, device_type)
    return mesh_lib.world()


def shutdown() -> None:
    """Leave the process group, and remove the store ``initialize`` made."""
    global _store_dir
    mesh_lib.destroy_world()
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def global_particle_mesh(n_map_shards: int = 1, device_type: str = "cuda"
                         ) -> mesh_lib.Mesh:
    """Mesh over every rank of the world: particles x map blocks."""
    return mesh_lib.make_mesh(n_map_shards=n_map_shards,
                              device_type=device_type)


def imported_packages() -> list[str]:
    """Top-level packages this process has imported (a rank's check that it
    loaded neither JAX nor the JAX package)."""
    return sorted({m.split(".")[0] for m in sys.modules})


def _to_host(obj):
    """Tensors of a result tree as numpy arrays (what crosses the queue)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, torch.Generator):
        return None
    return obj


def _rank_main(jobs, rank, world_size, init_method, device_type,
               results) -> None:
    """One rank of a launched world: join the group, run every job in
    order, put (rank, "ok", [result, ...]) or (rank, "error", traceback).
    One torch thread a rank: several worlds may share a host's cores."""
    torch.set_num_threads(1)
    try:
        initialize(rank, world_size, init_method, device_type)
        out = [_to_host(fn(*args)) for fn, args in jobs]
        results.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
    finally:
        gc.collect()   # no captured collective outlives its communicator
        shutdown()


def launch(world_size: int, jobs, device_type: str = "cuda",
           timeout_s: float = 600.0) -> list[list]:
    """Run ``jobs`` (``(function, args)`` pairs, module-level functions of
    the port) in order in every rank of a new world of ``world_size`` local
    processes. Returns each rank's list of results, tensors as numpy.
    Raises on a rank's error (with its traceback), or when the world has
    not finished within ``timeout_s``; every process is joined or killed
    before it returns."""
    import multiprocessing as mp

    device_type = mesh_lib.device_type_of(device_type)
    ctx = mp.get_context("spawn")
    store = tempfile.mkdtemp(prefix="lidar_slam_world_")
    init_method = "file://" + os.path.join(store, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(list(jobs), r, world_size, init_method,
                               device_type, results), daemon=True)
             for r in range(world_size)]
    done: dict[int, list] = {}
    errors: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    first_error = None
    try:
        for p in procs:
            p.start()
        while len(done) + len(errors) < world_size:
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(f"world of {world_size} unfinished after "
                                   f"{timeout_s:.0f} s; done {sorted(done)}")
            if first_error is not None and now > first_error + 10.0:
                break       # the others may wait in a collective forever
            try:
                rank, status, value = results.get(timeout=0.5)
            except queue.Empty:
                # a rank that exits 0 has put its result; any other exit
                # code without one is a crash
                for r, p in enumerate(procs):
                    if (p.exitcode not in (None, 0) and r not in done
                            and r not in errors):
                        errors[r] = f"exited with code {p.exitcode}"
                        first_error = first_error or time.monotonic()
                continue
            if status == "ok":
                done[rank] = value
            else:
                errors[rank] = value
                first_error = first_error or now
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=max(1.0, min(30.0,
                                            deadline - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    if errors:
        raise RuntimeError(f"world of {world_size}: " + "\n".join(
            f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [done[r] for r in range(world_size)]


def scaling_job(ranges: np.ndarray, cfg, n_scans: int,
                device_type: str = "cuda") -> float:
    """In a launched world: scans/s of the captured sharded PF step with
    config ``cfg`` over ``n_scans`` scans, as ``sharded.run_sharded_pf``
    drives it (``advance``, one read at the end); the first step, which
    builds the first map, and the second, which captures the graph,
    untimed."""
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.parallel import sharded

    mesh = global_particle_mesh(device_type=device_type)
    step, place = sharded.make_sharded_pf_step(cfg, mesh)
    scans = torch.as_tensor(np.asarray(ranges[:n_scans], np.float32),
                            device=mesh.device_type)
    state = place(fastslam.init_particles(scans[0], cfg))
    for t in (1, 2):
        state = step.advance(state, scans[t])
    state = step.finish(state)
    t0 = time.perf_counter()
    for t in range(3, scans.shape[0]):
        state = step.advance(state, scans[t])
    step.finish(state)
    return (scans.shape[0] - 3) / (time.perf_counter() - t0)


def devices_present(device_type: str) -> tuple[int, str]:
    """How many ranks of ``device_type`` this host can hold, one device a
    rank (its cards, or its CPU cores), and that count in words."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        return n, f"{n} GPU"
    n = os.cpu_count() or 1
    return n, f"{n} CPU cores"


@dataclasses.dataclass
class ScalingReport:
    scans_per_s: dict      # world size -> rank 0's scans/s
    skipped: dict          # world size -> reason


def scaling_report(ranges: np.ndarray, n_particles: int = 1024,
                   world_sizes=(1, 2, 4, 8), n_scans: int = 60,
                   device_type: str = "cuda", timeout_s: float = 600.0
                   ) -> ScalingReport:
    """Throughput of the sharded PF (``DEFAULT_CONFIG`` at ``n_particles``)
    at several world sizes, one launched world each (the scaling table). A
    size above the devices present is skipped, as in the JAX package: on a
    card, every size above its GPU count; on the CPU, above its cores."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig

    device_type = mesh_lib.device_type_of(device_type)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, particles=ParticleConfig(n_particles=n_particles))
    n_dev, why = devices_present(device_type)
    report = ScalingReport({}, {})
    for d in world_sizes:
        if d > n_dev:
            report.skipped[d] = why
            continue
        out = launch(d, [(scaling_job, (ranges, cfg, n_scans, device_type))],
                     device_type, timeout_s)
        report.scans_per_s[d] = out[0][0]
    return report
