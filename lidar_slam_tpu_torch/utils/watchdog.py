"""Failure containment for long runs on the card: stall watchdog, restart
and checkpoint-resume (counterpart of ``lidar_slam_tpu.utils.watchdog``).

A wedged device call cannot be interrupted from inside the process (the
stuck thread is in the driver, and Python signal handlers run only between
bytecodes), so containment needs a process boundary:

- the WORKER runs the computation in a ``spawn``ed process (never a fork of
  a process that may hold a CUDA context), beats a heartbeat file after
  every chunk of work and checkpoints its state (``utils/checkpoint``,
  atomic) so progress survives a kill;
- the SUPERVISOR (this module) polls the heartbeat's age and the worker's
  liveness, kills the worker's whole process group when the heartbeat goes
  stale, and relaunches it up to ``max_restarts`` times; each relaunch
  resumes from the last checkpoint.

Three changes from the JAX package's supervisor: the heartbeat is read once
a poll (one ``open`` + ``fstat``; the JAX loop stats it twice); whether an
attempt has booted is latched per attempt from a launch token the worker's
first beat writes into the heartbeat, not from an mtime-against-clock test
that a coarse-mtime filesystem can misjudge; and ``run_pf_supervised``
passes ``boot_grace_s`` through, since a spawned child on the card pays for
importing torch, creating its CUDA context and loading the kernels before
its first beat. The port's ``pf_worker`` also resumes at the scan after the
checkpoint: the JAX worker restarts at ``state.step + 1`` and so skips one
scan (``state.step`` is already the next scan to process).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import signal
import tempfile
import time

HEARTBEAT_FILE = "heartbeat"
TOKEN_ENV = "LIDAR_SLAM_WATCHDOG_TOKEN"


def _worker_entry(worker, run_dir: str, args: tuple, token: str) -> None:
    """Subprocess entry: detach into an own session/process group first, so
    the supervisor's SIGKILL takes down helper subprocesses the worker
    spawns (``os.killpg``), not just the worker pid; hand the attempt's
    launch token to its heartbeats."""
    try:
        os.setsid()
    except OSError:
        pass   # already a session leader (unlikely, but harmless)
    os.environ[TOKEN_ENV] = token
    worker(run_dir, *args)


def _kill_group(proc) -> None:
    """SIGKILL the worker's whole process group, falling back to the pid."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        proc.kill()


class Heartbeat:
    """Worker-side liveness signal: ``beat()`` after every chunk of work.

    Atomic (write + rename) so the supervisor never reads a torn file. The
    payload is the last completed step, the time and the attempt's launch
    token (from the supervisor, through ``TOKEN_ENV``); staleness is judged
    by the file's mtime."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, HEARTBEAT_FILE)
        self.token = os.environ.get(TOKEN_ENV, "")

    def beat(self, step: int = -1) -> None:
        d = os.path.dirname(self.path)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".hb.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(f"{step} {time.time():.3f} {self.token}\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def read_beat(run_dir: str) -> tuple[float, str] | None:
    """(mtime, launch token) of the heartbeat in one open, or None when
    there is none."""
    try:
        with open(os.path.join(run_dir, HEARTBEAT_FILE)) as f:
            mtime = os.fstat(f.fileno()).st_mtime
            fields = f.read().split()
    except OSError:
        return None
    return mtime, (fields[2] if len(fields) > 2 else "")


def heartbeat_age(run_dir: str) -> float:
    """Seconds since the worker's last beat (inf when it never beat)."""
    beat = read_beat(run_dir)
    return float("inf") if beat is None else time.time() - beat[0]


@dataclasses.dataclass
class SuperviseReport:
    completed: bool          # worker finished with exit code 0
    attempts: int            # total worker launches (1 = no failure)
    stalls: int              # kills due to a stale heartbeat
    crashes: int             # nonzero worker exits
    seconds: float


def run_supervised(worker, args: tuple, run_dir: str, *,
                   stall_timeout_s: float, max_restarts: int = 1,
                   poll_s: float = 0.25,
                   deadline_s: float | None = None,
                   boot_grace_s: float | None = None) -> SuperviseReport:
    """Run ``worker(run_dir, *args)`` in a spawned process under a stall
    watchdog.

    ``worker`` must be a module-level (picklable) callable that creates
    ``Heartbeat(run_dir)`` and beats after every chunk of work, checkpoints
    into ``run_dir`` often enough that a kill loses at most one chunk, and
    resumes from its checkpoint when one exists.

    When the heartbeat goes stale for ``stall_timeout_s`` the worker's
    process group is SIGKILLed and relaunched, up to ``max_restarts``
    times; a worker that exits nonzero is also relaunched. Until an
    attempt's first beat (a beat carrying its launch token) staleness is
    judged against ``boot_grace_s`` (default ``max(stall_timeout_s, 30)``):
    start-up is not a stall."""
    ctx = multiprocessing.get_context("spawn")
    if boot_grace_s is None:
        boot_grace_s = max(stall_timeout_s, 30.0)
    t0 = time.time()
    stalls = crashes = attempts = 0
    os.makedirs(run_dir, exist_ok=True)

    while attempts <= max_restarts:
        attempts += 1
        token = f"{os.getpid()}.{attempts}.{time.time_ns()}"
        launch = time.time()
        booted = False
        proc = ctx.Process(target=_worker_entry,
                           args=(worker, run_dir, tuple(args), token),
                           daemon=True)
        proc.start()
        while True:
            if deadline_s is not None and time.time() - t0 > deadline_s:
                _kill_group(proc)
                proc.join(5.0)
                return SuperviseReport(False, attempts, stalls, crashes,
                                       time.time() - t0)
            proc.join(poll_s)
            if proc.exitcode is not None:
                break
            beat = read_beat(run_dir)
            now = time.time()
            booted = booted or (beat is not None and beat[1] == token)
            since = now - launch
            age = (min(now - beat[0], since) if booted and beat is not None
                   else since)
            if age > (stall_timeout_s if booted else boot_grace_s):
                _kill_group(proc)
                proc.join(5.0)
                stalls += 1
                break
        if proc.exitcode == 0:
            return SuperviseReport(True, attempts, stalls, crashes,
                                   time.time() - t0)
        if proc.exitcode is not None and proc.exitcode != -signal.SIGKILL:
            crashes += 1
    return SuperviseReport(False, attempts, stalls, crashes,
                           time.time() - t0)


# ---------------------------------------------------------------------------
# A supervised, checkpoint-resumable particle-filter run (the CLI's
# --supervised path). Module-level so a spawned process can import it.
# ---------------------------------------------------------------------------

CKPT_FILE = "state.npz"
PATH_FILE = "path.npy"
RUN_ID_FILE = "run_id.txt"


def pf_worker(run_dir: str, ranges, cfg, seed: int = 0,
              ckpt_every: int = 100, device: str = "cuda") -> None:
    """Checkpointed particle-filter host loop on ``device`` (resumes when
    relaunched). Raises without a card when ``device`` is CUDA."""
    import numpy as np
    import torch

    from lidar_slam_tpu_torch.device import resolve_device
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.models.scan_matcher import angles_tensor
    from lidar_slam_tpu_torch.utils import checkpoint

    dev = resolve_device(device)
    hb = Heartbeat(run_dir)
    ckpt = os.path.join(run_dir, CKPT_FILE)
    path_file = os.path.join(run_dir, PATH_FILE)
    scans = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    angles = angles_tensor(cfg, dev)
    state = fastslam.init_particles(scans[0], cfg, seed)
    poses = np.zeros((len(scans), 3), np.float32)
    if os.path.exists(ckpt):
        state = checkpoint.load_state(ckpt, state)
        if os.path.exists(path_file):
            prev = np.load(path_file)
            n = min(len(prev), state.step)
            poses[:n] = prev[:n]
    start = state.step       # the next scan to process
    hb.beat(start - 1)
    for t in range(start, len(scans)):
        state, pose = fastslam.pf_step(state, scans[t], cfg, angles)
        poses[t] = pose.cpu().numpy()   # a host fetch: the beat is honest
        hb.beat(t)
        if t % ckpt_every == 0 or t == len(scans) - 1:
            np.save(path_file, poses[:t + 1])
            checkpoint.save_state(ckpt, state)
    np.save(path_file, poses)
    checkpoint.save_state(ckpt, state)


def _run_identity(ranges, cfg, seed: int) -> str:
    """Content hash identifying one logical run (config + data + seed)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    h.update(cfg.to_json().encode())
    h.update(f"seed={seed} n={len(ranges)}".encode())
    h.update(np.ascontiguousarray(ranges[0], np.float32).tobytes())
    return h.hexdigest()[:16]


def run_pf_supervised(ranges, cfg, run_dir: str, *, seed: int = 0,
                      stall_timeout_s: float = 120.0, max_restarts: int = 1,
                      ckpt_every: int = 100, resume: bool = False,
                      boot_grace_s: float | None = None,
                      device: str = "cuda"):
    """Particle-filter run that survives a wedged device: supervised worker
    + checkpoint-resume. Returns (path (T, 3) numpy or None, report).

    ``device`` is resolved here first, so a CUDA request without a card
    raises in the caller, not in a worker. The run_dir is stamped with a
    run identity (hash of config + data + seed); leftover state is cleared
    before launch unless ``resume=True`` and the stamp matches, so a run
    on other data in a shared run_dir never resumes another run's state."""
    import numpy as np

    from lidar_slam_tpu_torch.device import resolve_device

    device = str(resolve_device(device))
    run_id = _run_identity(ranges, cfg, seed)
    os.makedirs(run_dir, exist_ok=True)
    id_file = os.path.join(run_dir, RUN_ID_FILE)
    try:
        with open(id_file) as f:
            same_run = f.read().strip() == run_id
    except OSError:
        same_run = False
    if not (resume and same_run):
        for name in (CKPT_FILE, PATH_FILE, HEARTBEAT_FILE):
            p = os.path.join(run_dir, name)
            if os.path.exists(p):
                os.unlink(p)
    with open(id_file, "w") as f:
        f.write(run_id)

    report = run_supervised(pf_worker,
                            (ranges, cfg, seed, ckpt_every, device),
                            run_dir, stall_timeout_s=stall_timeout_s,
                            max_restarts=max_restarts,
                            boot_grace_s=boot_grace_s)
    path_file = os.path.join(run_dir, PATH_FILE)
    path = np.load(path_file) if os.path.exists(path_file) else None
    return path, report
