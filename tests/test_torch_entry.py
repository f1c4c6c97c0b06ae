"""The port's entry points run with JAX blocked, the package never imports
JAX, and its kernel build keeps the flags exactness depends on."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch's threads)
import lidar_slam_tpu_torch
from lidar_slam_tpu_torch import _build
from lidar_slam_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(lidar_slam_tpu_torch.__file__)

# Every jax* module already loaded (an interpreter start-up hook may load
# JAX) is set to None, so any later ``import jax`` raises ImportError.
_BLOCK_JAX = (
    "import sys, runpy\n"
    "for k in list(sys.modules):\n"
    "    if k.split('.')[0] in ('jax', 'jaxlib'):\n"
    "        sys.modules[k] = None\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['jaxlib'] = None\n"
    "sys.argv = ['lidar_slam_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('lidar_slam_tpu_torch', run_name='__main__')\n"
)


@pytest.mark.parametrize("args", [
    ["run", "--mode", "fidelity", "--scans", "20", "--device", "cpu"],
    ["run", "--mode", "pf", "--scans", "10", "--particles", "32",
     "--device", "cpu"],
    ["run", "--mode", "graph", "--loop", "--scans", "40", "--device", "cpu"],
    ["run", "--mode", "pf-graph", "--loop", "--scans", "30", "--particles",
     "32", "--device", "cpu"],
    ["run", "--mode", "graph", "--world", "building", "--window", "2",
     "--scans", "20", "--device", "cpu"],
    ["run", "--mode", "ekf", "--scans", "20", "--particles", "32",
     "--device", "cpu"],
    ["run", "--mode", "ekf-hybrid", "--scans", "20", "--particles", "32",
     "--device", "cpu"],
    ["run", "--mode", "submap", "--scans", "20", "--device", "cpu"],
    ["run", "--mode", "submap", "--paged", "--scans", "20", "--device",
     "cpu"],
    ["run", "--mode", "submap-graph", "--loop", "--scans", "40", "--device",
     "cpu"],
    ["run", "--mode", "pf", "--scans", "10", "--particles", "32",
     "--device", "cpu", "--debug-checks"],
    ["run", "--mode", "graph", "--loop", "--scans", "40", "--device", "cpu",
     "--debug-checks"],
])
def test_cli_runs_with_jax_blocked(args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCK_JAX, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "scans/s" in res.stdout and "ATE vs ground truth" in res.stdout
    if "graph" in args[2]:
        assert "loop closures" in res.stdout
    if args[2].startswith("submap"):
        assert "submaps" in res.stdout
    if "--debug-checks" in args:
        assert "debug-checks: all state invariants hold" in res.stdout


def _cli(args, cwd, timeout=300):
    """The port's CLI in a subprocess with JAX blocked."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCK_JAX, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_cli_simulate_then_run_on_the_csv(tmp_path):
    """``simulate`` writes a CSV (and its ground truth); ``run --dataset``
    reads it through the native reader, ``--out-map`` writes the map; the
    CSV path equals the synthesized tour's to the CSV's six decimals."""
    csv = str(tmp_path / "tour.csv")
    out = _cli(["simulate", "--scans", "15", "--out", csv], tmp_path)
    assert f"wrote 15 scans to {csv}" in out
    gt = np.loadtxt(str(tmp_path / "tour_gt.csv"), delimiter=",")
    assert gt.shape == (15, 3)
    map_csv = str(tmp_path / "map.csv")
    out = _cli(["run", "--mode", "fidelity", "--dataset", csv, "--device",
                "cpu", "--out-map", map_csv], tmp_path)
    assert "fidelity: 15 scans" in out and "ATE" not in out
    pts = np.loadtxt(map_csv, delimiter=",")
    assert pts.ndim == 2 and pts.shape[1] == 2 and len(pts) > 100
    assert f"map ({len(pts)} points) -> {map_csv}" in out


def test_cli_oracle(tmp_path):
    map_csv = str(tmp_path / "omap.csv")
    out = _cli(["oracle", "--scans", "20", "--out-map", map_csv], REPO)
    assert "oracle: 20 scans" in out and "(separable EDT)" in out
    assert "ATE vs ground truth" in out
    naive = _cli(["oracle", "--scans", "20", "--naive-edt"], REPO)
    assert "(naive EDT)" in naive
    # both EDTs give the same trajectory, so the same ATE line
    ate_line = [l for l in out.splitlines() if l.startswith("ATE")]
    assert ate_line == [l for l in naive.splitlines() if l.startswith("ATE")]
    assert np.loadtxt(map_csv, delimiter=",").shape[1] == 2


def test_cli_checkpoint_then_resume(tmp_path):
    """``--checkpoint`` after 12 scans, then ``--resume`` over 20: the
    resumed run starts at scan 12 and reports ATE over the resumed scans."""
    ckpt = str(tmp_path / "pf.npz")
    common = ["run", "--mode", "pf", "--particles", "32", "--device", "cpu"]
    out = _cli(common + ["--scans", "12", "--checkpoint", ckpt], REPO)
    assert f"checkpoint -> {ckpt}" in out
    out = _cli(common + ["--scans", "20", "--resume", ckpt], REPO)
    assert f"resumed from {ckpt} at scan 12" in out
    assert "pf: 20 scans" in out and "ATE vs ground truth" in out


def test_cli_supervised(tmp_path):
    run_dir = str(tmp_path / "run")
    out = _cli(["run", "--mode", "pf", "--particles", "32", "--scans", "10",
                "--device", "cpu", "--supervised", "--run-dir", run_dir,
                "--stall-timeout", "300"], REPO)
    assert "supervised run: completed=True attempts=1 stalls=0" in out
    assert "pf: 10 scans" in out and "ATE vs ground truth" in out
    assert os.path.exists(os.path.join(run_dir, "state.npz"))


def test_cli_debug_checks_exit_2_on_a_violation(monkeypatch, capsys):
    from lidar_slam_tpu_torch.__main__ import main
    from lidar_slam_tpu_torch.utils import debug

    monkeypatch.setattr(debug, "validate_state",
                        lambda state, name: [f"{name}.pose: injected"])
    rc = main(["run", "--mode", "fidelity", "--scans", "5", "--device",
               "cpu", "--debug-checks"])
    assert rc == 2
    assert "DEBUG-CHECKS FAILED" in capsys.readouterr().out


def test_cli_serve_answers_a_fetch(tmp_path):
    """``serve`` in a subprocess answers one ``fetch_scan`` with the tour's
    row rounded as the protocol rounds it; then it is killed."""
    import socket

    from lidar_slam_tpu_torch.io import dataset, server

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCK_JAX, "serve", "--scans", "12",
         "--port", str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"serving 12 scans at http://127.0.0.1:{port}" in line, (
            line, proc.stderr.read() if proc.poll() is not None else "")
        row = server.fetch_scan(f"http://127.0.0.1:{port}", 5)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    ranges, _ = dataset.ensure_dataset(n_scans=12, seed=0)
    assert np.array_equal(row, np.asarray([round(float(v), 2)
                                           for v in ranges[5]], np.float32))


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_never_imports_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    assert {os.path.join(PKG, "parallel", f"{m}.py") for m in (
        "mesh", "multihost", "resampling", "sharded", "sharded_edt",
        "sharded_ekf", "sharded_ba", "dryrun")} <= set(files)
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib"), (path, mod)
    # chip_smoke.py imports nothing of the JAX package either
    for mod in _imported_modules(os.path.join(REPO, "chip_smoke.py")):
        assert mod.split(".")[0] != "lidar_slam_tpu", mod


def test_nvcc_flags_keep_exactness():
    cmd = _build.nvcc_command("nvcc", _build.kernel_sources(), "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    names = sorted(os.path.basename(s) for s in _build.kernel_sources())
    assert names == ["corr_volume.cu", "edt.cu", "graph_cond.cu",
                     "scan_intake.cu", "scan_match.cu", "vol_lookup.cu"]
    # the shared device sincos32, included by K3 and K5: a newer header
    # makes the library stale
    assert [os.path.basename(h) for h in _build.kernel_headers()] == [
        "trig32.cuh"]


def test_cuda_device_request_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _entry_calls():
    """Each public entry point called with its default device."""
    import numpy as np

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.models import (ekf_hybrid, ekf_slam, fastslam,
                                             graph_slam, pf_graph_slam,
                                             posegraph, scan_matcher,
                                             submap_graph_slam, submap_slam)
    from lidar_slam_tpu_torch.io import server, simulate
    from lidar_slam_tpu_torch.models import ba, state_io
    from lidar_slam_tpu_torch.parallel import (dryrun, multihost,
                                               sharded_ba)
    from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
    from lidar_slam_tpu_torch.utils import (paging, profiling, rounding,
                                            watchdog)

    ranges = np.full((2, DEFAULT_CONFIG.lidar.n_beams), 5.0, np.float32)
    ecfg = ekf_slam.EkfSlamConfig(n_particles=4)
    odom, obs, vis = (np.zeros((1, 3), np.float32),
                      np.zeros((2, 16, 2), np.float32),
                      np.zeros((2, 16), bool))
    return {
        "run_ekf_slam": lambda: ekf_slam.run_ekf_slam(odom, obs, vis, ecfg),
        "run_ekf_slam_scan": lambda: ekf_slam.run_ekf_slam_scan(ranges, ecfg),
        "run_ekf_hybrid": lambda: ekf_hybrid.run_ekf_hybrid(ranges, ecfg),
        "hybrid_inputs": lambda: ekf_hybrid.hybrid_inputs(ranges),
        "submap_run_scan": lambda: submap_slam.run_scan(ranges,
                                                        DEFAULT_CONFIG),
        "submap_run_host_loop": lambda: submap_slam.run_host_loop(
            ranges, DEFAULT_CONFIG),
        "run_host_loop_paged": lambda: paging.run_host_loop_paged(
            ranges, DEFAULT_CONFIG, paging.PagedAtlas()),
        "SubmapGraphSlam": lambda: submap_graph_slam.SubmapGraphSlam(
            DEFAULT_CONFIG),
        "run_scan": lambda: scan_matcher.run_scan(ranges, DEFAULT_CONFIG),
        "run_host_loop": lambda: scan_matcher.run_host_loop(ranges,
                                                            DEFAULT_CONFIG),
        "run_pf": lambda: fastslam.run_pf(ranges, DEFAULT_CONFIG),
        "make_step_fn": lambda: scan_matcher.make_step_fn(DEFAULT_CONFIG),
        "make_pf_step": lambda: fastslam.make_pf_step(DEFAULT_CONFIG),
        "submap_make_step_fn": lambda: submap_slam.make_step_fn(
            DEFAULT_CONFIG),
        "EkfStepFn": lambda: ekf_slam.EkfStepFn(ecfg),
        "HybridStepFn": lambda: ekf_hybrid.HybridStepFn(ecfg,
                                                        DEFAULT_CONFIG),
        "run_pf_graph": lambda: pf_graph_slam.run_pf_graph(ranges,
                                                           DEFAULT_CONFIG),
        "PFGraphSlam": lambda: pf_graph_slam.PFGraphSlam(DEFAULT_CONFIG),
        "GraphSlam": lambda: graph_slam.GraphSlam(DEFAULT_CONFIG),
        "empty_graph": lambda: posegraph.empty_graph(4, 4),
        "OptimizeFn": lambda: posegraph.OptimizeFn(4, 4),
        "run_streaming_slam": lambda: server.run_streaming_slam(
            "http://127.0.0.1:1", 2, DEFAULT_CONFIG),
        "run_pf_supervised": lambda: watchdog.run_pf_supervised(
            ranges, DEFAULT_CONFIG, "unused-run-dir"),
        "pf_stage_profile": lambda: profiling.pf_stage_profile(n_scans=2),
        "StageTimer": lambda: profiling.StageTimer(),
        "ba_problem_from_numpy": lambda: state_io.ba_problem_from_numpy(
            ba.BAProblem(**simulate.generate_ba_problem(
                n_scans=20, kmax=16, fmax=256, emax=16))),
        "rounding_differences": lambda: rounding.rounding_differences(),
        "initialize": lambda: multihost.initialize(),
        "global_particle_mesh": lambda: multihost.global_particle_mesh(),
        "launch": lambda: multihost.launch(1, []),
        "scaling_report": lambda: multihost.scaling_report(ranges),
        "make_mesh": lambda: mesh_lib.make_mesh(),
        "make_axis": lambda: mesh_lib.make_axis("map"),
        "make_graph_mesh": lambda: sharded_ba.make_graph_mesh(),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(1),
        "tiny_ba_problem": lambda: dryrun.tiny_ba_problem(),
    }


@pytest.mark.parametrize("entry", ["run_scan", "run_host_loop", "run_pf",
                                   "make_step_fn", "make_pf_step",
                                   "submap_make_step_fn", "EkfStepFn",
                                   "HybridStepFn",
                                   "run_pf_graph", "PFGraphSlam", "GraphSlam",
                                   "empty_graph", "OptimizeFn",
                                   "run_ekf_slam",
                                   "run_ekf_slam_scan", "run_ekf_hybrid",
                                   "hybrid_inputs",
                                   "submap_run_scan", "submap_run_host_loop",
                                   "run_host_loop_paged", "SubmapGraphSlam",
                                   "run_streaming_slam", "run_pf_supervised",
                                   "pf_stage_profile", "StageTimer",
                                   "ba_problem_from_numpy",
                                   "rounding_differences", "initialize",
                                   "global_particle_mesh", "launch",
                                   "scaling_report", "make_mesh", "make_axis",
                                   "make_graph_mesh", "dryrun_multichip",
                                   "tiny_ba_problem"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card, every entry point's default device raises; nothing
    quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _entry_calls()[entry]()
