"""The port's checkpoint/resume, streaming server and client, CSV ingest
and profiling against ``lidar_slam_tpu``'s (the cases of
``tests/test_utils_io.py``, and tighter where the port is exact):

- resume from a checkpoint is bit-identical for the fidelity state and for
  the particle filter, generator included; structure and shape mismatches
  and a generator state of the wrong device type are refused;
- ``ScanServer`` bodies are byte-identical to the JAX package's; the relay
  chain relays, 404s included;
- ``run_streaming_slam`` equals the JAX package's exactly (the fidelity
  path is bit-exact) and the port's offline run on the protocol-rounded
  ranges;
- ``native.read_csv`` reads back ``save_csv``; ``trace`` writes a trace;
  ``cost_analysis`` counts a matmul's FLOPs; ``device_time_ms`` and a small
  ``pf_stage_profile`` return numbers on the CPU; the rounding sweep
  counts nothing CPU against CPU.
"""

import dataclasses
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_util import assert_tree_equal
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.io import server
from lidar_slam_tpu_torch.models import fastslam, scan_matcher
from lidar_slam_tpu_torch.utils import checkpoint, profiling, rounding


def _rounded(ranges):
    """The ranges as the protocol serves them: float32 of round(v, 2)."""
    return np.asarray([[round(float(v), 2) for v in row] for row in ranges],
                      np.float32)


def test_checkpoint_fidelity_resume_is_bit_identical(small_dataset,
                                                     tmp_path):
    """40 scans, save, restore into a fresh template, 20 more scans from
    both: the same poses and the same final state, bit for bit."""
    ranges, _ = small_dataset
    cfg = DEFAULT_CONFIG
    angles = scan_matcher.angles_tensor(cfg, "cpu")
    r = torch.as_tensor(ranges)
    state = scan_matcher.init_state(r[0], cfg)
    for t in range(1, 40):
        state, _ = scan_matcher.slam_step(state, r[t], cfg, angles)
    ckpt = os.path.join(tmp_path, "state.npz")
    checkpoint.save_state(ckpt, state)
    restored = checkpoint.load_state(ckpt, scan_matcher.init_state(r[0], cfg))
    assert_tree_equal(restored, state)
    for t in range(40, 60):
        restored, pose_r = scan_matcher.slam_step(restored, r[t], cfg, angles)
        state, pose_c = scan_matcher.slam_step(state, r[t], cfg, angles)
        assert torch.equal(pose_r, pose_c)
    assert_tree_equal(restored, state)


def test_checkpoint_pf_resume_is_bit_identical(small_dataset, tmp_path):
    """A PF state saved after 15 scans and restored into a template of
    another seed continues with the saved generator: the next 10 scans'
    draws, poses and state equal the unbroken run's."""
    ranges, _ = small_dataset
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=32))
    angles = scan_matcher.angles_tensor(cfg, "cpu")
    r = torch.as_tensor(ranges)
    state = fastslam.init_particles(r[0], cfg, seed=0)
    for t in range(1, 15):
        state, _ = fastslam.pf_step(state, r[t], cfg, angles)
    ckpt = os.path.join(tmp_path, "pf.npz")
    checkpoint.save_state(ckpt, state)
    restored = checkpoint.load_state(
        ckpt, fastslam.init_particles(r[0], cfg, seed=99))
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    for t in range(15, 25):
        restored, pose_r = fastslam.pf_step(restored, r[t], cfg, angles)
        state, pose_c = fastslam.pf_step(state, r[t], cfg, angles)
        assert torch.equal(pose_r, pose_c)
    assert_tree_equal(restored._replace(rng=None), state._replace(rng=None))


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    ckpt = os.path.join(tmp_path, "x.npz")
    checkpoint.save_state(ckpt, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_state(ckpt, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_state(ckpt, {"a": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(ckpt, {"a": torch.zeros(4)})


class _CudaGeneratorStub:
    """Saves and restores like a CUDA generator, without a card."""
    device = torch.device("cuda")

    def __init__(self):
        self.state = torch.zeros(16, dtype=torch.uint8)

    def get_state(self):
        return self.state

    def set_state(self, s):
        self.state = s


def test_checkpoint_refuses_a_cpu_generator_state_for_a_cuda_one(tmp_path):
    ckpt = os.path.join(tmp_path, "g.npz")
    gen = torch.Generator()
    gen.manual_seed(3)
    checkpoint.save_state(ckpt, {"rng": gen, "step": 4})
    with pytest.raises(ValueError, match="a cpu generator's state cannot "
                       "restore a cuda generator"):
        checkpoint.load_state(ckpt, {"rng": _CudaGeneratorStub(), "step": 0})
    stub_ckpt = os.path.join(tmp_path, "s.npz")
    checkpoint.save_state(stub_ckpt, {"rng": _CudaGeneratorStub(), "step": 4})
    back = checkpoint.load_state(stub_ckpt, {"rng": _CudaGeneratorStub(),
                                             "step": 0})
    assert back["step"] == 4 and back["rng"].state.shape == (16,)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, None, None


def test_scan_server_bodies_match_jax(small_dataset):
    """Status, content type and body bytes of every request equal the JAX
    package's server's for the same rows; the pose keys are kept."""
    from lidar_slam_tpu.io import server as jserver

    ranges, _ = small_dataset
    ours = server.ScanServer(ranges[:10]).start()
    theirs = jserver.ScanServer(ranges[:10]).start()
    try:
        for q in ("param=0", "param=3&pose_x=1.000&pose_y=2.000", "param=9",
                  "param=10", "param=9999", "param=abc", ""):
            assert _get(f"{ours.url}/?{q}") == _get(f"{theirs.url}/?{q}"), q
        row = server.fetch_scan(ours.url, 3, pose=(1.0, 2.0))
        assert np.array_equal(row, _rounded(ranges[3:4])[0])
        assert ours.last_pose == ("1.000", "2.000")
        assert len(list(server.scan_stream(ours.url, 5))) == 5
        with pytest.raises(urllib.error.HTTPError):
            server.fetch_scan(ours.url, 9999)
    finally:
        ours.stop()
        theirs.stop()


def test_relay_chain_protocol(small_dataset):
    """client -> relay -> dataset server, as the JAX test runs it."""
    ranges, _ = small_dataset
    srv = server.ScanServer(ranges[:10]).start()
    relay = server.RelayServer(srv.url).start()
    try:
        row = server.fetch_scan(relay.url, 4, pose=(3.0, -1.5))
        assert np.array_equal(row, _rounded(ranges[4:5])[0])
        assert relay.last_pose == ("3.000", "-1.500")
        assert relay.n_relayed == 1
        with pytest.raises(urllib.error.HTTPError):   # upstream 404 relayed
            server.fetch_scan(relay.url, 9999)
    finally:
        relay.stop()
        srv.stop()
    dead = server.RelayServer("http://127.0.0.1:1").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            server.fetch_scan(dead.url, 0)
        assert err.value.code == 404
    finally:
        dead.stop()


def test_streaming_slam_matches_jax_exactly(small_dataset):
    """30 streamed scans through the relay: the port's path equals the JAX
    package's streamed path and the port's offline run on the rounded
    ranges, bit for bit; one latency triple a step."""
    from lidar_slam_tpu.io import server as jserver

    ranges, _ = small_dataset
    srv = server.ScanServer(ranges[:30]).start()
    relay = server.RelayServer(srv.url).start()
    try:
        lat = []
        ours, state = server.run_streaming_slam(relay.url, 30, DEFAULT_CONFIG,
                                                device="cpu", latencies=lat)
        theirs, _ = jserver.run_streaming_slam(srv.url, 30, DEFAULT_CONFIG)
    finally:
        relay.stop()
        srv.stop()
    assert ours.shape == (30, 3) and state.step == 30
    assert np.array_equal(ours, np.asarray(theirs))
    offline, _ = scan_matcher.run_host_loop(_rounded(ranges[:30]),
                                            DEFAULT_CONFIG, device="cpu")
    assert np.array_equal(ours, offline)
    assert relay.n_relayed == 30
    assert len(lat) == 29 and all(a <= b <= c for a, b, c in lat)


def test_native_csv_reader_round_trips_save_csv(small_dataset, tmp_path):
    from lidar_slam_tpu_torch import native
    from lidar_slam_tpu_torch.io import dataset

    ranges, _ = small_dataset
    csv = os.path.join(tmp_path, "scans.csv")
    dataset.save_csv(csv, ranges[:20])
    back = native.read_csv(csv, 20, ranges.shape[1])
    np.testing.assert_allclose(back, ranges[:20], atol=1e-6, rtol=0)
    assert np.array_equal(dataset.load_csv(csv), back)
    assert native.read_csv(csv, 50).shape == (20, ranges.shape[1])
    with pytest.raises(FileNotFoundError):
        native.read_csv(os.path.join(tmp_path, "missing.csv"), 2)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = os.path.join(tmp_path, "trace")
    with profiling.trace(log_dir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    assert os.path.getsize(path) > 100
    with open(path) as f:
        assert "traceEvents" in f.read()


def test_cost_analysis_reports_flops():
    costs = profiling.cost_analysis(lambda a, b: a @ b,
                                    torch.zeros(256, 256),
                                    torch.zeros(256, 256))
    assert costs["flops"] == 2 * 256 ** 3


def test_device_time_ms_and_pf_stage_profile_on_the_cpu():
    ms = profiling.device_time_ms(lambda x: x * 2.0,
                                  lambda k: (torch.full((1000,), float(k)),))
    assert 0.0 < ms < 1e3
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=32))
    prof = profiling.pf_stage_profile(cfg, n_scans=12, device="cpu")
    assert tuple(prof) == profiling.PF_STAGES
    assert all(0.0 < v < 1e4 for v in prof.values())


def test_stage_timer_on_the_cpu():
    t = profiling.StageTimer("cpu")
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    assert t.counts["a"] == 2 and "share" in t.report()


def test_rounding_differences_count_nothing_cpu_against_cpu():
    """The card-against-CPU rounding sweep compares like with like: run on
    the CPU, every operation's count is 0."""
    got = rounding.rounding_differences("cpu")
    assert set(got) == {"cos", "sin", "atan2", "sqrt", "einsum eab,eac->ebc",
                        "solve_ex float32 (as f32)",
                        "solve_ex float64 (as f32)"}
    assert all(v == 0 for v in got.values())
