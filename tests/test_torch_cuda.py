"""Kernel tests that need an NVIDIA GPU (Hopper, sm_90a) and nvcc.

They carry the ``cuda`` marker and skip wherever ``torch.cuda`` has no
device. The repository's ``conftest.py`` imports JAX, which the GPU machine
does not have, so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import collections

import numpy as np
import pytest
import torch

from _kernel_cases import (K1_CASES, K2_CASES, K3_CASES, batch_prefix,
                           grid_to, k1_case, k2_case, k3_case,
                           sparse_chunk_case, to_device)
from _kernel_twins import edt_twin, scan_match_twin

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 200, 200), (4, 400, 400), (2, 512, 512),
                                   (3, 37, 70), (8, 256, 256),
                                   (8, 448, 448)])
def test_k1_equals_plain(cuda, shape):
    from lidar_slam_tpu_torch.ops import cuda_edt
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    rng = np.random.default_rng(sum(shape))
    occ = torch.as_tensor(rng.random(shape) < 0.01, device=cuda)
    got = cuda_edt.edt_clamped_cuda(occ)
    torch.cuda.synchronize()
    assert torch.equal(got, edt_clamped(occ))
    assert torch.equal(got.cpu(), edt_clamped(occ.cpu()))


@pytest.mark.parametrize("t_bins,half,s", [(7, 6, 400), (13, 6, 512),
                                           (5, 14, 448), (3, 0, 64)])
def test_k2_equals_plain(cuda, t_bins, half, s):
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    rng = np.random.default_rng(t_bins * half + s)
    metric = cuda_edt.edt_clamped_cuda(
        torch.as_tensor(rng.random((s, s)) < 0.01, device=cuda))
    n = 1079
    cx0 = torch.as_tensor(rng.integers(-20, s + 20, (t_bins, n)),
                          dtype=torch.int32, device=cuda)
    cy0 = torch.as_tensor(rng.integers(-20, s + 20, (t_bins, n)),
                          dtype=torch.int32, device=cuda)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=cuda)
    for n_rows, n_cols in ((s, s), (s // 2, s - 7), (s + 5, s + 5)):
        got = cuda_match.score_volume_cuda(metric, cx0, cy0, valid, n_rows,
                                           n_cols, half)
        torch.cuda.synchronize()
        assert torch.equal(got, score_volume_plain(metric, cx0, cy0, valid,
                                                   n_rows, n_cols, half))


def test_fidelity_cuda_equals_cpu(cuda):
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import scan_matcher
    from lidar_slam_tpu_torch.ops import cuda_edt

    ranges, _ = simulate.generate_dataset(60, seed=3)
    before = cuda_edt.launches
    gpu, _ = scan_matcher.run_scan(ranges, DEFAULT_CONFIG, device=cuda)
    assert cuda_edt.launches > before
    cpu, _ = scan_matcher.run_scan(ranges, DEFAULT_CONFIG, device="cpu")
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.parametrize("b,t_bins,half,s", [(8, 21, 14, 256), (1, 7, 6, 400),
                                             (1, 13, 6, 512), (3, 5, 2, 64)])
def test_k2_batched_equals_plain(cuda, b, t_bins, half, s):
    """The batch axis: closure shapes (B=8, T=21, half=14 on 256^2) and the
    particle filter's shapes as a batch of one, exactly."""
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    rng = np.random.default_rng(b * 1000 + t_bins * half + s)
    metric = cuda_edt.edt_clamped_cuda(
        torch.as_tensor(rng.random((b, s, s)) < 0.01, device=cuda))
    n = 1079
    cx0, cy0 = (torch.as_tensor(rng.integers(-20, s + 20, (b, t_bins, n)),
                                dtype=torch.int32, device=cuda)
                for _ in range(2))
    valid = torch.as_tensor(rng.random((b, n)) < 0.9, device=cuda)
    got = cuda_match.score_volume_cuda(metric, cx0, cy0, valid, s, s, half)
    torch.cuda.synchronize()
    assert got.shape == (b, t_bins, 2 * half + 1, 2 * half + 1)
    assert torch.equal(got, score_volume_plain(metric, cx0, cy0, valid, s, s,
                                               half))
    for i in range(b):
        assert torch.equal(got[i], cuda_match.score_volume_cuda(
            metric[i], cx0[i], cy0[i], valid[i], s, s, half))


def test_graph_cuda_runs_kernels_only(cuda, monkeypatch):
    """GraphSlam on the card: K1 and K2 launch, no CUDA tensor reaches a
    plain version, and keyframes, closures and the path up to the first
    feedback equal the CPU run's."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import graph_slam
    from lidar_slam_tpu_torch.ops import correlative, cuda_edt, cuda_match
    from lidar_slam_tpu_torch.ops import edt as edt_ops

    ranges, _ = simulate.generate_dataset(160, seed=1,
                                          waypoints=simulate.LOOP_WAYPOINTS)
    lc = graph_slam.LoopClosureConfig(min_gap=3)
    cpu = graph_slam.GraphSlam(DEFAULT_CONFIG, lc, device="cpu")
    cpath, _ = cpu.run(ranges, chunk_size=32)

    def no_cuda(plain):
        def guard(*args, **kw):
            assert not any(isinstance(a, torch.Tensor) and a.is_cuda
                           for a in args), plain.__name__
            return plain(*args, **kw)
        return guard

    monkeypatch.setattr(edt_ops, "edt_clamped", no_cuda(edt_ops.edt_clamped))
    monkeypatch.setattr(correlative, "score_volume_plain",
                        no_cuda(correlative.score_volume_plain))
    k1, k2 = cuda_edt.launches, cuda_match.launches
    gpu = graph_slam.GraphSlam(DEFAULT_CONFIG, lc, device=cuda)
    gpath, _ = gpu.run(ranges, chunk_size=32)
    assert cuda_edt.launches > k1 and cuda_match.launches > k2
    assert gpu.kf.count == cpu.kf.count
    assert gpu.closures == cpu.closures and len(gpu.closures) >= 1
    first = (gpu.path_epoch.index(1) if 1 in gpu.path_epoch
             else len(gpath))
    assert np.array_equal(gpath[:first], cpath[:first])


# -- the redesigned kernels at the main paths' shapes and at their edges:
# the cases of tests/_kernel_cases.py, whose twins test_torch_kernel_twins.py
# holds to the plain versions on the CPU

@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_cases_equal_plain(cuda, name):
    from lidar_slam_tpu_torch.ops import cuda_edt
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    occ, r = k1_case(name)
    got = cuda_edt.edt_clamped_cuda(occ.to(cuda), r)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), edt_clamped(occ, r))
    assert torch.equal(got.cpu(), edt_twin(occ, r))
    if r == 10:   # uint8 occupancy with any nonzero byte is occupied
        u8 = occ.to(torch.uint8) * 7
        assert torch.equal(cuda_edt.edt_clamped_cuda(u8.to(cuda)).cpu(),
                           got.cpu())


@pytest.mark.parametrize("name", ["ragged-37x70", "refine-8x448",
                                  "wide-5x1100", "r16", "r64"])
def test_k1_any_band(cuda, name):
    """Every band height, and rows whose width or address rules out the
    16-byte loads (an offset view) or the float4 stores."""
    from lidar_slam_tpu_torch.ops import cuda_edt
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    occ, r = k1_case(name)
    want = edt_clamped(occ, r)
    occ = occ.to(cuda)
    for band in (1, 3, 2 * r + 1, 1000):
        out = torch.full(occ.shape, -1.0, device=cuda)
        cuda_edt.launch(occ, out, r, band)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), band
    flat = torch.zeros(occ.numel() + 3, dtype=torch.bool, device=cuda)
    flat[3:] = occ.flatten()
    shifted = flat[3:].view(occ.shape)          # data_ptr not 16-aligned
    assert torch.equal(cuda_edt.edt_clamped_cuda(shifted, r).cpu(), want)


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_cases_equal_plain(cuda, name):
    from lidar_slam_tpu_torch.ops import cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    args = k2_case(name)
    got = cuda_match.score_volume_cuda(*to_device(args, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), score_volume_plain(*args[:7]))


@pytest.mark.parametrize("name", ["pf-400", "closure-8x256", "off-grid",
                                  "half-20", "cascade-f4"])
def test_k2_halves_pieces_that_overflow(cuda, name):
    """A tile budget of one window forces every chunk's halving, along the
    beams and then the bins (alone with one beam a block)."""
    from lidar_slam_tpu_torch.ops import cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    args = k2_case(name)
    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = to_device(args,
                                                                    cuda)
    want = score_volume_plain(*args[:7])
    extent = [torch.tensor(v, dtype=torch.int32, device=cuda)
              for v in (n_rows, n_cols)]
    for chunk in (None, 1, 64):
        out = torch.full(want.shape, -1.0, device=cuda)
        cuda_match.launch(metric, cx0, cy0, valid, *extent, half, out, bits,
                          chunk, cuda_match.window_cells(half))
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), chunk


def test_k2_any_chunk(cuda):
    """Every beams-per-block at the closure shape, whatever shared memory
    it takes (one of them needs exactly the 48 KB default limit)."""
    from lidar_slam_tpu_torch.ops import cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    args = k2_case("closure-8x256")
    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = to_device(args,
                                                                    cuda)
    want = score_volume_plain(*args[:7])
    extent = [torch.tensor(v, dtype=torch.int32, device=cuda)
              for v in (n_rows, n_cols)]
    assert cuda_match.smem_bytes(21, 64, cuda_match.TILE_CELLS) == 48 * 1024
    for chunk in (8, 16, 33, 64, 97, 135):
        out = torch.full(want.shape, -1.0, device=cuda)
        cuda_match.launch(metric, cx0, cy0, valid, *extent, half, out, bits,
                          chunk)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), chunk


@pytest.mark.parametrize("name", ["keyframes-8x256", "refine-8x448"])
def test_k1_partial_batches_equal_plain(cuda, name):
    """Every partial batch (B = 1 .. 7) the keyframe and refine passes end
    on, each with its own planned band."""
    from lidar_slam_tpu_torch.ops import cuda_edt
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    occ, r = k1_case(name)
    dev_occ = occ.to(cuda)
    for b in range(1, 8):
        got = cuda_edt.edt_clamped_cuda(dev_occ[:b], r)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), edt_clamped(occ[:b], r)), b


def test_k2_partial_batches_equal_plain(cuda):
    """Every partial batch (B = 1 .. 7) of the closure passes, each with
    its own planned beams a block."""
    from lidar_slam_tpu_torch.ops import cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    args = k2_case("closure-8x256")
    dev_args = to_device(args, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = set()
    for b in range(1, 8):
        cut = batch_prefix(args, b)
        got = cuda_match.score_volume_cuda(*batch_prefix(dev_args, b))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), score_volume_plain(*cut[:7])), b
        chunks.add(cuda_match.plan(b, 21, 1079, 14, sms)[0])
    assert len(chunks) == 7


def test_k1_refuses_r_beyond_64(cuda):
    from lidar_slam_tpu_torch.ops import cuda_edt

    occ = torch.zeros((8, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="0..64"):
        cuda_edt.edt_clamped_cuda(occ, 65)


def test_k2_halves_a_sparse_box(cuda):
    """A chunk whose beams hit walls far apart: its sparse box is halved
    along the beams, and the volume stays exact."""
    from lidar_slam_tpu_torch.ops import cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain

    args = sparse_chunk_case()
    got = cuda_match.score_volume_cuda(*to_device(args, cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), score_volume_plain(*args[:7]))


def test_k2_poisons_a_field_off_the_lattice(cuda):
    from lidar_slam_tpu_torch.ops import cuda_match

    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = to_device(
        k2_case("pf-400"), cuda)
    got = cuda_match.score_volume_cuda(metric + 2.0 ** -12, cx0, cy0, valid,
                                       n_rows, n_cols, half, bits)
    assert torch.isnan(got).all()
    got = cuda_match.score_volume_cuda(metric - 2.0 ** -10, cx0, cy0, valid,
                                       n_rows, n_cols, half, bits)
    assert torch.isnan(got).any()


def test_kernels_capture_in_a_cuda_graph(cuda):
    """The raw launches allocate and copy nothing: a CUDA graph of them
    replays to the plain versions' results."""
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match
    from lidar_slam_tpu_torch.ops.correlative import score_volume_plain
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    occ, r = k1_case("keyframes-8x256")
    occ = occ.to(cuda)
    args = k2_case("closure-8x256")
    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = to_device(args,
                                                                    cuda)
    extent = [torch.tensor(v, dtype=torch.int32, device=cuda)
              for v in (n_rows, n_cols)]
    e_out = torch.empty(occ.shape, device=cuda)
    v_out = torch.empty((8, 21, 2 * half + 1, 2 * half + 1), device=cuda)

    def run():
        cuda_edt.launch(occ, e_out, r)
        cuda_match.launch(metric, cx0, cy0, valid, *extent, half, v_out,
                          bits)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    e_out.fill_(-1.0)
    v_out.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(e_out.cpu(), edt_clamped(occ.cpu(), r))
    assert torch.equal(v_out.cpu(), score_volume_plain(*args[:7]))


# -- the EKF and submap families: their kernels' new shapes, and CPU == CUDA

def _museum(n):
    from lidar_slam_tpu_torch.io import simulate

    return simulate.generate_dataset(n, seed=0)


@pytest.mark.parametrize("b", [50, 49])
def test_k1_scan_odometry_shapes_equal_plain(cuda, b):
    """The scan-odometry pre-pass's pair rasters, (50, 448, 448) and the
    tail chunk (49, 448, 448), exactly."""
    from lidar_slam_tpu_torch.config import LidarConfig
    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.ops import cuda_edt, scan_odometry
    from lidar_slam_tpu_torch.ops.edt import edt_clamped

    ranges, _ = _museum(b)
    cfg = LidarConfig()
    angles = torch.as_tensor(sensor.beam_angles(cfg))
    scans = [sensor.read_scan(torch.as_tensor(r), angles, cfg)
             for r in ranges]
    x, y, v = (torch.stack([getattr(s, f) for s in scans])
               for f in ("x", "y", "valid"))
    occ = scan_odometry._raster_centered(x, y, v & (x * x + y * y <= 100.0),
                                         0.05, 448).occ.contiguous()
    assert occ.shape == (b, 448, 448)
    got = cuda_edt.edt_clamped_cuda(occ.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), edt_clamped(occ))


def test_landmarks_cuda_equals_cpu(cuda):
    """Corners and pillars of 100 museum scans: the same bits on the card
    as on the CPU."""
    from lidar_slam_tpu_torch.config import LidarConfig
    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.ops import landmarks

    ranges, _ = _museum(100)
    angles = sensor.beam_angles(LidarConfig())
    for corners in (True, False):
        want = landmarks.extract_landmarks_batch(
            torch.as_tensor(ranges), torch.as_tensor(angles), corners=corners)
        got = landmarks.extract_landmarks_batch(
            torch.as_tensor(ranges, device=cuda),
            torch.as_tensor(angles, device=cuda), corners=corners)
        assert int(want.count.sum()) > 100
        for f in ("rb", "valid", "count"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _ekf_inputs(n, p):
    from lidar_slam_tpu_torch.config import LidarConfig
    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.ops import landmarks

    ranges, _ = _museum(n)
    angles = torch.as_tensor(sensor.beam_angles(LidarConfig()))
    det = landmarks.extract_corners(torch.as_tensor(ranges), angles,
                                    max_range=12.0)
    rng = np.random.default_rng(5)
    draws = [(rng.standard_normal((p, 3)).astype(np.float32),
              np.float32(rng.random() / p)) for _ in range(n - 1)]
    return ranges, det, draws


def test_ekf_ml_step_cuda_equals_cpu(cuda):
    """One EKF-ML step at 1024 particles from a state 60 scans into the
    museum, on the same draws: every state field, the same bits."""
    from lidar_slam_tpu_torch.models import ekf_slam

    cfg = ekf_slam.long_tour_config(1024)
    ranges, det, draws = _ekf_inputs(62, 1024)
    odo = torch.zeros((61, 3))
    _, state = ekf_slam.run_ml(det.rb[1:61], det.valid[1:61], odo[:60],
                               cfg, device="cpu", draws=draws[:60])
    assert int(state.lm_seen.sum()) > 0
    k = int(det.count[61])
    want, west = ekf_slam.ekf_slam_step_ml(
        state, det.rb[61], det.valid[61], cfg, odo=odo[60], draws=draws[60],
        n_det=k)
    moved = ekf_slam.EkfSlamState(*[t.to(cuda) for t in state[:6]],
                                  rng=None)
    got, gest = ekf_slam.ekf_slam_step_ml(
        moved, det.rb[61].to(cuda), det.valid[61].to(cuda), cfg,
        odo=odo[60].to(cuda), draws=draws[60], n_det=k)
    assert torch.equal(gest.cpu(), west)
    for f in EKF_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


EKF_FIELDS = ("poses", "prev_poses", "logw", "lm_mean", "lm_cov", "lm_seen")


def test_hybrid_step_cuda_equals_cpu(cuda):
    """Forty hybrid steps at 1024 particles (the grid term runs K2, the
    keyframe refreshes K1) on the same draws: the same path and state
    bits on the card as on the CPU."""
    from lidar_slam_tpu_torch.models import ekf_hybrid, ekf_slam
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match

    cfg = ekf_slam.long_tour_config(1024)
    ranges, _, draws = _ekf_inputs(41, 1024)
    cpath, cstate = ekf_hybrid.run_ekf_hybrid(ranges, cfg, device="cpu",
                                              draws=draws)
    k1, k2 = cuda_edt.launches, cuda_match.launches
    gpath, gstate = ekf_hybrid.run_ekf_hybrid(ranges, cfg, device=cuda,
                                              draws=draws)
    assert cuda_edt.launches > k1 and cuda_match.launches > k2
    assert torch.equal(gpath.cpu(), cpath)
    for f in EKF_FIELDS:
        assert torch.equal(getattr(gstate.ekf, f).cpu(),
                           getattr(cstate.ekf, f)), f


def test_submap_cuda_equals_cpu(cuda):
    """Submap SLAM over 120 museum scans (several keyframes, a spawned
    submap): path and atlas the same bits on the card as on the CPU."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, SubmapConfig
    from lidar_slam_tpu_torch.models import submap_slam

    cfg = dataclasses.replace(DEFAULT_CONFIG, submaps=SubmapConfig(
        n_submaps=16, submap_capacity=512, k_nearest=4, spawn_dist=0.5))
    ranges, _ = _museum(120)
    cpath, cstate = submap_slam.run_scan(ranges, cfg, device="cpu")
    gpath, gstate = submap_slam.run_scan(ranges, cfg, device=cuda)
    assert cstate.atlas.n_submaps > 1
    assert torch.equal(gpath.cpu(), cpath)
    assert gstate.atlas.n_submaps == cstate.atlas.n_submaps
    for f in ("pts", "sizes", "anchors"):
        assert torch.equal(getattr(gstate.atlas, f).cpu(),
                           getattr(cstate.atlas, f)), f


# -- landmark BA, the robust pose graph, checkpoint/resume and streaming on
# the card

def test_ba_cuda_matches_cpu(cuda):
    """The museum BA problem (K = 512 slots, a 1536^2 reduced system) on
    the card and on the CPU, 15 iterations, TF32 off: within 1e-4."""
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import ba, state_io

    prob = ba.BAProblem(**simulate.generate_ba_problem())
    assert not torch.backends.cuda.matmul.allow_tf32
    got = ba.optimize_ba(state_io.ba_problem_from_numpy(prob, cuda), 15)
    want = ba.optimize_ba(state_io.ba_problem_from_numpy(prob, "cpu"), 15)
    assert (got.poses.cpu() - want.poses).abs().max() <= 1e-4
    assert (got.landmarks.cpu() - want.landmarks).abs().max() <= 1e-4
    assert float(ba.ba_error(got)) < 0.05 * float(ba.ba_error(
        state_io.ba_problem_from_numpy(prob, cuda)))


def _loop_graph(device, seed=0):
    """A pose graph over the loop-700 tour's keyframes (every 7th pose of
    its trajectory): noisy odometry edges, closure edges between revisits,
    and one bad closure edge 2 m and 0.5 rad off."""
    from lidar_slam_tpu_torch.core import se2
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import posegraph

    rng = np.random.default_rng(seed)
    traj = simulate.smooth_trajectory(simulate.LOOP_WAYPOINTS,
                                      speed=0.35)[:700:7]
    gt = torch.as_tensor(traj, dtype=torch.float32)
    k = len(gt)
    g = posegraph.empty_graph(128, 256, device="cpu")
    noise = torch.as_tensor(rng.normal(0, [0.02, 0.02, 0.005], (k, 3)),
                            dtype=torch.float32)
    pose = gt[0]
    for i in range(k):
        g, _ = posegraph.add_node(g, pose)
        if i + 1 < k:
            z = se2.between(gt[i], gt[i + 1]) + noise[i]
            g = posegraph.add_edge(g, i, i + 1, z,
                                   torch.tensor([50., 50., 400.]))
            pose = se2.compose(pose, z)
    closures = [(i, j) for i in range(k) for j in range(i + 20, k)
                if float(torch.dist(gt[i, :2], gt[j, :2])) < 1.0][::5][:12]
    assert len(closures) >= 4
    for n, (i, j) in enumerate(closures):
        z = se2.between(gt[i], gt[j])
        if n == 0:
            z = z + torch.tensor([2.0, -1.5, 0.5])   # the bad closure
        g = posegraph.add_edge(g, i, j, z, torch.tensor([20., 20., 100.]))
    return type(g)(*[t.to(device) for t in g])


def test_robust_posegraph_cuda_is_deterministic_and_near_cpu(cuda):
    """``optimize(robust=True)`` on a loop graph with one bad closure: two
    runs on the card give the same bits (the float64 assembly), and the
    card's poses are within 2e-6 of the CPU's after 10 iterations. Not bit
    for bit: the card's f32 cos/sin and the f32 LU of cuSOLVER round
    differently from the CPU's (``python -m
    lidar_slam_tpu_torch.utils.rounding`` counts how often)."""
    from lidar_slam_tpu_torch.models import posegraph

    want = posegraph.optimize(_loop_graph("cpu"), iters=10, robust=True)
    got = posegraph.optimize(_loop_graph(cuda), iters=10, robust=True)
    again = posegraph.optimize(_loop_graph(cuda), iters=10, robust=True)
    assert torch.equal(got.poses, again.poses)
    assert (got.poses.cpu() - want.poses).abs().max() <= 2e-6
    assert float(posegraph.graph_error(got)) == pytest.approx(
        float(posegraph.graph_error(want)), rel=1e-5)


def test_huber_chi_cuda_equals_cpu(cuda):
    """The robust weights' chi on the same inputs, card == CPU bit for bit:
    the loop graph's edges and 100000 random rows. Its sqrt is taken in
    float64 and rounded once; the card's f32 sqrt would differ from the
    CPU's in about 0.7% of the rows."""
    from lidar_slam_tpu_torch.models import posegraph

    g = _loop_graph("cpu")
    rng = np.random.default_rng(1)
    w = torch.cat([g.edge_w * g.edge_active.float()[:, None],
                   torch.as_tensor(rng.uniform(1, 400, (100000, 3)),
                                   dtype=torch.float32)])
    r = torch.cat([posegraph._edge_residual(g.poses[g.edge_i.long()],
                                            g.poses[g.edge_j.long()],
                                            g.edge_z),
                   torch.as_tensor(rng.normal(0, 0.5, (100000, 3)),
                                   dtype=torch.float32)])
    assert torch.equal(posegraph._huber_chi(w.to(cuda), r.to(cuda)).cpu(),
                       posegraph._huber_chi(w, r))


def test_pf_checkpoint_on_the_card_resumes_bit_identical(cuda, tmp_path):
    """PF-256 on the card: 30 scans, save, restore into a CUDA template of
    another seed, 20 more scans: path and state equal the unbroken run's,
    the CUDA generator included; a CPU template refuses the CUDA state."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.models import fastslam, scan_matcher
    from lidar_slam_tpu_torch.utils import checkpoint

    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=256))
    ranges, _ = _museum(51)
    r = torch.as_tensor(ranges, device=cuda)
    angles = scan_matcher.angles_tensor(cfg, cuda)
    state = fastslam.init_particles(r[0], cfg, seed=0)
    for t in range(1, 31):
        state, _ = fastslam.pf_step(state, r[t], cfg, angles)
    ckpt = str(tmp_path / "pf.npz")
    checkpoint.save_state(ckpt, state)
    restored = checkpoint.load_state(ckpt,
                                     fastslam.init_particles(r[0], cfg, 7))
    for t in range(31, 51):
        restored, pose_r = fastslam.pf_step(restored, r[t], cfg, angles)
        state, pose_c = fastslam.pf_step(state, r[t], cfg, angles)
        assert torch.equal(pose_r, pose_c)
    for f in ("poses", "prev_poses", "logw", "fine_metric"):
        assert torch.equal(getattr(restored, f), getattr(state, f)), f
    with pytest.raises(ValueError, match="cuda generator's state"):
        checkpoint.load_state(ckpt, fastslam.init_particles(r[0].cpu(), cfg))


def test_streaming_on_the_card_equals_offline(cuda):
    """30 museum scans streamed through a relay to the card equal
    ``run_host_loop`` on the card on the protocol-rounded ranges."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import server
    from lidar_slam_tpu_torch.models import scan_matcher

    ranges, _ = _museum(30)
    srv = server.ScanServer(ranges).start()
    relay = server.RelayServer(srv.url).start()
    try:
        got, _ = server.run_streaming_slam(relay.url, 30, DEFAULT_CONFIG,
                                           device=cuda)
    finally:
        relay.stop()
        srv.stop()
    rounded = np.asarray([[round(float(v), 2) for v in row]
                          for row in ranges], np.float32)
    want, _ = scan_matcher.run_host_loop(rounded, DEFAULT_CONFIG, device=cuda)
    assert np.array_equal(got, want)


def _launches_by_shape():
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match

    return (dict(cuda_edt.launches_by_shape),
            dict(cuda_match.launches_by_shape))


def _reset_launches():
    from lidar_slam_tpu_torch.ops import cuda_edt, cuda_match

    for mod in (cuda_edt, cuda_match):
        mod.launches = 0
        mod.launches_by_shape.clear()


def test_captured_fidelity_equals_eager_on_the_card(cuda):
    """60 museum scans: ``run_scan`` and ``run_host_loop`` (CUDA graphs)
    equal the eager ``slam_step`` loop bit for bit, path and final state,
    with the same K1 launches by shape."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.models import scan_matcher

    ranges, _ = _museum(60)
    r = torch.as_tensor(ranges, device=cuda)
    angles = scan_matcher.angles_tensor(DEFAULT_CONFIG, cuda)
    _reset_launches()
    state = scan_matcher.init_state(r[0], DEFAULT_CONFIG)
    want = [np.zeros(3, np.float32)]
    for t in range(1, len(r)):
        state, pose = scan_matcher.slam_step(state, r[t], DEFAULT_CONFIG,
                                             angles, pose_to_host=True)
        want.append(pose)
    eager = _launches_by_shape()
    _reset_launches()
    path, got = scan_matcher.run_scan(ranges, DEFAULT_CONFIG, device=cuda)
    assert _launches_by_shape() == eager and eager[0]
    assert np.array_equal(path.cpu().numpy(), np.stack(want))
    for f in ("pose", "prev_pose", "coarse_metric", "fine_metric",
              "scan_wx", "scan_wy"):
        assert torch.equal(getattr(got, f), getattr(state, f)), f
    assert torch.equal(got.pmap.xy, state.pmap.xy)
    host, _ = scan_matcher.run_host_loop(ranges, DEFAULT_CONFIG, device=cuda)
    assert np.array_equal(host, np.stack(want))


@pytest.mark.parametrize("draws_from", ["generator", "numpy"])
def test_captured_pf_equals_eager_on_the_card(cuda, draws_from):
    """PF-256, 40 museum scans: ``run_pf`` (CUDA graphs) equals the eager
    ``pf_step`` loop bit for bit, with the card's generator (the same
    stream: the generator's state ends equal) and with injected draws; the
    same K1 and K2 launches by shape."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.models import fastslam, scan_matcher

    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=256))
    ranges, _ = _museum(40)
    draws = None
    if draws_from == "numpy":
        rng = np.random.default_rng(1)
        draws = [(rng.standard_normal((256, 3)).astype(np.float32),
                  np.float32(rng.random() / 256)) for _ in ranges[1:]]
    r = torch.as_tensor(ranges, device=cuda)
    angles = scan_matcher.angles_tensor(cfg, cuda)
    _reset_launches()
    state = fastslam.init_particles(r[0], cfg, seed=0)
    want = [torch.zeros(3, device=cuda)]
    for t in range(1, len(r)):
        state, pose = fastslam.pf_step(
            state, r[t], cfg, angles, None if draws is None else draws[t - 1])
        want.append(pose)
    eager = _launches_by_shape()
    _reset_launches()
    path, got = fastslam.run_pf(ranges, cfg, seed=0, device=cuda, draws=draws)
    assert _launches_by_shape() == eager and eager[0] and eager[1]
    assert torch.equal(path, torch.stack(want))
    for f in ("poses", "prev_poses", "logw", "fine_metric", "clamp_frac"):
        assert torch.equal(getattr(got, f), getattr(state, f)), f
    assert torch.equal(got.rng.get_state(), state.rng.get_state())


def test_capture_refuses_a_host_sync(cuda):
    """A body that reads the device on the host raises at its warm-up
    (the sync debug mode is "error" there and in the capture); a clean
    body captures, replays and counts nothing it did not launch."""
    from lidar_slam_tpu_torch.utils import graphs

    runner = graphs.Graphs(cuda)
    buf = torch.zeros(3, device=cuda)
    with pytest.raises(RuntimeError):
        runner.run("sync", lambda b: b.add_(float(b.sum().item())), buf)
    for _ in range(3):
        runner.run("clean", lambda b: b.add_(1.0), buf)
    assert torch.equal(buf.cpu(), torch.full((3,), 3.0))
    assert len(runner) == 1 and runner.pool_bytes() >= 0
    assert torch.cuda.get_sync_debug_mode() == 0


# -- the captured graph frontends, submap, EKF and hybrid drivers (CUDA
# graphs) against their eager loops

@pytest.mark.parametrize("frontend", ["graph", "submap-graph", "pf-graph"])
def test_captured_graph_frontends_equal_eager_on_the_card(cuda, frontend):
    """160 loop-tour scans in chunks of 32, closures from min_gap 3 (a
    feedback happens): the captured run (frontend and backend) equals
    ``eager=True`` bit for bit, path, keyframes, closures, attempts and
    final state, with the same K1 and K2 launches by shape."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import graph_slam, pf_graph_slam
    from lidar_slam_tpu_torch.models.submap_graph_slam import SubmapGraphSlam

    ranges, _ = simulate.generate_dataset(160, seed=1,
                                          waypoints=simulate.LOOP_WAYPOINTS)
    lc = graph_slam.LoopClosureConfig(min_gap=3,
                                      weak_closures=frontend == "pf-graph")
    cfg = DEFAULT_CONFIG
    if frontend == "pf-graph":
        cfg = dataclasses.replace(cfg, particles=ParticleConfig(
            n_particles=256))
    runs = []
    for eager in (False, True):
        _reset_launches()
        if frontend == "pf-graph":
            gs = pf_graph_slam.PFGraphSlam(cfg, lc, device=cuda, eager=eager)
        else:
            cls = (graph_slam.GraphSlam if frontend == "graph"
                   else SubmapGraphSlam)
            gs = cls(cfg, lc, device=cuda, eager=eager)
        path, opt = gs.run(ranges, chunk_size=32)
        runs.append((gs, path, opt, _launches_by_shape()))
    (g, path, opt, counts), (e, epath, eopt, ecounts) = runs
    assert counts == ecounts and counts[0] and counts[1]
    assert np.array_equal(path, epath) and np.array_equal(opt, eopt)
    assert g.closures == e.closures and g.path_epoch == e.path_epoch
    assert g.attempt_log == e.attempt_log
    state, estate = g.final_state, e.final_state
    for f in state._fields:
        a, b = getattr(state, f), getattr(estate, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f


def test_captured_submap_equals_eager_on_the_card(cuda):
    """120 museum scans with a pool of 4 small submaps (every slot opened,
    then the pool-full branch): ``run_scan`` equals the eager
    ``slam_step`` loop, path and atlas, with the same K1 launches."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, SubmapConfig
    from lidar_slam_tpu_torch.models import scan_matcher, submap_slam

    cfg = dataclasses.replace(DEFAULT_CONFIG, submaps=SubmapConfig(
        n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
        spawn_fill_frac=0.8))
    ranges, _ = _museum(120)
    r = torch.as_tensor(ranges, device=cuda)
    angles = scan_matcher.angles_tensor(cfg, cuda)
    _reset_launches()
    state = submap_slam.init_state(r[0], cfg)
    want = [state.pose]
    for t in range(1, len(r)):
        state, pose = submap_slam.slam_step(state, r[t], cfg, angles)
        want.append(pose)
    eager = _launches_by_shape()
    _reset_launches()
    path, got = submap_slam.run_scan(ranges, cfg, device=cuda)
    assert _launches_by_shape() == eager and eager[0]
    assert torch.equal(path, torch.stack(want))
    assert (got.atlas.n_submaps, got.atlas.active) == (4, 3)
    assert (state.atlas.n_submaps, state.atlas.active) == (4, 3)
    for f in ("pts", "sizes", "anchors"):
        assert torch.equal(getattr(got.atlas, f), getattr(state.atlas, f)), f


def test_captured_paged_loop_equals_eager_on_the_card(cuda):
    """The paged host loop (pool of 4, paging every 4 scans) through the
    captured step equals the same loop with the eager ``slam_step``: path,
    pages, archive and final atlas, with the same K1 launches by shape."""
    import dataclasses

    from _eager_loops import eager_paged
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, SubmapConfig
    from lidar_slam_tpu_torch.utils import paging

    cfg = dataclasses.replace(DEFAULT_CONFIG, submaps=SubmapConfig(
        n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
        spawn_fill_frac=0.8))
    ranges, _ = _museum(120)
    runs = []
    for run in (eager_paged, paging.run_host_loop_paged):
        _reset_launches()
        paged = paging.PagedAtlas(near_dist=1.0, keep_free=2)
        path, final = run(ranges, cfg, paged, manage_every=4, device=cuda)
        runs.append((path, final, paged, _launches_by_shape()))
    (epath, efinal, epaged, ecounts), (path, final, paged, counts) = runs
    assert counts == ecounts and counts[0]
    assert np.array_equal(path, epath)
    assert (paged.pages_out, paged.pages_in) == (epaged.pages_out,
                                                 epaged.pages_in) != (0, 0)
    assert (final.atlas.n_submaps, final.atlas.active) == (
        efinal.atlas.n_submaps, efinal.atlas.active)
    for f in ("pts", "sizes", "anchors"):
        assert torch.equal(getattr(final.atlas, f),
                           getattr(efinal.atlas, f)), f


@pytest.mark.parametrize("draws_from", ["generator", "numpy"])
def test_captured_ekf_equals_eager_on_the_card(cuda, draws_from):
    """EKF-1024 ML association over 60 museum scans and the known-
    association filter over 120 steps: the captured runs equal the eager
    step loops bit for bit (path, banks, the generator's state)."""
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import ekf_slam

    cfg = ekf_slam.long_tour_config(1024)
    ranges, det, draws = _ekf_inputs(61, 1024)
    draws = None if draws_from == "generator" else draws
    obs, valid = det.rb[1:].to(cuda), det.valid[1:].to(cuda)
    odo = torch.zeros((60, 3), device=cuda)
    counts = det.count[1:].numpy()
    state = ekf_slam.init_ekf_slam(cfg, 0, cuda)
    want = [torch.zeros(3, device=cuda)]
    for t in range(60):
        state, est = ekf_slam.ekf_slam_step_ml(
            state, obs[t], valid[t], cfg, odo=odo[t],
            draws=None if draws is None else draws[t], n_det=int(counts[t]))
        want.append(est)
    path, got = ekf_slam.run_ml(obs, valid, odo, cfg, device=cuda,
                                draws=draws, counts=counts)
    assert torch.equal(path, torch.stack(want))
    for f in EKF_FIELDS:
        assert torch.equal(getattr(got, f), getattr(state, f)), f
    assert torch.equal(got.rng.get_state(), state.rng.get_state())

    kodom, kobs, kvis, _, lms = simulate.generate_ekf_dataset(n_scans=120,
                                                              seed=2)
    kcfg = ekf_slam.EkfSlamConfig(n_particles=1024,
                                  max_landmarks=lms.shape[0])
    kdraws = None if draws is None else _ekf_inputs(121, 1024)[2]
    state = ekf_slam.init_ekf_slam(kcfg, 0, cuda)
    want = [torch.zeros(3, device=cuda)]
    for t in range(len(kodom)):
        state, est = ekf_slam.ekf_slam_step(
            state, torch.as_tensor(kodom[t], device=cuda),
            torch.as_tensor(kobs[t + 1], device=cuda),
            torch.as_tensor(kvis[t + 1], device=cuda), kcfg,
            None if kdraws is None else kdraws[t])
        want.append(est)
    path, got = ekf_slam.run_ekf_slam(kodom, kobs, kvis, kcfg, device=cuda,
                                      draws=kdraws)
    assert torch.equal(path, torch.stack(want))
    for f in EKF_FIELDS:
        assert torch.equal(getattr(got, f), getattr(state, f)), f


def test_captured_hybrid_equals_eager_on_the_card(cuda):
    """Forty hybrid steps at 1024 particles on the same draws: the captured
    ``run_ekf_hybrid`` equals the eager ``hybrid_step`` loop bit for bit,
    with the same K1 and K2 launches by shape."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.models import ekf_hybrid, ekf_slam, scan_matcher
    from lidar_slam_tpu_torch.ops import landmarks
    from lidar_slam_tpu_torch.ops.scan_odometry import pairwise_odometry

    cfg = ekf_slam.long_tour_config(1024)
    ranges, _, draws = _ekf_inputs(41, 1024)
    r = torch.as_tensor(ranges, device=cuda)
    angles = scan_matcher.angles_tensor(DEFAULT_CONFIG, cuda)
    _reset_launches()   # the run's pre-pass is counted in both
    det = landmarks.extract_corners(r, angles, max_range=12.0)
    odo = pairwise_odometry(r, angles, DEFAULT_CONFIG.lidar)
    counts = det.count.cpu().numpy()
    state = ekf_hybrid.init_hybrid(r[0], cfg, DEFAULT_CONFIG, 0)
    want = [torch.zeros(3, device=cuda)]
    for t in range(1, len(r)):
        state, est = ekf_hybrid.hybrid_step(
            state, r[t], det.rb[t], det.valid[t], odo[t - 1], cfg,
            DEFAULT_CONFIG, angles, draws[t - 1], n_det=int(counts[t]))
        want.append(est)
    eager = _launches_by_shape()
    _reset_launches()
    path, got = ekf_hybrid.run_ekf_hybrid(ranges, cfg, DEFAULT_CONFIG,
                                          device=cuda, draws=draws)
    assert _launches_by_shape() == eager and eager[0] and eager[1]
    assert torch.equal(path, torch.stack(want))
    for f in EKF_FIELDS:
        assert torch.equal(getattr(got.ekf, f), getattr(state.ekf, f)), f
    assert torch.equal(got.fine_metric, state.fine_metric)


def test_captured_step_makes_its_constants_without_a_sync(cuda):
    """With ``device.constant``'s cache empty, a captured EKF step's
    warm-up (under the sync debug mode "error") makes the step's constants
    itself: the copies from pinned memory do not synchronize."""
    from lidar_slam_tpu_torch import device
    from lidar_slam_tpu_torch.models import ekf_slam

    cfg = ekf_slam.long_tour_config(256)
    _, det, _ = _ekf_inputs(11, 256)
    device.constant.cache_clear()
    path, state = ekf_slam.run_ml(det.rb[1:], det.valid[1:],
                                  torch.zeros((10, 3)), cfg, device=cuda,
                                  counts=det.count[1:].numpy())
    assert torch.isfinite(path).all() and int(det.count[1:].sum()) > 0


# -- the captured graph backend and BA (CUDA graphs) against their eager
# helpers

def test_captured_backend_helpers_equal_eager_on_the_card(cuda):
    """Keyframe rasters, closure matching and fine refinement at every
    bucket width B = 1..8, two batches a width through one graph each: the
    same bits as the eager helpers on the same rows, with the same K1 and
    K2 launches by shape."""
    import _backend_cases as cases
    from lidar_slam_tpu_torch.models import graph_slam

    lc = graph_slam.LoopClosureConfig()
    x, y, v, gt = cases.keyframes(cuda)
    backend = graph_slam._Backend(cases.store(x, y, v), lc,
                                  cases.N_KEYFRAMES, cuda, eager=False)
    fine = dict(pixel=lc.fine_pixel, size=lc.fine_size, iters=lc.fine_iters,
                step_t0=lc.fine_step_t0, step_r0=lc.fine_step_r0,
                max_range=lc.fine_range)
    for b in cases.WIDTHS:
        for seed, (olds, curs) in enumerate(cases.batches(b)):
            g = cases.guesses(gt, olds, curs, seed)
            _reset_launches()
            backend.raster(olds)
            got = (backend.store.metric[olds], backend.match(olds, curs, g),
                   backend.refine(olds, curs, g))
            captured = _launches_by_shape()
            _reset_launches()
            metric = graph_slam._raster_edt_batch(
                x[olds], y[olds], v[olds], lc.raster_size, lc.raster_pixel)
            gt_dev = torch.as_tensor(g, device=cuda)
            want = (metric, graph_slam._match_keyframes_batch(
                metric, x[curs], y[curs], v[curs], gt_dev, lc),
                graph_slam._refine_rel_batch(
                    x[olds], y[olds], v[olds], x[curs], y[curs], v[curs],
                    gt_dev, **fine))
            assert _launches_by_shape() == captured, b
            for a, w in zip(got, want):
                assert torch.equal(a, w), b
    assert len(backend.graphs) == 3 * len(cases.WIDTHS)


@pytest.mark.parametrize("robust", [True, False])
def test_captured_optimize_equals_eager_on_the_card(cuda, robust):
    """The loop graph with a bad closure: ``OptimizeFn`` (one iteration a
    replay) equals ``posegraph.optimize`` bit for bit, twice."""
    from lidar_slam_tpu_torch.models import posegraph

    g = _loop_graph(cuda)
    fn = posegraph.OptimizeFn(g.poses.shape[0], g.edge_i.shape[0], cuda)
    want = posegraph.optimize(g, iters=10, robust=robust).poses
    for _ in range(2):
        assert torch.equal(fn(g, iters=10, robust=robust).poses, want)
    assert len(fn.graphs) == 1


def test_captured_optimize_ba_equals_eager_on_the_card(cuda):
    """The museum BA problem and a moved copy, through one graph: the
    captured ``optimize_ba`` equals ``optimize_ba_eager`` bit for bit."""
    import _backend_cases as cases
    from lidar_slam_tpu_torch.models import ba

    for p in cases.ba_problems(cuda):
        got = ba.optimize_ba(p, iters=5)
        want = ba.optimize_ba_eager(p, iters=5)
        assert torch.equal(got.poses, want.poses)
        assert torch.equal(got.landmarks, want.landmarks)


def test_captured_reraster_equals_eager_on_the_card(cuda):
    """PF-graph's re-raster of a rebuilt map around two keyframes: the
    captured graph equals ``_reraster``, K1 included."""
    import _backend_cases as cases
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.core.gridmap import PointMap
    from lidar_slam_tpu_torch.models import graph_slam, pf_graph_slam

    x, y, v, gt = cases.keyframes(cuda)
    gs = pf_graph_slam.PFGraphSlam(DEFAULT_CONFIG,
                                   max_keyframes=cases.N_KEYFRAMES,
                                   device=cuda)
    for buf, t in ((gs._kf_dx, x), (gs._kf_dy, y), (gs._kf_dv, v)):
        buf.copy_(t)
    xy, size = graph_slam._rebuilt_map_points(
        x.cpu().numpy(), y.cpu().numpy(), v.cpu().numpy(),
        gt.astype(np.float32), 8192)
    for k in (3, 11):
        pose = torch.as_tensor(gt[k], dtype=torch.float32, device=cuda)
        pmap = PointMap(xy=torch.as_tensor(xy, device=cuda),
                        size=torch.as_tensor(np.int32(size), device=cuda),
                        keyframe_pose=pose)
        fine, metric = gs._rerastered(pmap, k)
        wfine, wmetric = pf_graph_slam._reraster(pmap, x[k], y[k], v[k],
                                                 pose, DEFAULT_CONFIG)
        assert torch.equal(metric, wmetric)
        for f in ("occ", "n_rows", "n_cols", "origin"):
            assert torch.equal(getattr(fine, f), getattr(wfine, f)), f


def test_captured_graph_backend_without_feedback_equals_eager_on_the_card(
        cuda):
    """GraphSlam on 160 loop-tour scans without feedback: captured equals
    ``eager=True``, path, keyframe poses, closures and attempts, with the
    same launches by shape."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import graph_slam

    ranges, _ = simulate.generate_dataset(160, seed=1,
                                          waypoints=simulate.LOOP_WAYPOINTS)
    lc = graph_slam.LoopClosureConfig(min_gap=3)
    runs = []
    for eager in (False, True):
        _reset_launches()
        gs = graph_slam.GraphSlam(DEFAULT_CONFIG, lc, device=cuda,
                                  eager=eager)
        path, opt = gs.run(ranges, chunk_size=32, feedback=False)
        runs.append((gs, path, opt, _launches_by_shape()))
    (g, path, opt, counts), (e, epath, eopt, ecounts) = runs
    assert counts == ecounts and counts[1]
    assert np.array_equal(path, epath) and np.array_equal(opt, eopt)
    assert g.closures == e.closures and len(g.closures) >= 1
    assert g.attempt_log == e.attempt_log and g._epoch == 0


# -- the drivers that branch on the card (CUDA graph conditional nodes,
# ``utils/graphs.cond``) with no host sync after scan 1

def _no_sync_case(driver, cuda):
    """(make_step, init_state, inputs(t), eager_step(state, t) -> (state,
    pose)) of a no-sync driver on 60 museum scans (PF and hybrid at 256
    particles, numpy draws)."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.models import (ekf_hybrid, ekf_slam, fastslam,
                                             scan_matcher)
    from lidar_slam_tpu_torch.ops import landmarks
    from lidar_slam_tpu_torch.ops.scan_odometry import pairwise_odometry

    ranges, _, draws = _ekf_inputs(60, 256)
    r = torch.as_tensor(ranges, device=cuda)
    cfg = DEFAULT_CONFIG
    angles = scan_matcher.angles_tensor(cfg, cuda)
    if driver == "submap":   # a pool of 4 small submaps: it fills
        from lidar_slam_tpu_torch.config import SubmapConfig
        from lidar_slam_tpu_torch.models import submap_slam

        scfg = dataclasses.replace(cfg, submaps=SubmapConfig(
            n_submaps=4, submap_capacity=512, k_nearest=2, spawn_dist=0.4,
            spawn_fill_frac=0.8))
        return (lambda: submap_slam.make_step_fn(scfg, cuda),
                lambda: submap_slam.init_state(r[0], scfg),
                lambda t: (r[t],),
                lambda s, t: submap_slam.slam_step(s, r[t], scfg, angles))
    if driver == "fidelity":
        return (lambda: scan_matcher.make_step_fn(cfg, cuda),
                lambda: scan_matcher.init_state(r[0], cfg),
                lambda t: (r[t],),
                lambda s, t: scan_matcher.slam_step(s, r[t], cfg, angles))
    if driver == "pf":
        pcfg = dataclasses.replace(cfg, particles=ParticleConfig(
            n_particles=256))
        return (lambda: fastslam.make_pf_step(pcfg, cuda),
                lambda: fastslam.init_particles(r[0], pcfg, 0),
                lambda t: (r[t], draws[t - 1]),
                lambda s, t: fastslam.pf_step(s, r[t], pcfg, angles,
                                              draws[t - 1]))
    ecfg = ekf_slam.long_tour_config(256)
    det = landmarks.extract_corners(r, angles, max_range=12.0)
    odo = pairwise_odometry(r, angles, cfg.lidar)
    counts = det.count.cpu().numpy()

    def inputs(t):
        return (r[t], det.rb[t], det.valid[t], odo[t - 1], int(counts[t]),
                draws[t - 1])

    return (lambda: ekf_hybrid.HybridStepFn(ecfg, cfg, cuda),
            lambda: ekf_hybrid.init_hybrid(r[0], ecfg, cfg, 0),
            inputs,
            lambda s, t: ekf_hybrid.hybrid_step(
                s, *inputs(t)[:4], ecfg, cfg, angles, inputs(t)[5],
                n_det=inputs(t)[4]))


@pytest.mark.parametrize("driver", ["fidelity", "pf", "hybrid", "submap"])
def test_no_sync_driver_equals_eager_under_the_sync_error_mode(cuda,
                                                               driver):
    """Scans 2..T-1 through ``advance`` (and the path's row writes) under
    the sync debug mode "error" raise nothing; the path, the final state's
    host ``mini_updated`` (and the submap atlas's slot ints, its pool full)
    and the K1/K2 launches by shape (read back by ``finish``) equal the
    eager loop's."""
    make_step, init, inputs, eager_step = _no_sync_case(driver, cuda)
    _reset_launches()
    state = init()
    want = [torch.zeros(3, device=cuda)]
    for t in range(1, 60):
        state, pose = eager_step(state, t)
        want.append(torch.as_tensor(pose, device=cuda))
    eager = _launches_by_shape()
    _reset_launches()
    step = make_step()
    got = step.advance(init(), *inputs(1))
    path = [torch.zeros(3, device=cuda), step.pose.clone()]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2, 60):
            got = step.advance(got, *inputs(t))
            path.append(step.pose.clone())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = step.finish(got)
    assert torch.equal(torch.stack(path), torch.stack(want))
    assert type(got.mini_updated) is bool
    assert got.mini_updated == state.mini_updated
    if driver == "submap":
        ints = (got.atlas.n_submaps, got.atlas.active)
        assert all(type(v) is int for v in ints)
        assert ints == (state.atlas.n_submaps, state.atlas.active) == (4, 3)
        for f in ("pts", "sizes", "anchors"):
            assert torch.equal(getattr(got.atlas, f),
                               getattr(state.atlas, f)), f
    assert _launches_by_shape() == eager and eager[0]
    assert len(step.graphs) == 1


@pytest.mark.parametrize("frontend", ["graph", "pf-graph", "submap-graph"])
def test_no_sync_graph_frontend_steps_on_the_card(cuda, frontend):
    """160 loop-tour scans in chunks of 32: every frontend step after scan 1
    runs under the sync debug mode "error", and the run equals
    ``eager=True`` (path, closures, attempt log) with the same K1/K2
    launches by shape."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import graph_slam, pf_graph_slam
    from lidar_slam_tpu_torch.models.submap_graph_slam import SubmapGraphSlam

    class Strict:
        """A frontend whose captured step raises on any host sync."""

        def __init__(self, frontend):
            self.frontend = frontend

        def init_state(self, ranges0, cfg):
            return self.frontend.init_state(ranges0, cfg)

        def make_step_fn(self, cfg, device):
            step = self.frontend.make_step_fn(cfg, device)
            outer = self

            class Step:
                def __getattr__(self, name):
                    return getattr(step, name)

                def advance(self, state, ranges):
                    if state.step == 1:
                        return step.advance(state, ranges)
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        return step.advance(state, ranges)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)

            outer.step = step
            return Step()

    ranges, _ = simulate.generate_dataset(160, seed=1,
                                          waypoints=simulate.LOOP_WAYPOINTS)
    lc = graph_slam.LoopClosureConfig(min_gap=3,
                                      weak_closures=frontend == "pf-graph")
    cfg = DEFAULT_CONFIG
    if frontend == "pf-graph":
        cfg = dataclasses.replace(cfg, particles=ParticleConfig(
            n_particles=256))
    runs = []
    for eager in (False, True):
        _reset_launches()
        if frontend == "pf-graph":
            gs = pf_graph_slam.PFGraphSlam(cfg, lc, device=cuda, eager=eager)
        elif frontend == "submap-graph":
            gs = SubmapGraphSlam(cfg, lc, device=cuda, eager=eager)
        else:
            gs = graph_slam.GraphSlam(cfg, lc, device=cuda, eager=eager)
        if not eager:
            gs.frontend = Strict(gs.frontend)
        path, _ = gs.run(ranges, chunk_size=32)
        runs.append((gs, path, _launches_by_shape()))
    (g, path, counts), (e, epath, ecounts) = runs
    assert counts == ecounts and counts[0] and counts[1]
    assert np.array_equal(path, epath)
    assert g.closures == e.closures and g.attempt_log == e.attempt_log
    assert len(g.frontend.step.graphs) == 1
    assert type(g.final_state.mini_updated) is bool
    assert g.final_state.mini_updated == e.final_state.mini_updated
    if frontend == "submap-graph":
        a, b = g.final_state.atlas, e.final_state.atlas
        assert type(a.n_submaps) is int and a.n_submaps >= 2
        assert (a.n_submaps, a.active) == (b.n_submaps, b.active)
        assert g.anchor_assoc.keys() == e.anchor_assoc.keys()


# -- one graph for every detection count: the association loop as a CUDA
# graph WHILE node (``utils/graphs.while_loop``), and the scan-odometry
# pre-pass's chunk graphs

def test_while_node_runs_its_body_count_times_on_the_card(cuda):
    """One captured graph replayed with counts 16, 0, 3 and 0: the body
    runs exactly that many times (none for 0: the buffer keeps its value),
    and its device counter, read by ``fetch``, books each iteration."""
    from lidar_slam_tpu_torch.utils import graphs

    runner = graphs.Graphs(cuda)
    bufs = {"n": torch.zeros((), dtype=torch.int64, device=cuda),
            "sum": torch.zeros((), device=cuda)}

    def body(b):
        k = torch.zeros((), dtype=torch.int64, device=cuda)
        go = b["n"] > k

        def once():
            b["sum"].add_(k.to(torch.float32) + 1.0)
            k.add_(1)
            torch.lt(k, b["n"], out=go)

        graphs.while_loop(go, once)

    total = 0
    for n in (16, 0, 3, 0):
        bufs["n"].fill_(n)
        bufs["sum"].fill_(-1.0)
        runner.run(None, body, bufs)
        assert float(bufs["sum"]) == -1.0 + n * (n + 1) / 2
        total += n
    assert len(runner) == 1 and [a.kind for a in runner.arms] == ["while"]
    graphs.fetch(runners=[runner])
    assert runner.arms[0].settled == total


def _every_count(rb, valid, m=16):
    """Detections whose count runs 0, 1, ..., m, 0, 1, ... over the scans:
    a scan's rows repeated into its first ``count`` slots."""
    rb, valid = rb.clone(), valid.clone()
    counts = valid.sum(dim=-1)
    for t in range(rb.shape[0]):
        want, have = t % (m + 1), max(int(counts[t]), 1)
        rb[t] = rb[t, torch.arange(m, device=rb.device) % have]
        valid[t] = torch.arange(m, device=rb.device) < want
    return rb, valid, valid.sum(dim=-1).to(torch.int32)


@pytest.mark.parametrize("filt", ["ekf", "hybrid"])
def test_filter_step_is_one_graph_for_every_count(cuda, filt):
    """EKF-256 and hybrid-256 on 60 museum scans whose detection counts take
    every value 0..16: after scan 1 every step runs under the sync debug
    mode "error"; one graph; the path and state equal the eager loop's bit
    for bit (with the same K1/K2 launches by shape for the hybrid); the
    WHILE node's iterations equal the valid rows it looped over."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.models import ekf_hybrid, ekf_slam, scan_matcher
    from lidar_slam_tpu_torch.utils import graphs

    cfg = ekf_slam.long_tour_config(256)
    ranges, _, draws = _ekf_inputs(60, 256)
    inputs = ekf_hybrid.hybrid_inputs(ranges, DEFAULT_CONFIG, device=cuda)
    rb, valid, count = _every_count(inputs.det.rb, inputs.det.valid)
    angles = scan_matcher.angles_tensor(DEFAULT_CONFIG, cuda)
    counts = count.tolist()
    assert set(counts) == set(range(17))
    _reset_launches()
    if filt == "ekf":
        state = ekf_slam.init_ekf_slam(cfg, 0, cuda)
        step = ekf_slam.EkfStepFn(cfg, cuda)
    else:
        state = ekf_hybrid.init_hybrid(inputs.ranges[0], cfg,
                                       DEFAULT_CONFIG, 0)
        step = ekf_hybrid.HybridStepFn(cfg, DEFAULT_CONFIG, cuda)
    want, path, eager_state = [], [], state
    for t in range(1, 60):
        if filt == "ekf":
            eager_state, est = ekf_slam.ekf_slam_step_ml(
                eager_state, rb[t], valid[t], cfg, odo=inputs.odo[t - 1],
                draws=draws[t - 1], n_det=counts[t])
        else:
            eager_state, est = ekf_hybrid.hybrid_step(
                eager_state, inputs.ranges[t], rb[t], valid[t],
                inputs.odo[t - 1], cfg, DEFAULT_CONFIG, angles,
                draws[t - 1], n_det=counts[t])
        want.append(est)
    eager = _launches_by_shape()
    _reset_launches()
    for t in range(1, 60):
        args = (rb[t], valid[t], inputs.odo[t - 1])
        if filt == "ekf":
            with graphs.no_host_sync(cuda):
                state, _ = step(state, *args, draws[t - 1])
        elif t == 1:
            state = step.advance(state, inputs.ranges[t], *args, counts[t],
                                 draws[t - 1])
        else:
            with graphs.no_host_sync(cuda):
                state = step.advance(state, inputs.ranges[t], *args,
                                     draws=draws[t - 1])
        path.append(step.pose.clone())
    state = graphs.finish(step, state)
    assert torch.equal(torch.stack(path), torch.stack(want))
    got = state if filt == "ekf" else state.ekf
    ref = eager_state if filt == "ekf" else eager_state.ekf
    for f in EKF_FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert len(step.graphs) == 1
    loops = [a for a in step.graphs.arms if a.kind == "while"]
    assert len(loops) == 1
    # the hybrid's scan 1 is its eager seed step, outside the graph
    assert loops[0].settled == sum(counts[1 if filt == "ekf" else 2:60])
    if filt == "hybrid":
        assert _launches_by_shape() == eager and eager[0] and eager[1]


def test_prepass_graphs_equal_the_eager_chunk_loop_on_the_card(cuda):
    """``pairwise_odometry`` on 120 museum scans (chunks of 50, 50 and the
    19-pair tail, each a replay of its width's graph) against the eager
    loop (``read_scan`` a scan, ``match_batch`` a chunk): the same deltas
    bit for bit and the same K1 launches by shape."""
    from lidar_slam_tpu_torch.config import LidarConfig
    from lidar_slam_tpu_torch.core import sensor
    from lidar_slam_tpu_torch.ops import scan_odometry

    ranges, _ = _museum(120)
    cfg = LidarConfig()
    r = torch.as_tensor(ranges, device=cuda)
    angles = torch.as_tensor(sensor.beam_angles(cfg), device=cuda)
    _reset_launches()
    scans = [sensor.read_scan(x, angles, cfg) for x in r]
    x, y, v = (torch.stack([getattr(s, f) for s in scans])
               for f in ("x", "y", "valid"))
    want = []
    for a in range(0, 119, 50):
        b = min(a + 50, 119)
        want.append(scan_odometry.match_batch(
            x[a:b], y[a:b], v[a:b], x[a + 1:b + 1], y[a + 1:b + 1],
            v[a + 1:b + 1], torch.zeros((b - a, 3), device=cuda),
            max_range=10.0, pixel=0.05, size=448, iters=7, step_t0=0.03,
            step_r0=0.03))
    eager = _launches_by_shape()
    for _ in range(2):   # captured, then replayed
        _reset_launches()
        got = scan_odometry.pairwise_odometry(r, angles, cfg)
        assert torch.equal(got, torch.cat(want))
        assert _launches_by_shape() == eager
    assert eager[0] == {(50, 448, 448): 2, (19, 448, 448): 1}
    matcher = scan_odometry.pair_matcher(r.device, 50, 10.0, 0.05, 448, 7,
                                         0.03, 0.03)
    assert {50, 19} <= set(matcher.bufs) and len(matcher.graphs) == len(
        matcher.bufs)


@pytest.fixture(scope="module")
def nccl_world():
    """An NCCL world of one (one card: NCCL takes one rank a GPU) and its
    (particles x map) mesh, made and destroyed here."""
    import gc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lidar_slam_tpu_torch.parallel import multihost

    assert multihost.initialize(device_type="cuda") == (0, 1)
    try:
        yield multihost.global_particle_mesh(device_type="cuda")
    finally:
        gc.collect()   # no captured collective outlives its communicator
        multihost.shutdown()


@pytest.mark.parametrize("edt", ["default", "4 blocks", "replicated"])
def test_captured_sharded_pf_equals_eager_on_the_card(nccl_world, edt):
    """PF-256, 60 museum scans, on the NCCL world of one: the captured
    sharded step (its collectives in the main graph; with
    ``edt_replicated`` over the map axis, ``ReplicatedField``, the refresh
    arm computes the row block and the main graph gathers the field every
    scan; scans 2.. under the sync debug mode "error") equals the eager
    sharded step and ``run_pf`` bit for bit, with the same K1/K2 launches
    by shape and the same collectives booked on the particles axis; the
    map axis books one all-gather of the field a scan captured and one a
    keyframe eager."""
    import dataclasses

    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.parallel import sharded, sharded_edt

    mesh = nccl_world
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=256))
    ranges, _ = _museum(60)
    edt_fn = {"default": None,
              "4 blocks": lambda o, r: sharded_edt.edt_blocks(o, 4, r),
              "replicated": sharded_edt.ReplicatedField(mesh.map)}[edt]
    ref, rstate = fastslam.run_pf(ranges, cfg, seed=0, device="cuda")
    out = {}
    for eager in (False, True):
        _reset_launches()
        mesh.particles.reset_counts()
        mesh.map.reset_counts()
        path, state = sharded.run_sharded_pf(ranges, cfg, mesh, seed=0,
                                             edt_fn=edt_fn, eager=eager)
        out[eager] = (path, state, _launches_by_shape(),
                      dict(mesh.particles.launches_by_shape),
                      dict(mesh.map.launches_by_shape))
    (cp, cs, *cc), (ep, es, *ec) = out[False], out[True]
    assert cc[:2] == ec[:2] and cc[0][0] and cc[0][1]
    if edt == "replicated":
        field = ("all_gather", tuple(rstate.fine_metric.shape), 4)
        keyframes = ec[2][field]
        assert cc[2] == {field: len(ranges) - 1}
        assert ec[2] == {field: keyframes} and keyframes < len(ranges) - 1
    else:
        assert cc[2] == ec[2] == {}
    assert torch.equal(cp, ref) and torch.equal(ep, ref)
    for f in ("poses", "prev_poses", "logw", "fine_metric"):
        assert torch.equal(getattr(cs, f), getattr(rstate, f)), f
        assert torch.equal(getattr(es, f), getattr(rstate, f)), f


def test_captured_sharded_ekf_equals_eager_on_the_card(nccl_world):
    """EKF-256 (``long_tour_config``), 60 museum scans, on the NCCL world
    of one: the captured sharded run (one graph, the collectives in the
    main graph, the association loop a WHILE node) equals the eager
    sharded run and the unsharded ``run_ml``, path and every bank, with
    the same collectives booked, and reads the host once."""
    import warnings

    from lidar_slam_tpu_torch.models import ekf_slam
    from lidar_slam_tpu_torch.parallel import sharded_ekf

    mesh = nccl_world
    cfg = ekf_slam.long_tour_config(256)
    ranges, _ = _museum(60)
    obs, valid, odo, counts = ekf_slam.scan_inputs(
        ranges, cfg, max_range=ekf_slam.LONG_TOUR_MAX_RANGE, device="cuda")
    ref, rstate = ekf_slam.run_ml(obs, valid, odo, cfg, 0, "cuda")
    out = {}
    for eager in (False, True):
        mesh.particles.reset_counts()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                path, state = sharded_ekf.run_sharded_ml(
                    obs, valid, odo, cfg, mesh, 0,
                    counts=counts if eager else None, eager=eager)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        out[eager] = (path, state, dict(mesh.particles.launches_by_shape),
                      syncs)
    assert out[False][2] == out[True][2]
    assert out[False][3] == 1
    for path, state, *_ in out.values():
        assert torch.equal(path, ref)
        for f in ekf_slam.PARTICLE_LEAVES:
            assert torch.equal(getattr(state, f), getattr(rstate, f)), f


@pytest.mark.parametrize("problem,iters,cg_iters", [("museum", 3, 20),
                                                    ("tiny", 5, None)])
def test_captured_sharded_ba_equals_eager_on_the_card(nccl_world, problem,
                                                      iters, cg_iters):
    """The K = 512 museum problem, 3 iterations of 20 PCG steps, and the
    dry run's 6-pose problem, 5 iterations of the default PCG steps (where
    the eager solve once left the captured one: its preconditioner blocks
    were column-major, the captured buffers row-major), on the NCCL world
    of one: the
    captured solve (three graphs) equals the eager ``_solve`` bit for bit
    with the same collectives booked; a second solve replays the graphs
    under the sync debug mode "error"."""
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import ba, state_io
    from lidar_slam_tpu_torch.parallel import dryrun, sharded_ba

    axis = sharded_ba.make_graph_mesh("cuda")
    if problem == "tiny":
        p = dryrun.tiny_ba_problem("cuda")
    else:
        p = state_io.ba_problem_from_numpy(
            ba.BAProblem(**simulate.generate_ba_problem()), "cuda")
    outs, calls = [], []
    for eager in (False, True):
        axis.reset_counts()
        outs.append(sharded_ba.optimize_ba_sharded(
            p, axis, iters=iters, cg_iters=cg_iters, eager=eager))
        calls.append(dict(axis.launches_by_shape))
    assert calls[0] == calls[1]
    assert torch.equal(outs[0].poses, outs[1].poses)
    assert torch.equal(outs[0].landmarks, outs[1].landmarks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sharded_ba.optimize_ba_sharded(p, axis, iters=iters,
                                               cg_iters=cg_iters)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again.poses, outs[0].poses)
    assert len(axis.ba_solve.graphs) == 3


# -- the span log on the card ---------------------------------------------------
def _profiled_on_the_card(fn):
    """``fn()`` under ``torch.profiler`` (host and CUDA activities) with an
    empty span log: (the spans recorded, the counters, kineto's events as
    (name, on the device, start_ns, end_ns))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.utils.profiling import SPANS

    SPANS.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(ev.name(), ev.device_type() == DeviceType.CUDA, ev.start_ns(),
               ev.end_ns()) for ev in prof.profiler.kineto_results.events()]
    spans, counters = list(SPANS.spans), dict(SPANS.counters)
    SPANS.clear()
    return spans, counters, events


def test_fresh_run_scan_captures_once_and_replays_a_scan(cuda):
    """A fresh ``run_scan`` captures its step once (key ``step``) and
    replays it once a scan after scan 1, in one session whose allocator
    segments are counted."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import scan_matcher

    n = 40
    ranges, _ = simulate.generate_dataset(n, seed=3)
    spans, counters, _ = _profiled_on_the_card(
        lambda: scan_matcher.run_scan(ranges, DEFAULT_CONFIG, device=cuda))
    assert [s.tag for s in spans if s.name == "session"] == ["run_scan"]
    assert [s.tag for s in spans if s.name == "graphs.capture"] == ["step"]
    replays = [s.tag for s in spans if s.name == "graphs.replay"]
    assert replays == ["step"] * (n - 2)
    assert counters["alloc.segments"] >= 0


# the host spans of a graph run: its bookkeeping, and the stages' closing
# synchronizes (``sync`` tagged ``stage``)
GRAPH_HOST_SPANS = ("graph.keyframes", "graph.candidates",
                    "graph.closure_gate", "graph.graph_arrays",
                    "graph.rebuild_map", "graphs.record")
GRAPH_STAGES = ("frontend_chunk", "kf_fetch", "kf_raster_edt",
                "closure_match", "optimize", "feedback")


def test_profiled_graph_run_keeps_spans_off_the_device(cuda):
    """A profiled ``GraphSlam.run`` (closures, an optimize and a feedback)
    makes no device-type kineto event named after a span, and each
    ``host=True`` span lies inside the kineto event of its name, within
    100 µs of its ends."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import graph_slam

    ranges, _ = simulate.generate_dataset(160, seed=1,
                                          waypoints=simulate.LOOP_WAYPOINTS)
    gs = graph_slam.GraphSlam(DEFAULT_CONFIG,
                              graph_slam.LoopClosureConfig(min_gap=3),
                              device=cuda)
    spans, _, events = _profiled_on_the_card(
        lambda: gs.run(ranges, chunk_size=32))
    assert gs.closures and gs._epoch >= 1
    names = {s.name for s in spans}
    assert {"session", "graphs.capture", "graphs.replay", "sync", "stage",
            *GRAPH_HOST_SPANS} <= names
    assert {s.tag for s in spans if s.name == "stage"} == set(GRAPH_STAGES)
    assert not [e for e in events if e[1] and e[0] in names]
    host = [s for s in spans if s.name in GRAPH_HOST_SPANS
            or (s.name == "sync" and s.tag == "stage")]
    assert len(host) > 20
    ends = []
    for s in host:
        around = [e for e in events if e[0] == s.name and not e[1]
                  and e[2] <= s.start_ns and s.end_ns <= e[3]]
        assert around, (s.name, s.tag)
        e = min(around, key=lambda e: e[3] - e[2])
        ends.append((max(s.start_ns - e[2], e[3] - s.end_ns),
                     s.start_ns - e[2], e[3] - s.end_ns, s.name, s.tag))
    ends.sort()
    worst = [(round(a / 1e3, 1), round(b / 1e3, 1), round(c / 1e3, 1), n, t)
             for a, b, c, n, t in ends[-3:]]
    print(f"{len(ends)} host spans inside their kineto events; the widest "
          f"(us apart, at the start, at the end): {worst}")
    assert ends[-1][0] <= 100_000


def test_spans_add_no_host_sync(cuda):
    """With the profiler on, the captured step's spans, a host span and a
    session raise nothing under the sync debug mode "error"."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import scan_matcher
    from lidar_slam_tpu_torch.utils import graphs
    from lidar_slam_tpu_torch.utils.profiling import session, span

    n = 20
    ranges = torch.as_tensor(simulate.generate_dataset(n, seed=3)[0],
                             device=cuda)

    def work():
        step = scan_matcher.make_step_fn(DEFAULT_CONFIG, cuda)
        state = step.advance(scan_matcher.init_state(ranges[0],
                                                     DEFAULT_CONFIG),
                             ranges[1])
        with graphs.no_host_sync(cuda), session("probe", cuda):
            for t in range(2, n):
                state = step.advance(state, ranges[t])
                with span("probe.host", req=t, host=True):
                    pass
        step.finish(state)

    spans, counters, _ = _profiled_on_the_card(work)
    assert sum(s.name == "graphs.replay" for s in spans) == n - 2
    assert [s.req for s in spans if s.name == "probe.host"] == list(
        range(2, n))
    assert "alloc.segments" in counters


def test_span_costs_at_most_half_a_microsecond_off(cuda):
    """With no profiler running a span (its call, entry and exit, and the
    loop around it) costs at most 0.5 µs of the host's time: the best of
    twenty rounds of 10^5 calls, so that a round slowed by the host's other
    work does not decide."""
    import time

    from lidar_slam_tpu_torch.utils.profiling import span

    assert not torch.autograd.profiler._is_profiler_enabled
    n, rounds = 100_000, []
    for _ in range(20):
        t0 = time.perf_counter()
        for i in range(n):
            with span("graphs.replay", tag="step", req=i):
                pass
        rounds.append((time.perf_counter() - t0) / n)
    rounds.sort()
    print(f"span with no profiler: {rounds[0] * 1e6:.3f} us a call "
          f"(median round {rounds[10] * 1e6:.3f} us)")
    assert rounds[0] <= 0.5e-6


# -- K3, the matcher: one launch a fast_match call ----------------------------
def _k3_on(args, device):
    metric, grid, *rest = args
    return (metric.to(device), grid_to(grid, device),
            *(a.to(device) if isinstance(a, torch.Tensor) else a
              for a in rest))


def _match_equal(got, want):
    from lidar_slam_tpu_torch.ops.matching import MatchResult

    return all(torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu())
               for f in MatchResult._fields)


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_cases_equal_plain(cuda, name):
    """K3 == the plain version on the card and on the CPU, and == its twin,
    every field with ``torch.equal``: windows +-1 and +-2 with the penalty,
    exact ties (the first minimum wins), an all-invalid scan and a guess
    whose candidates all leave the grid."""
    from lidar_slam_tpu_torch.ops import cuda_scan_match, matching

    args = k3_case(name)
    dargs = _k3_on(args, cuda)
    before = cuda_scan_match.launches
    got = matching.fast_match(*dargs)
    torch.cuda.synchronize()
    assert cuda_scan_match.launches == before + 1
    assert _match_equal(got, matching.fast_match_plain(*dargs))
    assert _match_equal(got, matching.fast_match_plain(*args))
    assert _match_equal(got, scan_match_twin(*args))


def test_k3_equals_plain_over_museum_steps(cuda, monkeypatch):
    """200 eager museum steps on the card: each of the 398 matcher calls
    (coarse and fine fields, the guesses and first-stage poses the run
    makes) gives K3's result == the plain version's on the same inputs."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import scan_matcher
    from lidar_slam_tpu_torch.ops import matching

    real = matching.fast_match
    calls = {"n": 0, "sizes": set()}

    def both(*args, **kw):
        got = real(*args, **kw)
        assert _match_equal(got, matching.fast_match_plain(*args, **kw)), \
            calls["n"]
        calls["n"] += 1
        calls["sizes"].add(args[0].shape[-1])
        return got

    monkeypatch.setattr(matching, "fast_match", both)
    ranges, _ = simulate.generate_dataset(200, seed=1)
    cfg = DEFAULT_CONFIG
    angles = scan_matcher.angles_tensor(cfg, cuda)
    state = scan_matcher.init_state(torch.as_tensor(ranges[0], device=cuda),
                                    cfg)
    for t in range(1, 200):
        state, _ = scan_matcher.slam_step(
            state, torch.as_tensor(ranges[t], device=cuda), cfg, angles)
    assert calls["n"] == 2 * 199
    assert calls["sizes"] == {cfg.grid.coarse_size, cfg.grid.fine_size}


def test_k3_poisons_a_field_off_the_lattice(cuda):
    """A gathered value off the 2^-10 lattice, or a candidate whose codes
    sum to 2^24 or more, gives a NaN score, as the twin does; a field lifted
    past ``max_dist_px`` whose sums stay just under 2^24 gives the plain
    version's result."""
    from lidar_slam_tpu_torch.ops import matching

    args = k3_case("coarse-200")
    for bad in (args[0] + 2.0 ** -12, args[0] + 2.0 ** 14):
        bargs = (bad,) + args[1:]
        got = matching.fast_match(*_k3_on(bargs, cuda))
        twin = scan_match_twin(*bargs)
        assert torch.isnan(got.score.cpu()) and torch.isnan(twin.score)
        # torch.equal holds no NaN equal to a NaN: the score is checked above
        zero = torch.zeros(())
        assert _match_equal(got._replace(score=zero), twin._replace(score=zero))
    lifted = (args[0] + 6.375,) + args[1:]
    assert _match_equal(matching.fast_match(*_k3_on(lifted, cuda)),
                        matching.fast_match_plain(*lifted))


def test_fast_match_is_one_kernel_on_the_card(cuda):
    """A ``fast_match`` call on the card runs one kernel, K3's, and no
    PyTorch kernel, copy or memset."""
    from lidar_slam_tpu_torch.ops import matching

    args = k3_case("fine-400")
    dargs = _k3_on(args, cuda)
    matching.fast_match(*dargs)   # built and loaded
    _, _, events = _profiled_on_the_card(lambda: matching.fast_match(*dargs))
    device = [name for name, on_device, _, _ in events if on_device]
    assert len(device) == 1 and "scan_match_kernel" in device[0], device


def test_run_scan_books_two_k3_launches_a_scan(cuda):
    """A fidelity ``run_scan`` of T scans books 2 (T - 1) K3 launches: two
    a scan from scan 1 on (the eager scan 1, then the captured step's IF
    arms and second match, counted at ``finish``), at the coarse and the
    fine field's shapes; its path equals the CPU's."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import scan_matcher
    from lidar_slam_tpu_torch.ops import cuda_scan_match

    t = 50
    ranges, _ = simulate.generate_dataset(t, seed=3)
    cfg = DEFAULT_CONFIG
    before = cuda_scan_match.launches
    shapes = collections.Counter(cuda_scan_match.launches_by_shape)
    gpu, _ = scan_matcher.run_scan(ranges, cfg, device=cuda)
    assert cuda_scan_match.launches - before == 2 * (t - 1)
    added = cuda_scan_match.launches_by_shape - shapes
    n = cfg.lidar.n_beams
    assert set(added) == {(27, n, cfg.grid.coarse_size),
                          (27, n, cfg.grid.fine_size)}
    cpu, _ = scan_matcher.run_scan(ranges, cfg, device="cpu")
    assert torch.equal(gpu.cpu(), cpu)


def test_fresh_run_pf_records_its_session_draws_and_refreshes(cuda):
    """A fresh ``run_pf`` on the card is one ``session`` span tagged
    ``run_pf``: it captures its step once and replays it once a scan after
    scan 1, each replay after a ``pf.draw`` span, and counts its keyframe
    refreshes in ``pf.refreshes``, as many as the K1 launches it books (scan
    1's and the refresh arm's, read back at ``finish``); unprofiled, the
    same run gives the same path bit for bit."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.ops import cuda_edt

    n = 60
    ranges, _ = simulate.generate_dataset(n, seed=3)
    before = cuda_edt.launches
    out = {}
    spans, counters, _ = _profiled_on_the_card(lambda: out.setdefault(
        "gpu", fastslam.run_pf(ranges, DEFAULT_CONFIG, device=cuda)))
    assert [s.tag for s in spans if s.name == "session"] == ["run_pf"]
    assert [s.tag for s in spans if s.name == "graphs.capture"] == ["step"]
    assert len([s for s in spans if s.name == "graphs.replay"]) == n - 2
    assert len([s for s in spans if s.name == "pf.draw"]) == n - 2
    assert counters["pf.refreshes"] == cuda_edt.launches - before >= 3
    assert counters["alloc.segments"] >= 0
    again, _ = fastslam.run_pf(ranges, DEFAULT_CONFIG, device=cuda)
    assert torch.equal(out["gpu"][0], again)


def test_pf_cell_equals_its_reference_on_the_card(cuda):
    """The benchmark's PF-1024 cell, cut to 150 scans: the program's
    session on the card equals the plain reference run on the card from the
    same seed, on every number the cell compares (limit 0)."""
    from slambench import harness
    from slambench.tests._small import small_cell

    cell = small_cell("museum-pf1024.replay", scans=150)
    system = harness.system_module("pf")
    ranges, _ = harness.make_tour(cell.config, 2718281828)
    out = system.to_host(system.Program(cell.config, "cuda").replay(ranges))
    ref = system.reference(cell.config, ranges, "cuda", outputs=[out])
    checks = system.compare(cell.config, [out], ref)
    assert all(v <= lim for _, v, lim in checks), checks
    assert ref["refreshes"] >= 3 and ref["resamples"] >= 1
