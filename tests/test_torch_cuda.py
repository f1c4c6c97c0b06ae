"""Kernel tests that need an NVIDIA GPU (Hopper, sm_90a) and nvcc.

They carry the ``cuda`` marker and skip wherever ``torch.cuda`` has no
device. The repository's ``conftest.py`` imports JAX, which the GPU machine
does not have, so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

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
