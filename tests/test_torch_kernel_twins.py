"""The index math of kernels K1, K2, K3, K4 and K5, held to their plain
versions on the CPU.

A CUDA kernel cannot run here, so each kernel has a twin that repeats its
index math step by step (``_kernel_twins.edt_twin``,
``_kernel_twins.score_volume_twin``, ``_kernel_twins.scan_match_twin``,
``_kernel_twins.vol_lookup_twin``, ``vol_refine_twin`` and
``scan_intake_twin``):
bit-packed rows, bit-scan distances and row bands for K1; beam chunks,
live-beam compaction, bounding-box tiles and their halving, lattice codes
with the bounds test folded in, and window origins for K2; gather tables,
integer code sums, the penalty after the sum, the first minimum and the
prefix-count compaction for K3; the cascade's float32 operations in order,
a pose at a time, and the refinement's serial first minimum for K4; runs
of beams a thread, warp scans and each kept beam's slot and quadrant for K5.
The twins must equal the plain versions
exactly at the main paths' shapes and at the edges; ``test_torch_cuda.py``
holds the kernels themselves to the same cases on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _kernel_cases import (K1_CASES, K2_CASES, K3_CASES, K4_CASES,
                           K4_REFINE_CASES, K5_BEAMS, K5_EDGES, batch_prefix,
                           k1_case, k2_case, k3_case, k4_case, k4_refine_case,
                           k5_beams_case, k5_edge_case, k5_inputs, k5_log,
                           sparse_chunk_case, vols_prefix)
from _kernel_twins import (edt_twin, scan_intake_twin, scan_match_twin,
                           score_volume_twin, vol_lookup_twin,
                           vol_refine_twin)
from lidar_slam_tpu_torch.core import sensor
from lidar_slam_tpu_torch.ops import (correlative, cuda_edt, cuda_match,
                                      cuda_scan_intake, cuda_scan_match,
                                      cuda_vol_lookup, matching)
from lidar_slam_tpu_torch.ops.edt import edt_clamped

torch.set_num_threads(2)


@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_twin_equals_plain(name):
    occ, r = k1_case(name)
    stats = {}
    got = edt_twin(occ, r, stats=stats)
    assert torch.equal(got, edt_clamped(occ, r))
    b, h, w = occ.shape
    assert stats["band"] == cuda_edt.plan_band(b, h, w, r, 132)
    assert stats["blocks"] == b * -(-h // stats["band"])


@pytest.mark.parametrize("band", [1, 3, 21, 1000])
def test_k1_twin_any_band(band):
    occ, r = k1_case("ragged-37x70")
    assert torch.equal(edt_twin(occ, r, band=band),
                       edt_clamped(occ, r))


@pytest.mark.parametrize("name", ["keyframes-8x256", "refine-8x448"])
@pytest.mark.parametrize("b", [1, 3, 7])
def test_k1_twin_partial_batches(name, b):
    """The last, partial batches of the keyframe and refine passes plan
    their own bands."""
    occ, r = k1_case(name)
    stats = {}
    assert torch.equal(edt_twin(occ[:b], r, stats=stats),
                       edt_clamped(occ[:b], r))
    assert stats["band"] == cuda_edt.plan_band(b, *occ.shape[1:], r, 132)


def test_k1_band_plan():
    """At most one block an SM at the batched shapes, at least four rows a
    block, and a block's shared memory within Hopper's limit."""
    for (b, h, w), want in (((1, 200, 200), 4), ((1, 400, 400), 4),
                            ((1, 512, 512), 4), ((8, 256, 256), 16),
                            ((8, 448, 448), 28), ((1, 2, 30), 2),
                            ((200, 64, 64), 32)):
        band = cuda_edt.plan_band(b, h, w, 10, 132)
        assert band == want
        assert b * -(-h // band) <= 132 or band == 32
    assert cuda_edt.smem_bytes(448, 10, 13) == 4 * (596 + 33 * 224 + 102)
    assert cuda_edt.plan_band(1, 64, 5000, 10, 132) == 1
    with pytest.raises(ValueError, match="shared memory"):
        cuda_edt.plan_band(1, 64, 40000, 10, 132)


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_twin_equals_plain(name):
    args = k2_case(name)
    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = args
    stats = {}
    got = score_volume_twin(*args, stats=stats)
    want = correlative.score_volume_plain(*args[:7])
    assert torch.equal(got, want)
    if name not in ("empty-field", "occupied-field"):
        assert want.abs().sum() > 0
    chunk, _ = cuda_match.plan(metric.numel() // metric.shape[-1] ** 2,
                               cx0.shape[-2], cx0.shape[-1], half, 132)
    b = 1 if metric.dim() == 2 else metric.shape[0]
    assert stats["blocks"] == b * -(-cx0.shape[-1] // chunk)


@pytest.mark.parametrize("name", ["pf-400", "half-14", "off-grid",
                                  "half-20", "cascade-f4"])
def test_k2_twin_halves_pieces_that_overflow(name):
    """With a budget of one window, every chunk's tile overflows and is
    halved down to single beams and then single bins; with one beam a
    block, the halving runs along the bins alone."""
    args = k2_case(name)
    budget = cuda_match.window_cells(args[6])
    want = correlative.score_volume_plain(*args[:7])
    for chunk in (None, 1):
        stats = {}
        got = score_volume_twin(*args, chunk=chunk, tile_cells=budget,
                                stats=stats)
        assert torch.equal(got, want)
        assert stats["pieces"] > stats["blocks"]


def test_k2_twin_halves_a_sparse_box():
    """Beams of one chunk that hit walls far apart give a box with more
    cells than the chunk has gathers: it is halved along the beams even
    though it fits the tile."""
    args = sparse_chunk_case()
    stats, dense = {}, {}
    got = score_volume_twin(*args, chunk=8, stats=stats)
    assert torch.equal(got, correlative.score_volume_plain(*args[:7]))
    score_volume_twin(*k2_case("pf-400"), chunk=8, stats=dense)
    assert stats["blocks"] == dense["blocks"]
    assert stats["pieces"] > dense["pieces"]
    assert 83 * cuda_match.tile_pitch(88) <= cuda_match.plan(1, 7, 1079, 6,
                                                               132)[1]


def test_k2_twin_poisons_a_field_off_the_lattice():
    """A value that is no exact code (off the 2^-q lattice, or beyond
    uint16) turns the volumes it reaches into NaN rather than rounding."""
    metric, cx0, cy0, valid, n_rows, n_cols, half, bits = k2_case("pf-400")
    assert not torch.isnan(score_volume_twin(
        metric, cx0, cy0, valid, n_rows, n_cols, half, bits)).any()
    got = score_volume_twin(metric + 2.0 ** -12, cx0, cy0, valid, n_rows,
                            n_cols, half, bits)
    assert torch.isnan(got).all()
    for bad in (metric * 8.0, metric - 2.0 ** -10):
        got = score_volume_twin(bad, cx0, cy0, valid, n_rows, n_cols, half,
                                bits)
        assert torch.isnan(got).any()
    # a cascade level's field is on 2^-11: read at 2^-10 it is off-lattice
    args = k2_case("cascade-f2")
    assert args[7] == 11
    assert torch.isnan(score_volume_twin(*args[:7], 10)).any()
    assert not torch.isnan(score_volume_twin(*args)).any()


@pytest.mark.parametrize("b", range(1, 8))
def test_k2_twin_partial_batches(b):
    """The closure passes' last, partial batches (B < 8) plan their own
    chunks (8 beams a block at B = 1, 17 at B = 4, 30 at B = 7)."""
    args = batch_prefix(k2_case("closure-8x256"), b)
    stats = {}
    got = score_volume_twin(*args, stats=stats)
    assert torch.equal(got, correlative.score_volume_plain(*args[:7]))
    chunk, _ = cuda_match.plan(b, 21, 1079, 14, 132)
    assert stats["blocks"] == b * -(-1079 // chunk)


def test_k2_plan():
    """About two blocks an SM, a tile budget of at least one window, and a
    window too large for shared memory refused."""
    assert cuda_match.plan(1, 7, 1079, 6, 132) == (8, 16 * 1024)
    assert cuda_match.plan(8, 21, 1079, 14, 132) == (33, 16 * 1024)
    assert cuda_match.plan(1, 13, 1079, 6, 132)[0] == 8
    for b in range(1, 9):   # the closure passes' partial batches: one wave
        chunk, _ = cuda_match.plan(b, 21, 1079, 14, 132)
        assert b * -(-1079 // chunk) <= 2 * 132
    chunk, tile = cuda_match.plan(1, 7, 1079, 120, 132)
    assert tile >= cuda_match.window_cells(120) >= 241 * 241
    with pytest.raises(ValueError, match="shared memory"):
        cuda_match.plan(1, 7, 1079, 200, 132)
    assert [cuda_match.tile_pitch(w) % 64 for w in (1, 13, 29, 33, 97)] == \
        [32] * 5


def test_cascade_passes_each_levels_lattice(monkeypatch):
    """build_cascade tells K2 the lattice of each level: 2^-10 for the EDT,
    2^-(10+l) for the level min-pooled and divided by 2^l."""
    seen = []
    real = correlative.score_volume

    def spy(*args):
        seen.append(args[7])
        return real(*args)

    monkeypatch.setattr(correlative, "score_volume", spy)
    s = 128
    rng = np.random.default_rng(0)
    metric = edt_clamped(torch.as_tensor(rng.random((s, s)) < 0.02))
    from lidar_slam_tpu_torch.core.gridmap import OccGrid

    grid = OccGrid(occ=torch.zeros((s, s), dtype=torch.bool),
                   n_rows=torch.tensor(s, dtype=torch.int32),
                   n_cols=torch.tensor(s, dtype=torch.int32),
                   origin=torch.zeros(2), pixel=0.1)
    xy = torch.as_tensor(rng.uniform(-4, 4, (2, 200)), dtype=torch.float32)
    vols = correlative.build_cascade(
        metric, grid, xy[0], xy[1], torch.ones(200, dtype=torch.bool),
        torch.tensor([6.4, 6.4, 0.0]), 7, 0.004363, 6, 3)
    assert seen == [10, 11, 12]
    for lvl, vol in enumerate(vols):
        f = 2 ** lvl
        codes = vol.scores * 2.0 ** (10 + lvl)
        assert torch.equal(codes, codes.round())
        assert f == 1 or vol.scores.abs().sum() > 0


def _assert_match_equal(got, want):
    for f in matching.MatchResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_twin_equals_plain(name):
    """K3's algorithm (integer code sums, first minimum after the penalty,
    compaction by prefix count) == ``fast_match_plain``, field by field, on
    lattice fields at windows +-1 and +-2, with ties, an all-invalid scan
    and a guess whose candidates all leave the grid."""
    args = k3_case(name)
    got = scan_match_twin(*args)
    want = matching.fast_match_plain(*args)
    _assert_match_equal(got, want)
    if name.startswith("tie-flat"):
        # every candidate keeps its beams on the grid: the first of the
        # candidates without a penalty wins
        wt = args[8]
        first = matching.candidate_grid_ref(args[5], *args[6:10])[
            0 if wt == 1 else (wt - 1) * (2 * wt + 1) ** 2
            + (wt - 1) * (2 * wt + 1) + wt - 1]
        assert torch.equal(want.pose, first)
        assert int(want.best_count) == int(args[4].sum())
    if name in ("all-invalid", "off-grid"):
        assert int(want.best_count) == 0 and float(want.score) == 0.0
        assert not want.last_hits.any() and not want.last_inb.any()


def test_k3_twin_poisons_a_field_off_the_lattice():
    """A gathered value off the 2^-10 lattice, or a candidate whose codes
    sum to 2^24 or more, turns that candidate's score into NaN, which wins
    the argmin as ``torch.argmin`` takes a NaN."""
    args = k3_case("coarse-200")
    assert not torch.isnan(scan_match_twin(*args).score)
    for bad in (args[0] + 2.0 ** -12, args[0] + 2.0 ** 14):
        got = scan_match_twin(bad, *args[1:])
        assert torch.isnan(got.score)


@pytest.mark.parametrize("lift", [5.0, 6.375])
def test_k3_twin_sums_exact_below_two_to_the_24(lift):
    """The exactness bound is the sum's, not the field's clamp: a field
    lifted past ``max_dist_px`` (values up to 15, or up to 16.375, where the
    codes of the case's 1000 valid beams sum to at most 16,768,000, just
    under 2^24) still gives ``fast_match_plain``'s result, since every
    partial sum of non-negative codes below 2^24 is exact in float32."""
    args = k3_case("coarse-200")
    lifted = args[0] + lift
    got = scan_match_twin(lifted, *args[1:])
    want = matching.fast_match_plain(lifted, *args[1:])
    assert not torch.isnan(got.score)
    assert float(lifted.max()) > 10.0
    _assert_match_equal(got, want)


def test_fast_match_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    """CPU tensors take the plain version: neither the wrapper nor the
    kernel library is touched, and no launch is counted, in ``fast_match``
    and in the captured fidelity step's CPU run."""
    from lidar_slam_tpu_torch import _build
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import scan_matcher

    def refuse(*_a, **_k):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(cuda_scan_match, "fast_match_cuda", refuse)
    monkeypatch.setattr(_build, "load_kernels", refuse)
    before = (cuda_scan_match.launches,
              dict(cuda_scan_match.launches_by_shape))
    args = k3_case("wide-256")
    _assert_match_equal(matching.fast_match(*args),
                        matching.fast_match_plain(*args))
    ranges, _ = simulate.generate_dataset(6, seed=1)
    path, _ = scan_matcher.run_scan(ranges, DEFAULT_CONFIG, device="cpu")
    assert path.shape == (6, 3)
    assert (cuda_scan_match.launches,
            dict(cuda_scan_match.launches_by_shape)) == before


def test_k3_smem_fits_the_main_paths():
    """The kernel's shared memory at the main paths' windows: +-1 and +-2
    at 1079 beams fit a block of the cluster (one heading each), and so do
    +-4 (two headings a block past the cluster's 8); a window whose one
    heading's tables cannot fit is refused, as are CPU tensors."""
    for w in (1, 2, 4):
        assert cuda_scan_match.smem_bytes(w, w, 1079) <= cuda_match.SMEM_BYTES
    assert cuda_scan_match.smem_bytes(20, 3, 1079) > cuda_match.SMEM_BYTES
    args = k3_case("coarse-200")
    with pytest.raises(ValueError, match="shared memory"):
        cuda_scan_match.fast_match_cuda(*args[:8], 20, 3, 4.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_scan_match.fast_match_cuda(*args)


# -- K4, the volume lookups ----------------------------------------------------
def same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """``torch.equal``, with a NaN equal to a NaN in the same place."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(nan=-1.0),
                            want.nan_to_num(nan=-1.0)))


def k4_plain(name, vols, poses):
    """The plain version a K4 case's mode calls: (dist, escape or None)."""
    if K4_CASES[name][-1] == "cascade":
        return correlative.lookup_cascade_plain(vols, poses)
    return correlative.lookup_avg_distance_plain(vols[0], poses), None


@pytest.mark.parametrize("name", list(K4_CASES))
def test_k4_twin_equals_plain(name):
    """K4's order of operations (a pose's levels in turn, stopping at the
    first window that holds it; clamps that keep a NaN; weights, sums and
    the division in the plain version's order) == the plain lookups, with
    ``torch.equal``: the PF's 1024 particles at 7 and 13 bins, cascades of
    2 and 3 levels, the closures' batched volumes and their counts-as-scores
    lookup, poses far beyond every window, a zero volume and NaN poses."""
    vols, poses = k4_case(name)
    want, want_escape = k4_plain(name, vols, poses)
    got, escape = vol_lookup_twin(vols, poses)
    assert same(got, want)
    assert torch.isnan(want).any() == (name == "nan")
    if want_escape is not None:
        assert torch.equal(escape, want_escape)
        assert want_escape.any() and (name.startswith("far")
                                      or not want_escape.all())


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("name", ["closure-8x27", "closure-counts-8x1"])
def test_k4_twin_partial_batches(name, b):
    """The backend's batches of B = 1..8 volume rows, each pose looking up
    its own row."""
    vols, poses = k4_case(name)
    vols, poses = vols_prefix(vols, b), poses[:b]
    want, _ = k4_plain(name, vols, poses)
    assert same(vol_lookup_twin(vols, poses)[0], want)


@pytest.mark.parametrize("name", K4_REFINE_CASES)
def test_k4_refine_twin_equals_plain(name):
    """K4's refinement (27 candidates a pass, thread 0's serial first
    minimum, the first NaN where there is one) == ``refine_estimate_plain``
    over three passes: edge ties far outside the windows and a zero volume
    (every candidate ties: the first wins), NaN distances."""
    vols, est, offs = k4_refine_case(name)
    want = correlative.refine_estimate_plain(vols, est, offs)
    assert same(vol_refine_twin(vols, est, offs), want)
    if name == "zero":
        assert torch.equal(want, ((est + offs[0]) + offs[0]) + offs[0])


def _former_loop(vols, est_pose, offs):
    """The estimate's refinement as ``pf_head`` and ``hybrid_head`` wrote it
    inline before ``refine_estimate``."""
    for _ in range(3):
        cands = est_pose[None, :] + offs
        d, _ = correlative.lookup_cascade(vols, cands)
        est_pose = cands[torch.argmin(d).view(1)][0]   # no host sync
    return est_pose


@pytest.mark.parametrize("caller", ["pf_head", "hybrid_head"])
def test_refine_estimate_equals_the_former_loop(caller, monkeypatch):
    """Every ``refine_estimate`` call that a CPU run of each caller makes
    (the PF's and the hybrid filter's) gives what the former inline loop
    gives on the same volumes, estimate and offsets."""
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import ekf_hybrid, ekf_slam, fastslam

    calls = []
    real = correlative.refine_estimate

    def record(vols, est_pose, offs):
        out = real(vols, est_pose, offs)
        calls.append((vols, est_pose.clone(), offs, out.clone()))
        return out

    monkeypatch.setattr(correlative, "refine_estimate", record)
    ranges, _ = simulate.generate_dataset(8, seed=2)
    if caller == "pf_head":
        cfg = dataclasses.replace(DEFAULT_CONFIG, particles=dataclasses.replace(
            DEFAULT_CONFIG.particles, n_particles=32))
        fastslam.run_pf(ranges, cfg, device="cpu")
    else:
        ekf_cfg = ekf_slam.long_tour_config(16)
        ekf_hybrid.run_ekf_hybrid(ranges, ekf_cfg, DEFAULT_CONFIG,
                                  device="cpu")
    assert len(calls) == 7
    for vols, est, offs, out in calls:
        assert torch.equal(out, _former_loop(vols, est, offs))


def test_lookups_on_the_cpu_never_reach_the_kernel(monkeypatch):
    """CPU tensors take the plain versions: neither K4's wrapper nor the
    kernel library is touched and no launch is counted, in the three
    lookups and in a CPU ``run_pf``, whose ``k4.launches`` counter reads
    0 under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch import _build
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import fastslam
    from lidar_slam_tpu_torch.utils.profiling import SPANS

    def refuse(*_a, **_k):
        raise AssertionError("the CPU path reached the kernel")

    for fn in ("lookup_cascade_cuda", "lookup_avg_distance_cuda",
               "refine_estimate_cuda", "launch", "launch_refine"):
        monkeypatch.setattr(cuda_vol_lookup, fn, refuse)
    monkeypatch.setattr(_build, "load_kernels", refuse)
    before = (cuda_vol_lookup.launches,
              dict(cuda_vol_lookup.launches_by_shape))
    vols, est, offs = k4_refine_case("levels-3")
    _, poses = k4_case("levels-3")
    assert same(correlative.lookup_cascade(vols, poses)[0],
                correlative.lookup_cascade_plain(vols, poses)[0])
    assert same(correlative.lookup_avg_distance(vols[0], poses),
                correlative.lookup_avg_distance_plain(vols[0], poses))
    assert same(correlative.refine_estimate(vols, est, offs),
                correlative.refine_estimate_plain(vols, est, offs))
    ranges, _ = simulate.generate_dataset(6, seed=1)
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        path, _ = fastslam.run_pf(ranges, DEFAULT_CONFIG, device="cpu")
    counters = dict(SPANS.counters)
    SPANS.clear()
    assert path.shape == (6, 3) and counters["k4.launches"] == 0
    assert (cuda_vol_lookup.launches,
            dict(cuda_vol_lookup.launches_by_shape)) == before


def test_k4_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks: 1 to 3 levels of one shape, float32, W =
    2 half + 1, every tensor on the poses' device; CPU poses go to the
    plain versions, never to the kernel."""
    cpu = torch.device("cpu")
    vols, poses = k4_case("levels-3")
    assert cuda_vol_lookup._cascade(vols, cpu) == (0, 7, 13, 6)
    assert cuda_vol_lookup._cascade(k4_case("closure-8x27")[0], cpu) == (
        8, 21, 29, 14)
    bad = {
        "1 to 3": vols + vols[:1],
        "float32": [vols[0]._replace(counts=vols[0].counts.double())],
        "2 \\* half": [vols[0]._replace(half=5)],
        "level 1": [vols[0], vols[1]._replace(scores=vols[1].scores[:6])],
        "base_pose": [vols[0]._replace(base_pose=torch.zeros(2, 3))],
        "is on meta": [vols[0]._replace(scores=vols[0].scores.to("meta"))],
    }
    for match, v in bad.items():
        with pytest.raises(ValueError, match=match):
            cuda_vol_lookup._cascade(v, cpu)
    for call in (lambda: cuda_vol_lookup.lookup_cascade_cuda(vols, poses),
                 lambda: cuda_vol_lookup.refine_estimate_cuda(
                     vols, poses[0], poses[:27])):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


# -- K5, the scan intake -------------------------------------------------------
def _scan_equal(got, want) -> bool:
    return all(torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu())
               for f in sensor.Scan._fields)


def test_k5_twin_equals_plain_over_a_museum_log():
    """K5's algorithm (runs of beams a thread, warp scans of the kept
    counts, the slots, sincos32 of each kept beam) == ``read_scan_plain`` on
    every scan of a 1000-scan museum log with dropouts (0, NaN, +inf,
    negative, past ``usable_range``, exactly at either bound)."""
    log = k5_log()
    kept = set()
    for row in log:
        args = k5_inputs(row)
        want = sensor.read_scan_plain(*args)
        assert _scan_equal(scan_intake_twin(*args), want)
        kept.add(int(want.size))
    assert len(kept) > 10 and max(kept) < 1079


@pytest.mark.parametrize("name", K5_EDGES)
def test_k5_twin_equals_plain_at_the_gates_edges(name):
    """The gate in float32 at its edges: a range exactly at ``range_min``
    or ``usable_range`` is kept and its float32 neighbours outside them are
    not; 0, negative ranges, NaN and +-inf are dropped; a scan that keeps
    no beam has size 0 and all zeros, one that keeps every beam size N."""
    args = k5_edge_case(name)
    want = sensor.read_scan_plain(*args)
    assert _scan_equal(scan_intake_twin(*args), want)
    n, size = args[0].shape[0], int(want.size)
    expect = {"all-dropped": 0, "all-valid": n,
              "range_min": n - len(range(0, n, 9)),
              "usable_range": n - len(range(6, n, 9))}
    if name in expect:
        assert size == expect[name], name
    elif name in ("zero", "negative", "nan", "inf"):
        assert size == n - len(range(0, n, 3)), name
    if name == "all-dropped":
        assert not want.x.any() and not want.y.any()


@pytest.mark.parametrize("n", K5_BEAMS)
def test_k5_twin_equals_plain_at_every_beam_count(n):
    """N = 1, a warp's 31, the block's 1024, the museum's 1079 and the
    most the block takes, 8192 (8 beams a thread, an angle table that turns
    through several quadrants either way)."""
    args = k5_beams_case(n)
    want = sensor.read_scan_plain(*args)
    assert _scan_equal(scan_intake_twin(*args), want)


def test_read_scan_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    """CPU tensors take the plain version: neither K5's wrapper nor the
    kernel library is touched and no launch is counted, in ``read_scan``
    and in a CPU ``run_scan`` and ``run_pf``."""
    from lidar_slam_tpu_torch import _build
    from lidar_slam_tpu_torch.config import DEFAULT_CONFIG
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import fastslam, scan_matcher

    def refuse(*_a, **_k):
        raise AssertionError("the CPU path reached the kernel")

    for fn in ("read_scan_cuda", "launch"):
        monkeypatch.setattr(cuda_scan_intake, fn, refuse)
    monkeypatch.setattr(_build, "load_kernels", refuse)
    before = (cuda_scan_intake.launches,
              dict(cuda_scan_intake.launches_by_shape))
    args = k5_edge_case("nan")
    assert _scan_equal(sensor.read_scan(*args), sensor.read_scan_plain(*args))
    ranges, _ = simulate.generate_dataset(6, seed=1)
    for run in (scan_matcher.run_scan, fastslam.run_pf):
        path, _ = run(ranges, DEFAULT_CONFIG, device="cpu")
        assert path.shape == (6, 3)
    assert (cuda_scan_intake.launches,
            dict(cuda_scan_intake.launches_by_shape)) == before


def test_k5_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks: a 1-D scan of 1 to ``MAX_BEAMS`` beams (one
    block of 1024 threads, 8 beams a thread), float32, contiguous, on one
    card; CPU tensors go to the plain version, never to the kernel."""
    assert cuda_scan_intake.MAX_BEAMS == 8192 == K5_BEAMS[-1]
    ranges, angles, cfg = k5_beams_case(31)
    for bad in (torch.zeros(0), torch.zeros(8193), torch.zeros(2, 31)):
        with pytest.raises(ValueError, match="1 <= N"):
            cuda_scan_intake.read_scan_cuda(bad, angles, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_scan_intake.read_scan_cuda(ranges, angles, cfg)
    assert cuda_scan_intake.gate_bounds(cfg) == (
        float(np.float32(cfg.range_min)), float(np.float32(cfg.usable_range)))
