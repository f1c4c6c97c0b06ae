"""Configuration of the port: frozen dataclasses and presets.

A copy of ``lidar_slam_tpu.config``, field for field and value for value,
so the port imports nothing of the JAX package; ``tests/test_torch_config.py``
holds the two equal. The reference hardcodes every parameter as constants
in ``main()`` (reference ``Subsystem_1/main.c:832-842``); here they are
frozen dataclasses, serializable to and from JSON, with the reference's
values as defaults so the fidelity pipeline reproduces the C trajectory.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class LidarConfig:
    """Sensor model (reference ``main.c:45-58``: Hokuyo-like, 1079 beams)."""

    n_beams: int = 1079
    angle_min: float = -2.351831
    angle_increment: float = 0.004363
    range_min: float = 0.023
    range_max: float = 60.0
    usable_range: float = 24.0  # gating range passed to readAScan (main.c:846)


@dataclass(frozen=True)
class GridConfig:
    """Dual-resolution occupancy/likelihood grids (reference ``main.c:200-213``)."""

    coarse_size: int = 200          # max cells per side, 0.2 m grid
    fine_size: int = 400            # max cells per side, 0.1 m grid
    coarse_pixel: float = 0.2
    fine_pixel: float = 0.1
    border_size: float = 1.0        # local-map AABB border (main.c:834)
    margin_pixels: int = 3          # grid bound margin (main.c:298-302)
    max_dist_px: float = 10.0       # EDT clamp (main.c:224)


@dataclass(frozen=True)
class MatcherConfig:
    """Correlative matcher search resolutions (reference ``main.c:832-833``)."""

    coarse_t: float = 0.05          # m
    coarse_r: float = 0.008727      # rad (0.5 deg)
    fine_t: float = 0.025
    fine_r: float = 0.004363
    # Correlative search window half-widths, in steps per axis. The default
    # +-1 reproduces the reference's fixed 3x3x3 neighborhood bit-exactly
    # (main.c:424-426); wider values turn both matcher stages into a full
    # correlative search over (2*window_r+1) x (2*window_t+1)^2 candidates
    # scored in the same single batched gather (ops/matching.py).
    window_t: int = 1               # +-window_t steps in x/y  (1 => 3 values)
    window_r: int = 1               # +-window_r steps in theta
    # center-bias penalty (summed-EDT px) per L1 step of candidate offset
    # beyond the inner 3x3x3 — suppresses corridor-aliased far matches and
    # near-tie nondeterminism; no effect at window 1 (ops/matching.fast_match).
    # Swept on building-3800 with the JAX package: 4.0 gives ATE 0.092 m
    # with its backends agreeing exactly; 0.25 leaves one-ulp backend
    # divergence; 0 allows meter-scale corridor excursions.
    window_penalty_px: float = 4.0


@dataclass(frozen=True)
class MapConfig:
    """Point-map capacities (reference ``main.c:123-151``)."""

    map_capacity: int = 20000
    new_point_threshold: float = 1.5   # bestHits > 1.5 novel-surface test (main.c:943)
    mini_update_dt: float = 0.3        # m   (main.c:838)
    mini_update_dr: float = 0.0872665  # rad (5 deg, main.c:839)


@dataclass(frozen=True)
class ParticleConfig:
    """Particle-filter layer (north-star extension; absent in the reference)."""

    n_particles: int = 1024
    sigma_xy: float = 0.01          # proposal noise std (m)
    sigma_theta: float = 0.002      # proposal noise std (rad)
    score_temperature: float = 0.05  # weight = exp(-avg_px_dist/temperature)
    resample_threshold: float = 0.5  # resample when ESS/N below this
    # correlation-volume scoring (ops/correlative.py). Tuned on the museum
    # dataset with the JAX package: (7 bins, +-6 px) beats (9, +-8) on ATE —
    # the tighter window regularizes the weighting — and the volume's cost
    # scales with T * W^2.
    vol_theta_bins: int = 7         # theta bins at fine_r step
    vol_half: int = 6               # +-pixels covered; window = 2*half+1
    # multi-resolution cascade (ops/correlative.build_cascade): level l adds a
    # volume at 2^l x pixel/theta scale, so particles escaping the fine
    # +-0.6 m window are scored (not edge-clamped) out to +-0.6*2^(l) m.
    # The escape fraction is exposed as ParticleState.clamp_frac.
    # Default 1 (fine volume only): on the museum workload the extra level
    # doubled ATE in the JAX package (0.043 -> 0.090 m — the coarse level's
    # min-pooled field flattens the weighting), so the cascade is opt-in
    # for escape/kidnap regimes (the kidnap-recovery test uses 3).
    cascade_levels: int = 1
    # gradient-guided proposal refinement (FastSLAM-2.0-style): descend the
    # interpolated distance field before weighting; 0 disables
    grad_refine_steps: int = 0
    grad_step_xy: float = 0.02      # max per-iteration xy move (m)
    grad_step_theta: float = 0.004  # max per-iteration theta move (rad)


@dataclass(frozen=True)
class SubmapConfig:
    """Tiled long-term mapping (north-star extension; the reference's single
    20k-point buffer saturates and cannot be moved by loop closures)."""

    n_submaps: int = 64             # device-resident submap slots
    submap_capacity: int = 2048     # points per submap (anchor frame)
    # submaps gathered into the matcher's local map. Must cover the scan's
    # 24 m usable range: with 2 m anchor spacing, 8 nearest anchors span the
    # surfaces the correlative matcher scores against (k=4 loses walls and
    # triples ATE on the loop benchmark)
    k_nearest: int = 8
    spawn_dist: float = 2.0         # m from active anchor before a new submap
    spawn_fill_frac: float = 0.9    # active-submap fill ratio forcing a spawn


@dataclass(frozen=True)
class SlamConfig:
    """Top-level config bundle."""

    lidar: LidarConfig = LidarConfig()
    grid: GridConfig = GridConfig()
    matcher: MatcherConfig = MatcherConfig()
    map: MapConfig = MapConfig()
    particles: ParticleConfig = ParticleConfig()
    submaps: SubmapConfig = SubmapConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SlamConfig":
        raw: dict[str, Any] = json.loads(text)
        return cls(
            lidar=LidarConfig(**raw.get("lidar", {})),
            grid=GridConfig(**raw.get("grid", {})),
            matcher=MatcherConfig(**raw.get("matcher", {})),
            map=MapConfig(**raw.get("map", {})),
            particles=ParticleConfig(**raw.get("particles", {})),
            submaps=SubmapConfig(**raw.get("submaps", {})),
        )


DEFAULT_CONFIG = SlamConfig()

# Building-scale workload (io/simulate.building_world): with the reference's
# 24 m usable-range gate, a hall/corridor scan's local-map AABB reaches
# 2*24 + 2*border + 6*pixel ~ 50.6 m — beyond the museum grids' 40 m coverage
# (200 @ 0.2 m / 400 @ 0.1 m, main.c:200-213, which the reference would
# silently overflow). The building preset widens the fixed rasters to 51.2 m
# and the point map to 40k points (the 20k buffer saturates ~1/3 through the
# tour and the matcher loses surfaces behind it).
BUILDING_CONFIG = SlamConfig(
    grid=GridConfig(coarse_size=256, fine_size=512),
    map=MapConfig(map_capacity=40000),
    # 13 theta bins: the building tour's corridor turns change heading
    # faster than the default +-3-bin (~0.75 deg) weighting window covers —
    # with 7 bins the whole cloud edge-clamps at a turn near scan 1495 and
    # the filter never recovers (ATE 6.3 m); +-6 bins tracks it (~0.9 m —
    # the remaining error is one lower-corridor mis-registration baked into
    # the map, which a filter without loop closure cannot undo; the
    # wide-window frontend and the graph backend run the same tour at
    # 0.04-0.17 m).
    # cascade_levels=1: the min-pooled coarse level flattens the weighting
    # and measurably hurts here (6.0-7.0 m at levels=2 across sigma sweeps).
    particles=ParticleConfig(cascade_levels=1, vol_theta_bins=13),
)

# The building workload *solved* (vs BUILDING_CONFIG, which keeps the
# reference's +-1 matcher window for bit-exact oracle parity — and diverges
# exactly like the oracle does over the 3800-scan tour). A +-2-step search
# window per matcher stage keeps the frontend locked through the fast
# corridor turns the +-1 window loses (ATE 0.092 m in the JAX package).
# Wider windows hurt there (long-range candidates alias to parallel walls),
# so the window is a precision instrument, not a "more is better" knob.
BUILDING_WIDE_CONFIG = dataclasses.replace(
    BUILDING_CONFIG,
    matcher=MatcherConfig(window_t=2, window_r=2),
)
