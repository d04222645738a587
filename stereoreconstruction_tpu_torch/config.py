"""Typed configuration.

The reference hardcodes its stereo/calibration constants across translation
units with "TODO allow passing these values" notes (twoviewstereo.cpp:62-80,
multiviewstereo.cpp:88-102, adaptiveweight.cpp:26, geodesicweight.cpp:31-42,
calibrate.cpp:65-82).  Here they are all promoted into one typed config, with
the reference's defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class WeightConfig:
    """Support-weight aggregation (geodesicweight.cpp / adaptiveweight.cpp)."""
    kind: str = "geodesic"         # "geodesic" | "adaptive" | "uniform"
    geodesic_sigma: float = 50.0   # geodesicweight.cpp:33
    geodesic_iters: int = 3        # geodesicweight.cpp:36
    color_sigma: float = 10.0      # adaptiveweight.cpp:26


@dataclass(frozen=True)
class TwoViewConfig:
    """TwoViewStereo constants (twoviewstereo.cpp:62-80)."""
    window_radius: int = 5
    min_depth: float = 300.0           # README workflow default
    max_depth: float = 800.0
    num_depth_levels: int = 100
    image_scale: float = 0.5
    max_color_diff: float = 120.0      # MAX_COLOR_DIFF
    bad_ret: float = 1000.0            # BAD_RET
    inconsistency_thresh: float = 1.0  # INCONSISTENCY_THRESH
    second_best_factor: float = 0.95   # SECOND_BEST_FACTOR
    gap_width_threshold: int = 2       # GAP_WIDTH_THRESHOLD
    smoothness_exp: int = 1            # MRF smoothness (unused in WTA path)
    smoothness_max: float = 2.0
    smoothness_lambda: float = 0.25
    cost: str = "ncc"                  # "ncc" | "sad"
    weights: WeightConfig = field(default_factory=WeightConfig)


@dataclass(frozen=True)
class MultiViewConfig:
    """MultiViewStereo constants (multiviewstereo.cpp:88-102) — Campbell et
    al. 2009 parameters."""
    window_radius: int = 2
    num_neighbouring_views: int = 3
    top_k: int = 9                     # K
    beta: float = 1.0                  # BETA
    lam: float = 1.0                   # LAMBDA
    phi_u: float = 0.5                 # PHIU
    psi_u: float = 0.002               # PSIU
    ncc_threshold: float = 0.95        # peak acceptance (mvs cpp:589)
    min_depth: float = 300.0
    max_depth: float = 800.0
    num_depth_levels: int = 100
    cross_check_threshold: float = 5.0  # README workflow default
    image_scale: float = 0.5
    view_angle_cos_min: float = 0.2    # neighbour selection (mvs cpp:344)
    use_mrf: bool = False              # reference default: compiled out
    mrf_max_iters: int = 50
    mrf_energy_eps: float = 5.0
    weights: WeightConfig = field(default_factory=WeightConfig)


@dataclass(frozen=True)
class CalibrationConfig:
    """CameraCalibration constants (calibrate.cpp:65-82)."""
    board_cols: int = 11               # inner corners (board_size)
    board_rows: int = 9
    cell_size: float = 11.0            # mm
    num_iterations: int = 5            # RANSAC keep-best loop
    min_subset: int = 30               # calibrate.cpp:761-762
    subset_fraction: float = 2.0 / 3.0
    seed: int = 0                      # reproducible shuffling
    use_bundle_adjust: bool = False    # USE_SBA off by default
    # Outlier-board pruning (ours; the reference only hides outliers from
    # fitting via the RANSAC subset loop): after keep-best, drop (cam, set)
    # observations whose mean pairwise board error exceeds
    # max(floor, factor x median) and refit on the inliers.
    prune_outlier_boards: bool = True
    board_outlier_floor: float = 2.0   # px
    board_outlier_factor: float = 4.0


@dataclass(frozen=True)
class RefractionConfig:
    """RefractionCalibration LM settings (refractioncalibration.cpp:391)."""
    max_iterations: int = 100
    epsilon: float = 1.0
    # Finite-difference steps per parameter kind (refractioncalibration.cpp:
    # 211-223); used by the FD fallback — the default path is autodiff.
    step_index: float = 0.01
    step_px: float = 0.5
    step_py: float = 0.1
    step_dist: float = 0.0001


@dataclass(frozen=True)
class MatchConfig:
    """Feature correspondence (correspondence.cpp:46-52)."""
    max_cost: float = 0.5
    ratio: float = 0.8
