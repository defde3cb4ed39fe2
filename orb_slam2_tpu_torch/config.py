"""Central configuration: every behavioral threshold of the engine.

The reference scatters ~100 hand-tuned constants through its sources; they —
not the architecture — determine trajectory accuracy (SURVEY.md §7 "hard
part 5").  They are all collected here, each with the reference file:line it
reproduces, so parity can be audited in one place.

Static *capacities* (max keypoints / keyframes / landmarks) are a TPU-native
addition: every array in the engine has a fixed shape, with validity masks, so
all step functions compile once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


# ---------------------------------------------------------------------------
# Sensor types (reference System.h:49-54)
# ---------------------------------------------------------------------------
MONOCULAR = 0
STEREO = 1
RGBD = 2


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB feature extraction parameters (reference ORBextractor.cc:410-470,
    Tracking.cc:104-132 reads them from YAML)."""

    n_features: int = 1000          # ORBextractor.nFeatures (TUM1.yaml:26)
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_th_fast: int = 20           # ORBextractor.iniThFAST (ORBextractor.cc:809)
    min_th_fast: int = 7            # ORBextractor.minThFAST (fallback, :813)
    patch_size: int = 31            # ORBextractor.cc:72
    half_patch_size: int = 15       # ORBextractor.cc:73
    edge_threshold: int = 19        # ORBextractor.cc:74
    cell_size: int = 30             # 30x30px FAST cells (ORBextractor.cc:789)
    # Pre-descriptor Gaussian blur.  Reference uses 7x7 sigma=2
    # (ORBextractor.cc:1086); with our own BRIEF pattern a 9x9 sigma=3 blur
    # measurably improves true-pair Hamming (median 51 -> 44 on the synthetic
    # benchmark) at identical best-match discriminability (scripts/exp_desc.py).
    blur_ksize: int = 9
    blur_sigma: float = 3.0
    # Static capacity: max keypoints kept per frame (padded/masked).
    max_keypoints: int = 1024

    @property
    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching thresholds (reference ORBmatcher.cc:37-39 and the
    per-entry-point ratio/threshold choices)."""

    th_high: int = 100              # ORBmatcher.cc:37
    th_low: int = 50                # ORBmatcher.cc:38
    histo_length: int = 30          # ORBmatcher.cc:39 rotation histogram bins
    nn_ratio_track_ref: float = 0.7   # Tracking.cc:764 SearchByBoW ratio
    nn_ratio_local: float = 0.8       # Tracking.cc:1162 SearchByProjection
    nn_ratio_init: float = 0.9        # Tracking.cc:571 SearchForInitialization
    nn_ratio_reloc_bow: float = 0.75  # Tracking.cc:1362
    nn_ratio_sim3: float = 0.75       # LoopClosing.cc:243
    search_window_track: int = 7      # th for stereo/rgbd motion model (Tracking.cc:898)
    search_window_track_mono: int = 15  # mono motion model window (Tracking.cc:898)
    init_window: int = 100            # SearchForInitialization window (Tracking.cc:620)
    # Initialization descriptor gate.  The reference uses TH_LOW=50
    # (ORBmatcher.cc:449); our BRIEF pattern has a wider true-pair Hamming
    # distribution on low-contrast imagery (scripts/exp_desc.py), so the
    # two-view bootstrap admits more tentative pairs and lets the batched
    # 8-point RANSAC reject the extras.
    th_init: int = 75
    # Loop/reloc cross-revisit matching gate.  Same rationale as th_init:
    # the custom BRIEF pattern's true-pair Hamming distribution is wider
    # than the reference's learned bit_pattern_31_, and revisit viewpoint
    # change widens it further; TH_LOW=50 (LoopClosing SearchByBoW,
    # ORBmatcher.cc:522-655) starves the >=20-match Sim3 gate.  The Sim3
    # RANSAC + two-way agreement downstream rejects the extra outliers.
    th_loop: int = 75
    check_orientation: bool = True


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking state-machine thresholds (reference Tracking.cc)."""

    min_init_kps: int = 100         # mono init needs >100 kps (Tracking.cc:570,582)
    min_init_matches: int = 100     # >=100 matches to try init (Tracking.cc:593)
    min_matches_ref_kf: int = 15    # TrackReferenceKeyFrame gate (Tracking.cc:772)
    min_matches_motion: int = 20    # TrackWithMotionModel gate (Tracking.cc:910)
    min_inliers_track: int = 10     # post-opt inlier gate (Tracking.cc:796,925)
    min_inliers_local_map: int = 30  # TrackLocalMap gate (Tracking.cc:969)
    min_inliers_local_map_reloc: int = 50  # within 1s of reloc (Tracking.cc:962)
    max_frames_hint: int = 30       # mMaxFrames = fps (Tracking.cc:83)
    min_frames: int = 0             # mMinFrames (Tracking.cc:84)
    # deterministic replacement for the reference's LocalMapping-idle
    # keyframe throttle (Tracking.cc:999,1050): minimum frame gap between
    # keyframes when inserting on the tracked-ratio condition
    min_kf_gap: int = 3
    # NeedNewKeyFrame: thRefRatio per sensor (Tracking.cc:1022-1026)
    kf_ref_ratio_stereo: float = 0.75
    kf_ref_ratio_mono: float = 0.9
    kf_min_obs: int = 3             # nMinObs when >2 KFs (Tracking.cc:989)
    close_depth_n: int = 100        # stereo: want 100 close points (Tracking.cc:1010,1104)
    close_trackable_min: int = 70   # c1c close-point trigger (Tracking.cc:1016)
    stereo_init_min_kps: int = 500  # StereoInitialization gate (Tracking.cc:512)
    reloc_recent_window: int = 30   # frames ~1s at 30fps (mMaxFrames use, Tracking.cc:961)


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Monocular two-view initializer (reference Initializer.cc)."""

    # 200 in the reference (Initializer.cc:78); batched hypothesis scoring is
    # one [iters, 8] einsum here so extra hypotheses are nearly free, and the
    # wider th_init match set benefits from them
    ransac_iters: int = 320
    sigma: float = 1.0              # Tracking.cc:593 Initializer(F, 1.0, 200)
    h_inlier_th: float = 5.991      # CheckHomography (Initializer.cc:310)
    f_inlier_th: float = 3.841      # CheckFundamental (Initializer.cc:395)
    score_th: float = 5.991         # both models scored against this (Initializer.cc:396)
    rh_homography_th: float = 0.40  # RH>0.40 -> homography (Initializer.cc:115)
    min_parallax_deg: float = 1.0   # ReconstructF/H (Initializer.cc:502,721)
    min_triangulated: int = 50      # Initializer.cc:502
    cheirality_frac: float = 0.9    # maxGood >= 0.9N (Initializer.cc:506)
    second_best_frac: float = 0.75  # ReconstructH secondBest<0.75*best (Initializer.cc:721)
    unique_winner_frac: float = 0.7  # ReconstructF (Initializer.cc:509)


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Local mapping thresholds (reference LocalMapping.cc)."""

    found_ratio_min: float = 0.25   # MapPointCulling (LocalMapping.cc:184)
    cull_min_obs: int = 3           # <=cnThObs after 2 KFs -> bad (LocalMapping.cc:189)
    triangulate_neighbors: int = 20  # mono: 20 best covisible KFs (LocalMapping.cc:217)
    triangulate_neighbors_stereo: int = 10
    kf_cull_redundancy: float = 0.9  # >90% points seen 3x elsewhere (LocalMapping.cc:636)
    kf_cull_th_obs: int = 3          # thObs (LocalMapping.cc:665)
    epipolar_chi2_mono: float = 5.991   # reprojection gate (LocalMapping.cc:365)
    epipolar_chi2_stereo: float = 7.8   # (LocalMapping.cc:376)
    scale_consistency: float = 1.5   # ratioFactor = 1.5*scaleFactor (LocalMapping.cc:238)
    fuse_radius: float = 3.0         # SearchInNeighbors Fuse default th (ORBmatcher.h:75)
    # SearchInNeighbors covisible targets (reference: 20 mono / 10 stereo
    # first-order + up to 5 second-order each, LocalMapping.cc:457-476; here
    # the fuse is two-way per neighbor so 8 first-order + 4 second-order
    # targets give comparable merge coverage at a fraction of the cost)
    fuse_neighbors: int = 8
    fuse_neighbors_second: int = 4  # LocalMapping.cc:465-476


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closing thresholds (reference LoopClosing.cc, KeyFrameDatabase.cc)."""

    min_kfs_since_last: int = 10    # LoopClosing.cc:114
    covisibility_consistency_th: int = 3  # LoopClosing.cc:48 mnCovisibilityConsistencyTh
    min_bow_matches: int = 20       # ComputeSim3 gate (LoopClosing.cc:274)
    min_sim3_inliers: int = 20      # OptimizeSim3 gate (LoopClosing.cc:330)
    min_total_matches: int = 40     # final acceptance (LoopClosing.cc:389)
    shared_word_frac: float = 0.8   # minCommonWords = 0.8*max (KeyFrameDatabase.cc:113)
    acc_score_frac: float = 0.75    # retain >0.75*bestAccScore (KeyFrameDatabase.cc:177)
    sim3_ransac_prob: float = 0.99  # LoopClosing.cc:301 Sim3Solver params
    sim3_ransac_min_inliers: int = 20
    sim3_ransac_max_iters: int = 300
    sim3_chi2: float = 9.210        # per-octave max error (Sim3Solver.cc:87-88)
    search_and_fuse_radius: float = 4.0  # LoopClosing.cc:594
    sim3_search_radius: float = 7.5  # SearchBySim3 th (ORBmatcher.cc:1102 call site LoopClosing.cc:323)
    essential_min_weight: int = 100  # covisibility edges >=100 (Optimizer.cc:952)


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """Relocalization PnP RANSAC (reference PnPsolver.cc:121-152, call site
    Tracking.cc:1386)."""

    prob: float = 0.99
    min_inliers: int = 10
    max_iters: int = 300
    min_set: int = 4
    epsilon: float = 0.5
    th2: float = 5.991
    iters_per_round: int = 5        # Tracking.cc:1414


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment schedules (reference Optimizer.cc)."""

    pose_opt_rounds: int = 4        # PoseOptimization 4 rounds (Optimizer.cc:367)
    pose_opt_iters: int = 10        # x10 LM iterations each
    chi2_mono: float = 5.991        # inlier gate (Optimizer.cc:372)
    chi2_stereo: float = 7.815      # (Optimizer.cc:373)
    local_ba_iters1: int = 5        # LocalBundleAdjustment (Optimizer.cc:659)
    local_ba_iters2: int = 10       # after outlier demotion (Optimizer.cc:709)
    global_ba_iters: int = 20       # mono init GBA (Tracking.cc:686)
    loop_gba_iters: int = 10        # post-loop GBA (LoopClosing.cc:650)
    ess_graph_iters: int = 20       # OptimizeEssentialGraph (Optimizer.cc:987)
    sim3_opt_iters: int = 5         # OptimizeSim3 (Optimizer.cc:1196)
    huber_mono: float = 5.991 ** 0.5    # sqrt(5.99) (Optimizer.cc:118)
    huber_stereo: float = 7.815 ** 0.5  # sqrt(7.815) (Optimizer.cc:155)
    lambda_init_pose_graph: float = 1e-16  # Optimizer.cc:794
    lm_lambda_init: float = 1e-5    # g2o default-ish initial damping
    lm_lambda_factor: float = 10.0


@dataclasses.dataclass(frozen=True)
class VocabConfig:
    """Bag-of-words vocabulary (reference ships k=10, L=6 ~1M words,
    TemplatedVocabulary.h; we default to a smaller tree trained on the fly —
    the dense-BoW TPU formulation favors ~10k words)."""

    branching: int = 10             # k
    depth: int = 4                  # L  (10^4 = 10k words)
    levels_up: int = 2              # FeatureVector grouping level (ref uses 4 of 6)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Fixed array capacities of the map state (TPU-native addition; the
    reference grows STL containers without bound)."""

    max_keyframes: int = 512
    max_points: int = 32768
    max_obs_per_kf: int = 1024      # == ORBConfig.max_keypoints
    max_obs_per_point: int = 16     # observer-table slots per map point
    max_frames: int = 8192          # device-side trajectory log capacity
    local_window: int = 80          # local-map KF cap (Tracking.cc:1285)
    local_ba_kfs: int = 32          # local BA variable KFs (covisible set)
    local_ba_fixed: int = 32        # fixed anchor KFs
    local_ba_points: int = 8192     # compacted landmark slots in local BA
    grid_rows: int = 48             # FRAME_GRID_ROWS (Frame.h:37)
    grid_cols: int = 64             # FRAME_GRID_COLS (Frame.h:38)
    max_per_grid_cell: int = 16


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera + stereo parameters (read from YAML by reference
    Tracking.cc:53-103)."""

    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0                 # baseline * fx (stereo); 0 for mono
    fps: float = 30.0
    width: int = 640
    height: int = 480
    th_depth: float = 35.0          # close/far point threshold (Tracking.cc:96)
    depth_map_factor: float = 5000.0  # TUM depth scaling (Tracking.cc:139)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Top-level engine configuration."""

    sensor: int = MONOCULAR
    # Frames tracked per device program: >1 runs a lax.scan "super-step"
    # over a small frame batch in ONE jit, amortizing per-program dispatch
    # and runtime overhead (a TPU-native addition — the per-frame semantics
    # are identical; host reactions lag up to `frame_batch` extra frames,
    # within the async HUD lag already present).
    frame_batch: int = 1
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    vocab: VocabConfig = dataclasses.field(default_factory=VocabConfig)
    cap: Capacity = dataclasses.field(default_factory=Capacity)

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


def tum1_config(sensor: int = MONOCULAR) -> SLAMConfig:
    """TUM freiburg1 settings (reference Examples/Monocular/TUM1.yaml)."""
    cam = CameraConfig(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        bf=40.0 if sensor != MONOCULAR else 0.0,
        fps=30.0, width=640, height=480, th_depth=40.0,
    )
    return SLAMConfig(sensor=sensor, camera=cam)


def kitti_config() -> SLAMConfig:
    """KITTI 00-02 stereo settings (reference Examples/Stereo/KITTI00-02.yaml)."""
    cam = CameraConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        bf=386.1448, fps=10.0, width=1241, height=376, th_depth=35.0,
    )
    orb = ORBConfig(n_features=2000, max_keypoints=2048)
    cap = Capacity(max_keyframes=2048, max_points=131072, max_obs_per_kf=2048)
    return SLAMConfig(sensor=STEREO, camera=cam, orb=orb, cap=cap)


def euroc_config() -> SLAMConfig:
    """EuRoC stereo settings (reference Examples/Stereo/EuRoC.yaml)."""
    cam = CameraConfig(
        fx=435.2046959714599, fy=435.2046959714599,
        cx=367.4517211914062, cy=252.2008514404297,
        bf=47.90639384423901, fps=20.0, width=752, height=480, th_depth=35.0,
    )
    orb = ORBConfig(n_features=1200, max_keypoints=1280)
    return SLAMConfig(sensor=STEREO, camera=cam, orb=orb)
