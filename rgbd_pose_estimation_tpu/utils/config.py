"""Frozen dataclass configs for every stage (SURVEY.md §5.6).

The reference hard-codes constants in its example mains; here each subsystem
takes one frozen (hence hashable) dataclass, so configs can be static jit
arguments without retrace churn, and each of the five driver configs maps to
a YAML file under ``configs/``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched RANSAC/PROSAC hypothesize-and-score (SURVEY.md L2)."""

    num_hypotheses: int = 2048  # K: hypotheses scored per round
    sample_size: int = 3  # m: minimal set size (3 for AO and P3P)
    threshold: float = 0.03  # inlier threshold (meters for 3D-3D,
    #                          normalized-plane units for 2D-3D)
    prosac: bool = True  # progressive sampling over quality-sorted matches
    prosac_growth: float = 0.05  # fraction of hypotheses at full window
    refit_rounds: int = 2  # weighted-refit iterations on the best model
    min_inliers: int = 10  # below this the estimate is flagged invalid
    solver: str = "horn"  # "horn" (matmul-only) or "kabsch" (SVD)
    # Two-round adaptive schedule (SURVEY.md §7 hard-part #6, §3.1
    # "re-batching"): a small-K probe runs first; the full num_hypotheses
    # batch runs only when the probe's inlier ratio fails the standard
    # RANSAC confidence bound. Both shapes are static/pre-compiled.
    probe_hypotheses: int = 1024  # K of the probe round (multiple of 256)
    confidence: float = 0.999  # required P(≥1 uncontaminated sample)


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Dense projective point-to-plane ICP (SURVEY.md L3)."""

    levels: int = 3  # pyramid levels
    iters_per_level: tuple = (5, 7, 10)  # indexed by level: finest first
    downscale: int = 1  # power-of-2 input downsample before tracking;
    # 2 quarters the work if needed.
    max_depth: float = 5.0
    min_depth: float = 0.1
    dist_threshold: float = 0.10  # association gate (meters)
    normal_threshold: float = 0.7  # min cos(angle) between normals
    huber_delta: float = 0.01  # robust weight scale (meters)
    damping: float = 1e-6  # LM damping on the 6x6 solve
    # Photometric (DVO-style intensity) residual alongside point-to-plane.
    # 0 disables; a geometry-degenerate but textured scene (flat wall)
    # needs it — see tests/unit/test_icp.py::test_photometric_*. The
    # weight is in (1/intensity)² units relative to the metric residual.
    photometric_weight: float = 0.0
    photo_huber: float = 0.1  # robust scale for intensity residuals
    # Projective data association. "nearest" (KinectFusion-standard) packs
    # target vertex+normal+validity into ONE flat map and does a single
    # row-gather per GN step, against "bilinear" (4 vertex taps + 1 normal
    # gather), at equal tracking accuracy on the benchmark scenes.
    association: str = "nearest"
    # Source-pixel subsampling stride per level (finest first). Stride s
    # keeps every s-th source row/column (target maps stay full
    # resolution; only the residual SAMPLE thins, s^2-fold), so each GN
    # step gathers and reduces s^2 fewer pixels. Point-to-plane ICP is
    # massively over-determined: 6 unknowns from ~77k residuals at
    # stride 2.
    source_stride: tuple = (1, 1, 1)
    # Re-associate every k-th GN iteration per level (1 = every iteration,
    # the classic KinectFusion loop). Fixed-correspondence GN steps skip
    # the gather and are pure elementwise math — standard ICP alternation
    # permits several minimize steps per association. The skip is a
    # TRACE-time decision (icp/dense.py statically unrolls the k-pattern):
    # a lax.cond formulation lowered to a select that executed both
    # branches and saved nothing. On config-3 hard mode k=2 and k=3 gave
    # equal-or-better ATE on every seed tested; config-3 ships k=2.
    # Because the unroll is static, it survives icp_track_batch's vmap.
    reassoc_every: int = 1


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Keyframe SE(3) pose-graph Gauss-Newton (driver config 4)."""

    iters: int = 20
    damping: float = 1e-6
    loop_sigma: float = 0.05  # loop-closure information weighting
    odom_sigma: float = 0.01
    # Linear solver for the block normal equations (SURVEY.md §3.3):
    # "dense" Cholesky is exact; "pcg" is matrix-free block-Jacobi-
    # preconditioned CG over the edge list — O(E) per matvec, no (6K)²
    # materialization. "auto" picks dense at K ≤ dense_max_nodes; the
    # crossover is not yet measured on the H100 (ROADMAP Queue 1).
    solver: str = "auto"
    pcg_iters: int = 100
    dense_max_nodes: int = 192


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Schur-complement bundle adjustment (driver config 5)."""

    outer_iters: int = 10
    cg_iters: int = 30
    damping: float = 1e-4
    huber_delta: float = 0.01
    depth_weight: float = 1.0  # weight of the RGB-D depth residual (1/m
    #   units; 0 disables depth rows and reverts to pure reprojection BA —
    #   which then has a free scale gauge, so keep it on for RGB-D)
    prior_weight: float = 100.0  # odometry relative-pose prior information
    #   (ba/schur.py with_odometry_priors). Dense odometry knows relative
    #   motion to ~1e-3; feature tracks on small problems are far weaker —
    #   without this, BA trades real pose accuracy for reprojection
    #   residual. 0 disables (pure feature BA).


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for distributed runs (SURVEY.md §5.8)."""

    hosts: int = 1
    chips_per_host: int = 1
    host_axis: str = "host"
    chip_axis: str = "chip"


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe selection policy for odometry/SLAM."""

    min_inlier_ratio: float = 0.65  # new keyframe when overlap drops below
    max_interval: int = 20  # ... or after this many frames
    max_keyframes: int = 512  # static buffer bound (jit-friendly)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Sparse feature front-end (detection + matching)."""

    # "orb" = host OpenCV ORB (reference parity; needs cv2); "tpu" =
    # on-device FAST+BRIEF (features/tpu_detect.py). Both feed the same
    # device Hamming matcher and the BA track builder (ba/build.py).
    detector: str = "orb"
    max_features: int = 512


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline wiring of the above."""

    ransac: RansacConfig = RansacConfig()
    icp: IcpConfig = IcpConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    ba: BAConfig = BAConfig()
    mesh: MeshConfig = MeshConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    frontend: FrontendConfig = FrontendConfig()


_SECTIONS = {
    "ransac": RansacConfig,
    "icp": IcpConfig,
    "pose_graph": PoseGraphConfig,
    "ba": BAConfig,
    "mesh": MeshConfig,
    "keyframe": KeyframeConfig,
    "frontend": FrontendConfig,
}


def _parse_scalar(s: str):
    t = s.strip()
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return tuple(_parse_scalar(x) for x in inner.split(",")) if inner else ()
    return t.strip("'\"")


def load_yaml_config(path) -> PipelineConfig:
    """Load a PipelineConfig from a minimal two-level YAML file.

    Supports the subset of YAML the checked-in configs use (section headers +
    ``key: value`` pairs + comments) with no external dependency; unknown
    keys raise so config drift is caught immediately.
    """
    sections: dict = {}
    current: Optional[str] = None
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if not line.startswith(" ") and line.endswith(":"):
                current = line[:-1].strip()
                sections[current] = {}
            elif ":" in line and current is not None:
                k, v = line.split(":", 1)
                sections[current][k.strip()] = _parse_scalar(v)
            else:
                raise ValueError(f"unparseable config line: {raw!r}")
    kwargs = {}
    for name, vals in sections.items():
        if name not in _SECTIONS:
            raise ValueError(f"unknown config section: {name}")
        kwargs[name] = _SECTIONS[name](**vals)
    return PipelineConfig(**kwargs)
