"""Canonical PartitionSpecs for every distributed layout (SURVEY.md §5.8).

One module owns the specs (pattern per SNIPPETS.md [3]) so layouts are
greppable and consistent — ``parallel/sharded.py`` builds every shard_map
in/out spec from here. The geometry-native parallelism mapping
(SURVEY.md §2.2):

- DP axis   → RANSAC hypotheses / frame pairs / pose-graph edges
- TP axis   → pixels of the dense-ICP grid / columns of the score matrix
- SP        → the video: sequence chunks across hosts
- CP (ring) → keyframe blocks rotated by ppermute for all-pairs similarity
- Ulysses   → all-to-all relayout between the frame-ordered (odometry)
              and landmark-blocked (BA) observation layouts —
              ``parallel/sharded.py::reshard_obs_to_blocks`` (a real
              ``jax.lax.all_to_all``, not a documentation claim)
"""

from __future__ import annotations

import dataclasses

from jax.sharding import Mesh, PartitionSpec as P

from rgbd_pose_estimation_tpu.ba.schur import BAProblem


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """PartitionSpecs over a mesh's axis names (any shape/axis naming)."""

    axes: tuple = ("host", "chip")

    @classmethod
    def for_mesh(cls, mesh: Mesh) -> "SpecLayout":
        return cls(axes=tuple(mesh.axis_names))

    @property
    def all_axes(self):
        return self.axes

    # --- RANSAC (DP over hypotheses) ---
    def hypotheses(self) -> P:
        """K poses sharded over every device; correspondences replicated."""
        return P(self.axes)

    def correspondences(self) -> P:
        return P()

    # --- dense ICP (TP over pixel rows) ---
    def pixel_rows(self) -> P:
        """Per-pixel (M, ...) data sharded by pixel block."""
        return P(self.axes)

    # --- BA: observation-sharded layouts ---
    def observations(self) -> P:
        return P(self.axes)

    def cameras(self) -> P:  # replicated; reduced system psum'd (C·6 payload)
        return P()

    def landmarks_replicated(self) -> P:
        """v1 layout: landmarks replicated, O(L) psum per CG matvec."""
        return P()

    def landmarks_blocked(self) -> P:
        """North-star layout: landmark blocks shard-local (ba/cluster.py);
        collective payload per CG matvec is independent of L."""
        return P(self.axes)

    def ba_problem(
        self, blocked: bool, has_obs_z: bool, has_prior: bool = False
    ) -> BAProblem:
        """Specs for a full BAProblem pytree under either landmark layout.

        Relative-pose prior edges are camera-sized — replicated, like the
        cameras they couple."""
        obs = self.observations()
        rep = self.cameras()
        return BAProblem(
            poses=rep,
            points=self.landmarks_blocked() if blocked else self.landmarks_replicated(),
            cam_idx=obs,
            lm_idx=obs,
            obs=obs,
            w=obs,
            obs_z=obs if has_obs_z else None,
            prior_i=rep if has_prior else None,
            prior_j=rep if has_prior else None,
            prior_T_inv=rep if has_prior else None,
            prior_w=rep if has_prior else None,
        )

    # --- ring association (CP over keyframe blocks) ---
    def keyframe_blocks(self) -> P:
        return P(self.axes)


DEFAULT = SpecLayout()
