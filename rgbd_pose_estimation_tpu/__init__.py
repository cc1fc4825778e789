"""rgbd_pose_estimation_tpu — an RGB-D pose estimation / SLAM engine in JAX.

A batch-first JAX/XLA framework with the capabilities of the reference
header-only C++ library ``ShudaLi/rgbd_pose_estimation`` (see SURVEY.md):

- ``core``     — SO(3)/SE(3) Lie-group math and camera models (batched jnp).
- ``solvers``  — closed-form minimal solvers: 3D-3D absolute orientation
                 (Kabsch/Umeyama/Horn), P3P and N-point PnP. All ``vmap``-able.
- ``ransac``   — massively parallel RANSAC/PROSAC hypothesize-and-score.
- ``ops``      — hot operations (RANSAC scoring, ICP JtJ accumulation) and
                 their HIGHEST-precision references.
- ``icp``      — dense projective point-to-plane ICP odometry.
- ``features`` — keypoint/descriptor front-end (host OpenCV ORB or on-device
                 FAST+BRIEF) + on-device matching.
- ``data``     — TUM RGB-D loader, synthetic scenes, vertex/normal maps.
- ``graph``    — keyframe SE(3) pose-graph optimization.
- ``ba``       — Schur-complement bundle adjustment.
- ``parallel`` — device meshes, PartitionSpecs, shard_map'd distributed steps.
- ``models``   — end-to-end estimators (frame-pair, odometry, SLAM).
- ``eval``     — ATE/RPE evaluation and TUM trajectory I/O.
- ``utils``    — configs, metrics, timing, checkpointing.

Design rules:
- everything under ``jit`` uses static shapes and ``lax`` control flow;
- batch is always the leading axis; solvers operate on thousands of problems;
- no host branching on device values inside the hot path;
- one implementation per operation on every platform; geometric products
  run at ``HIGHEST`` precision (core/lie.py).
"""

__version__ = "0.1.0"
