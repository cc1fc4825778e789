"""Dense RGB-D odometry over a sequence (driver config 3).

SURVEY.md §3.2: the host loop is the *only* loop — everything per frame is
one compiled ``icp_track`` call (pyramid build included). Tracks frame-to-
keyframe: each new frame is registered against the current keyframe, and a
new keyframe is spawned when the association overlap drops (or a max
interval passes), which bounds drift accumulation compared to strict
frame-to-frame chaining. Emits per-frame JSONL metrics and keeps the
keyframe list + odometry edges that the pose graph (config 4) consumes.

Two ingestion modes:

- :meth:`DenseOdometry.process` — synchronous, returns the frame's pose
  immediately (one device→host fetch per frame).
- :meth:`DenseOdometry.process_stream` — pipelined: frame i+1's track is
  dispatched *before* frame i's result is fetched, so the device round-trip
  (the dominant per-frame cost on remote-attached accelerators) overlaps
  the next frame's compute. Identical math; the only semantic difference
  is that keyframe adoption lags one frame (the decision for frame i lands
  while i+1 is already in flight against the previous keyframe — both
  tracks are geometrically valid, drift behavior is unchanged in practice).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu.icp.dense import icp_track, make_icp_frame
from rgbd_pose_estimation_tpu.utils.config import IcpConfig, KeyframeConfig
from rgbd_pose_estimation_tpu.utils.metrics import MetricsLogger


def _inv_se3_np(T: np.ndarray) -> np.ndarray:
    """Host-side rigid-transform inverse — a 4×4 is not worth a device trip."""
    R = T[:3, :3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


@dataclasses.dataclass
class Keyframe:
    index: int  # frame index in the sequence
    pose: np.ndarray  # world→camera (4, 4)
    frame: object  # IcpFrame pyramid (device arrays)
    descriptor: Optional[np.ndarray] = None  # loop-closure descriptor
    # Association mass of perfect self-overlap (device scalar, fetched
    # lazily on first use so keyframe creation costs no extra round-trip).
    ref_weight: object = None

    def ref_weight_value(self) -> float:
        if self.ref_weight is None:
            # Directly-constructed keyframes (tests, pose-graph code) carry
            # no association mass; treat as "no reference" rather than crash.
            return 0.0
        if not isinstance(self.ref_weight, float):
            self.ref_weight = float(self.ref_weight)
        return self.ref_weight


class DenseOdometry:
    """Frame-to-keyframe dense ICP odometry with keyframe management."""

    def __init__(
        self,
        cam: CameraIntrinsics,
        icp_cfg: IcpConfig = IcpConfig(),
        kf_cfg: KeyframeConfig = KeyframeConfig(),
        metrics: Optional[MetricsLogger] = None,
        depth_scale: float = 1.0 / 5000.0,
    ):
        # Tracking runs at cam/downscale resolution (IcpConfig.downscale);
        # self.cam is the TRACKING camera — loop-closure ICP and overlap
        # bookkeeping stay consistent with the stored pyramids.
        self.cam_full = cam
        ds = icp_cfg.downscale
        assert ds >= 1 and (ds & (ds - 1)) == 0, "downscale must be a power of 2"
        self.cam = cam.scaled(1.0 / ds) if ds > 1 else cam
        self.icp_cfg = icp_cfg
        self.kf_cfg = kf_cfg
        self.metrics = metrics or MetricsLogger()

        def _prep(d, intensity):
            from rgbd_pose_estimation_tpu.data.geometry import (
                downsample_depth,
                downsample_intensity,
            )

            if jnp.issubdtype(d.dtype, jnp.integer):
                # Raw sensor units shipped as-is (uint16 halves the H2D
                # bytes); convert to meters here, on device.
                d = d.astype(jnp.float32) * depth_scale
            for _ in range(ds.bit_length() - 1):
                d = downsample_depth(d)
                if intensity is not None:
                    intensity = downsample_intensity(intensity)
            frame = make_icp_frame(self.cam, d, icp_cfg, intensity)
            n0 = frame.normals[0]
            ref_w = jnp.sum(jnp.sum(n0 * n0, axis=-1) > 0.5).astype(jnp.float32)
            return frame, ref_w

        # ``None`` intensity is a distinct pytree structure → its own trace;
        # both variants compile once each.
        self._make_frame = jax.jit(_prep)

        def _to_device(depth):
            expect = (cam.height, cam.width)
            if depth.shape[-2:] != expect:
                raise ValueError(
                    f"frame shape {depth.shape[-2:]} does not match the "
                    f"camera ({expect}); pass --intrinsics from_dataset or "
                    "the matching CameraIntrinsics"
                )
            if isinstance(depth, jax.Array):
                return depth  # already shipped (e.g. by the prefetcher)
            a = np.asarray(depth)
            if np.issubdtype(a.dtype, np.floating) and a.dtype != np.float32:
                a = a.astype(np.float32)
            return jnp.asarray(a)

        self._to_device = _to_device
        self.poses: List[np.ndarray] = []  # world→camera per frame
        self.keyframes: List[Keyframe] = []
        self.odom_edges: List[tuple] = []  # (kf_i, kf_j, T_ij) relative
        self._kf_pose_inv = None  # camera→world of current keyframe
        self._last_rel = None  # last frame's pose relative to keyframe (host)

    # --- internals ------------------------------------------------------

    def _bootstrap(self, i, frame, ref_w, t0):
        pose = np.eye(4, dtype=np.float32)
        self._new_keyframe(i, pose, frame, ref_w)
        self.poses.append(pose)
        self.metrics.log(frame=i, ms=(time.perf_counter() - t0) * 1e3, keyframe=True)
        return pose

    def _dispatch(self, frame, kf, T_init):
        """Launch one track (async). Returns the in-flight record."""
        return {
            "kf": kf,
            "frame": frame,
            "out": icp_track(self.cam, self.icp_cfg, T_init, frame, kf.frame),
        }

    def _resolve(self, i, rec, ref_w, t0, pipelined=False):
        """Fetch a dispatched track, update poses/keyframes, return pose.

        ``pipelined`` marks stream-mode records whose wall-clock spans one
        extra iteration of overlap (frame i+1's ingestion and dispatch run
        between frame i's t0 and its resolve) — the flag is logged so the
        ms column is not compared against :meth:`process` timings.
        """
        T_rel_np, stats_np = jax.device_get(rec["out"])
        kf = rec["kf"]
        wsum = float(stats_np[1])

        # World pose: x_w = kf_pose^-1 · T_rel · x_cam → pose = (·)^-1.
        kf_pose_inv = (
            self._kf_pose_inv
            if kf is self.keyframes[-1]
            else _inv_se3_np(np.asarray(kf.pose, np.float32))
        )
        pose = _inv_se3_np(kf_pose_inv @ T_rel_np)
        self.poses.append(pose)
        self._last_rel = T_rel_np

        overlap = wsum / max(kf.ref_weight_value(), 1e-6)
        is_kf = (
            overlap < self.kf_cfg.min_inlier_ratio
            or (i - kf.index) >= self.kf_cfg.max_interval
        )
        if is_kf and len(self.keyframes) < self.kf_cfg.max_keyframes:
            self.odom_edges.append((kf.index, i, T_rel_np))
            self._new_keyframe(i, pose, rec["frame"], ref_w)
        self.metrics.log(
            frame=i,
            ms=(time.perf_counter() - t0) * 1e3,
            overlap=overlap,
            keyframe=bool(is_kf),
            **({"pipelined": True} if pipelined else {}),
        )
        return pose

    def _new_keyframe(self, i, pose, frame, ref_w):
        self.keyframes.append(Keyframe(i, pose, frame, None, ref_w))
        self._kf_pose_inv = _inv_se3_np(np.asarray(pose, dtype=np.float32))
        self._last_rel = np.eye(4, dtype=np.float32)

    # --- synchronous API --------------------------------------------------

    def process(
        self,
        depth: np.ndarray,
        frame_index: Optional[int] = None,
        intensity: Optional[np.ndarray] = None,
    ):
        """Ingest the next depth frame; returns its world→camera pose.

        Pass ``intensity`` (H, W float in [0,1]) when
        ``IcpConfig.photometric_weight > 0`` to add the DVO-style intensity
        residual — required on geometry-degenerate (flat, textured) scenes.
        """
        t0 = time.perf_counter()
        i = frame_index if frame_index is not None else len(self.poses)
        use_photo = (
            self.icp_cfg.photometric_weight > 0 and intensity is not None
        )
        frame, ref_w = self._make_frame(
            self._to_device(depth),
            self._to_device(intensity) if use_photo else None,
        )
        if not self.keyframes:
            return self._bootstrap(i, frame, ref_w, t0)
        kf = self.keyframes[-1]
        rec = self._dispatch(frame, kf, jnp.asarray(self._last_rel))
        return self._resolve(i, rec, ref_w, t0)

    # --- pipelined streaming API ----------------------------------------

    def process_stream(
        self,
        depths,
        start_index: int = 0,
        h2d_batch: int = 1,
        pipeline_depth: int = 2,
    ):
        """Track an iterable of depth frames, pipelined; yields (i, pose).

        Dispatches frame i+1's track before fetching frame i's result, so
        the device→host round-trip overlaps compute. ``T_init`` for the
        in-flight frame chains from the *device-resident* previous result
        (no sync on the critical path); after a keyframe switch it falls
        back to the host value exactly like :meth:`process`.

        ``h2d_batch > 1`` stacks that many host frames into ONE host→device
        transfer and hands the tracker device-side slices — on links where
        per-transfer latency dominates, ingestion cost drops ~h2d_batch-fold.
        Tracking math and keyframe decisions are unchanged; only ingestion
        granularity differs (adds ≤h2d_batch frames of latency, throughput
        pipeline semantics otherwise identical).

        ``pipeline_depth`` frames stay in flight before the oldest result
        is fetched, and every dispatched result starts its device→host
        copy immediately (``copy_to_host_async``): with depth D the fetch
        round-trip of frame i overlaps frames i+1..i+D's compute. Keyframe
        adoption lags ≤D frames (all in-flight tracks remain geometrically
        valid against the previous keyframe; drift behavior unchanged).
        """
        if h2d_batch > 1:
            depths = self._batch_h2d(depths, h2d_batch)
        import collections

        pending = collections.deque()  # (i, rec, ref_w, t0) in flight
        last = None  # (kf, device T_rel of most recent dispatch)
        depth_cap = max(1, pipeline_depth)
        use_photo = self.icp_cfg.photometric_weight > 0
        for k, item in enumerate(depths):
            # Items may be bare depth maps or (depth, intensity) pairs.
            depth, intensity = (
                item if isinstance(item, tuple) else (item, None)
            )
            i = start_index + k
            t0 = time.perf_counter()
            frame, ref_w = self._make_frame(
                self._to_device(depth),
                self._to_device(intensity)
                if (use_photo and intensity is not None)
                else None,
            )
            if not self.keyframes:
                yield i, self._bootstrap(i, frame, ref_w, t0)
                continue
            kf = self.keyframes[-1]
            if last is not None and last[0] is kf:
                T_init = last[1]  # device array: zero-sync chaining
            else:
                T_init = jnp.asarray(self._last_rel)
            rec = self._dispatch(frame, kf, T_init)
            # Start the device→host copy of the (tiny) results NOW: it
            # completes behind later frames' compute, so the eventual
            # device_get in _resolve finds the bytes already landed —
            # on remote-attached devices the fetch round-trip is the
            # per-frame critical path otherwise.
            for o in rec["out"]:
                o.copy_to_host_async()
            pending.append((i, rec, ref_w, t0))
            last = (kf, rec["out"][0])
            while len(pending) > depth_cap:
                pi, prec, pref, pt0 = pending.popleft()
                yield pi, self._resolve(pi, prec, pref, pt0, pipelined=True)
        while pending:
            pi, prec, pref, pt0 = pending.popleft()
            yield pi, self._resolve(pi, prec, pref, pt0, pipelined=True)

    @staticmethod
    def _batch_h2d(items, batch: int):
        """Re-yield frames (or (depth, intensity) pairs) after stacked H2D.

        Groups ``batch`` host arrays, ships each group as one stacked
        transfer, then yields per-frame device slices (slicing a resident
        array costs no host round-trip).
        """

        def ship(group):
            has_int = isinstance(group[0], tuple)
            ds = [g[0] if has_int else g for g in group]
            dev_d = jnp.asarray(np.stack([np.asarray(d) for d in ds]))
            if has_int:
                ints = [np.asarray(g[1]) for g in group]
                dev_i = jnp.asarray(np.stack(ints))
                for k in range(len(group)):
                    yield dev_d[k], dev_i[k]
            else:
                for k in range(len(group)):
                    yield dev_d[k]

        group = []
        for item in items:
            if isinstance(item, jax.Array) or (
                isinstance(item, tuple) and isinstance(item[0], jax.Array)
            ):
                # Already device-resident (e.g. the prefetcher shipped it).
                for g in group:
                    yield g
                group = []
                yield item
                continue
            group.append(item)
            if len(group) == batch:
                yield from ship(group)
                group = []
        if group:
            yield from ship(group)

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
