"""On-TPU FAST+BRIEF detector: localization, invariance, end-to-end pose.

The detector replaces the host OpenCV ORB path (SURVEY.md §2.1 stretch:
on-device FAST/BRIEF); these tests pin its contract: corners land where
corners are, descriptors survive rotation, and the full device-side
front-end feeds RANSAC well enough to recover a ground-truth pose.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.features.frontend import match_descriptors
from rgbd_pose_estimation_tpu.features.tpu_detect import (
    detect_and_describe,
    detect_tpu,
    fast_scores,
)


def _blocky_image(seed=0, h=120, w=160, n=24, rng_vals=True):
    """Random axis-aligned bright rectangles on a dark ramp — known corners."""
    rng = np.random.default_rng(seed)
    img = (np.linspace(0, 0.15, w, dtype=np.float32)[None, :]).repeat(h, 0).copy()
    corners = []
    for _ in range(n):
        y0, x0 = rng.integers(25, h - 45), rng.integers(25, w - 45)
        hh, ww = rng.integers(12, 20), rng.integers(12, 20)
        val = rng.uniform(0.5, 1.0) if rng_vals else 0.8
        img[y0 : y0 + hh, x0 : x0 + ww] = val
        corners += [(y0, x0), (y0, x0 + ww - 1), (y0 + hh - 1, x0), (y0 + hh - 1, x0 + ww - 1)]
    return img, np.asarray(corners, np.float32)


class TestFast:
    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 0.5, jnp.float32)
        assert float(fast_scores(img).max()) == 0.0

    def test_corners_near_rectangle_corners(self):
        img, corners = _blocky_image()
        uv, desc, valid, score = detect_and_describe(jnp.asarray(img), 256)
        uv = np.asarray(uv)[np.asarray(valid)]
        assert len(uv) >= 20
        # Every detection is within 3 px of a true rectangle corner.
        d = np.linalg.norm(
            uv[:, None, ::-1] - corners[None], axis=-1
        ).min(1)
        assert np.median(d) <= 3.0
        assert (d <= 6.0).mean() > 0.8

    def test_scores_descending_and_padded(self):
        img, _ = _blocky_image(n=3)
        uv, desc, valid, score = detect_and_describe(jnp.asarray(img), 512)
        s = np.asarray(score)
        assert (np.diff(s) <= 1e-6).all()  # top_k order
        v = np.asarray(valid)
        assert v[: v.sum()].all() and not v[v.sum() :].any()


class TestBrief:
    def test_rotation_invariance_90deg(self):
        """Descriptors at corresponding keypoints of a 90°-rotated image match."""
        img, _ = _blocky_image(seed=3, h=128, w=128)
        rot = np.rot90(img).copy()  # (x, y) -> (y, W-1-x)
        uv_a, d_a, va = detect_tpu(img, 128)
        uv_b, d_b, vb = detect_tpu(rot, 128)
        idx_b, good, _ = match_descriptors(
            jnp.asarray(d_a), jnp.asarray(va), jnp.asarray(d_b), jnp.asarray(vb)
        )
        good = np.asarray(good)
        idx_b = np.asarray(idx_b)
        assert good.sum() >= 15
        # Matched pairs must be geometrically consistent with the rotation.
        w = img.shape[1]
        ia = np.where(good)[0]
        pred = np.stack([uv_a[ia, 1], w - 1 - uv_a[ia, 0]], -1)  # rotated coords
        err = np.linalg.norm(pred - uv_b[idx_b[ia]], axis=-1)
        assert np.median(err) < 2.0

    def test_descriptors_distinct(self):
        img, _ = _blocky_image(seed=4)
        uv, desc, valid, _ = detect_and_describe(jnp.asarray(img), 128)
        d = np.asarray(desc)[np.asarray(valid)]
        ham = (
            np.unpackbits(d[:, None] ^ d[None, :], axis=-1).sum(-1).astype(int)
        )
        np.fill_diagonal(ham, 999)
        # Different corners should not collide to near-identical descriptors.
        assert np.median(ham.min(1)) > 10


class TestEndToEnd:
    def test_pose_recovery_synthetic_pair(self):
        """Device front-end (tpu detector) → RANSAC recovers the GT pose."""
        from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
        from rgbd_pose_estimation_tpu.data.synthetic import synthetic_sequence
        from rgbd_pose_estimation_tpu.features.frontend import matched_3d3d
        from rgbd_pose_estimation_tpu.ransac.engine import estimate_pose_3d3d
        from rgbd_pose_estimation_tpu.utils.config import RansacConfig

        w, h = 320, 240
        cam = CameraIntrinsics(w * 1.0, w * 1.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
        poses, depths, intens = synthetic_sequence(
            cam, jax.random.key(5), 2, motion_scale=0.01
        )
        p, q = matched_3d3d(
            cam,
            np.asarray(intens[0]),
            np.asarray(depths[0]),
            np.asarray(intens[1]),
            np.asarray(depths[1]),
            detector="tpu",
        )
        assert len(p) >= 30
        res = estimate_pose_3d3d(
            jax.random.key(0),
            jnp.asarray(p),
            jnp.asarray(q),
            RansacConfig(num_hypotheses=512, threshold=0.02),
        )
        T_ab = np.asarray(poses[1] @ np.linalg.inv(poses[0]))
        est = np.asarray(res.pose)
        assert np.abs(est[:3, :3] - T_ab[:3, :3]).max() < 0.02
        assert np.abs(est[:3, 3] - T_ab[:3, 3]).max() < 0.02
