"""Sparse feature front-end: host ORB detection, on-device matching.

The reference uses OpenCV ORB + BFMatcher on the CPU (SURVEY.md §2.1
"Feature detect/match front-end"). Here detection/description stays on the
host (OpenCV, like the reference — it is pure image processing, cheap and
latency-tolerant), but matching moves on-device: the full Hamming distance
matrix is one vectorized xor+popcount reduction, the ratio test a ``top_k``
— batched, jit-compiled, and feeding PROSAC its quality ordering directly.

Static-shape contract: keypoint arrays are always padded to ``max_features``
with a validity mask, so downstream jit programs never retrace.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics


def detect_orb(gray: np.ndarray, max_features: int = 512):
    """Detect ORB keypoints/descriptors on the host.

    Args: ``gray`` float32 (H, W) in [0,1]. Returns ``(uv (M, 2) f32,
    desc (M, 32) u8, valid (M,) bool)`` padded to ``max_features``.
    Needs OpenCV; ``detector="tpu"`` (features/tpu_detect.py) does not.
    """
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the 'orb' detector needs OpenCV (cv2), which is not installed; "
            "use the on-device detector instead (--detector tpu)"
        ) from e

    img8 = (np.clip(np.asarray(gray), 0, 1) * 255).astype(np.uint8)
    orb = cv2.ORB_create(nfeatures=max_features)
    kps, desc = orb.detectAndCompute(img8, None)
    uv = np.zeros((max_features, 2), np.float32)
    d = np.zeros((max_features, 32), np.uint8)
    valid = np.zeros(max_features, bool)
    if kps:
        m = min(len(kps), max_features)
        uv[:m] = np.asarray([k.pt for k in kps[:m]], np.float32)
        d[:m] = desc[:m]
        valid[:m] = True
    return uv, d, valid


@jax.jit
def match_descriptors(desc_a, valid_a, desc_b, valid_b, ratio: float = 0.8):
    """Mutual-best Hamming matching with Lowe ratio test, fully on-device.

    Args: ``desc_* (M, 32) uint8``, ``valid_* (M,) bool``.
    Returns ``(idx_b (M,), good (M,), quality (M,))`` — for each keypoint in
    A its best match in B, whether it passed ratio + mutual-best + validity,
    and a quality score (higher = more distinctive) for PROSAC ordering.
    """
    xa = desc_a[:, None, :] ^ desc_b[None, :, :]  # (Ma, Mb, 32)
    ham = jnp.sum(jax.lax.population_count(xa), axis=-1).astype(jnp.float32)
    big = 1e9
    ham = jnp.where(valid_a[:, None] & valid_b[None, :], ham, big)

    # Best and second best distance in B for each A.
    neg2, idx2 = jax.lax.top_k(-ham, 2)
    best, second = -neg2[:, 0], -neg2[:, 1]
    idx_b = idx2[:, 0]
    passes_ratio = best < ratio * jnp.maximum(second, 1e-6)

    # Mutual best: A must also be B's best.
    best_a_for_b = jnp.argmin(ham, axis=0)  # (Mb,)
    mutual = best_a_for_b[idx_b] == jnp.arange(ham.shape[0])

    good = passes_ratio & mutual & valid_a & (best < big * 0.5)
    quality = jnp.where(good, second / jnp.maximum(best, 1.0), 0.0)
    return idx_b, good, quality


def _detect(gray, max_features: int, detector: str):
    """Dispatch: ``"orb"`` = host OpenCV (reference parity), ``"tpu"`` =
    on-device FAST+BRIEF (features/tpu_detect.py), same output contract."""
    if detector == "tpu":
        from rgbd_pose_estimation_tpu.features.tpu_detect import detect_tpu

        return detect_tpu(gray, max_features)
    return detect_orb(gray, max_features)


def _depth_at(depth: np.ndarray, uv: np.ndarray):
    u = np.clip(np.round(uv[:, 0]).astype(int), 0, depth.shape[1] - 1)
    v = np.clip(np.round(uv[:, 1]).astype(int), 0, depth.shape[0] - 1)
    return depth[v, u]


def _sorted_by_quality(quality, good):
    order = np.argsort(-np.asarray(quality))
    keep = np.asarray(good)[order]
    return order[keep]


def matched_3d3d(cam: CameraIntrinsics, gray_a, depth_a, gray_b, depth_b,
                 max_features: int = 512, detector: str = "orb"):
    """Full front-end for the 3D-3D path: ``(p, q)`` quality-sorted numpy.

    Back-projects matched keypoints through both depth maps; matches whose
    depth is invalid in either frame are dropped. Output order is PROSAC's
    descending-quality order (SURVEY.md §3.1 call stack).
    """
    uv_a, d_a, va = _detect(gray_a, max_features, detector)
    uv_b, d_b, vb = _detect(gray_b, max_features, detector)
    idx_b, good, quality = match_descriptors(
        jnp.asarray(d_a), jnp.asarray(va), jnp.asarray(d_b), jnp.asarray(vb)
    )
    order = _sorted_by_quality(quality, good)
    ia = order
    ib = np.asarray(idx_b)[order]
    za = _depth_at(depth_a, uv_a[ia])
    zb = _depth_at(depth_b, uv_b[ib])
    ok = (za > 0) & (zb > 0)
    ia, ib, za, zb = ia[ok], ib[ok], za[ok], zb[ok]
    p = np.stack(
        [
            (uv_a[ia, 0] - cam.cx) / cam.fx * za,
            (uv_a[ia, 1] - cam.cy) / cam.fy * za,
            za,
        ],
        axis=-1,
    )
    q = np.stack(
        [
            (uv_b[ib, 0] - cam.cx) / cam.fx * zb,
            (uv_b[ib, 1] - cam.cy) / cam.fy * zb,
            zb,
        ],
        axis=-1,
    )
    return p.astype(np.float32), q.astype(np.float32)


def matched_2d3d(cam: CameraIntrinsics, gray_a, depth_a, gray_b,
                 max_features: int = 512, detector: str = "orb"):
    """Front-end for the 2D-3D (PnP) path: 3D points in frame A's camera
    frame + normalized observations in frame B, quality-sorted."""
    uv_a, d_a, va = _detect(gray_a, max_features, detector)
    uv_b, d_b, vb = _detect(gray_b, max_features, detector)
    idx_b, good, quality = match_descriptors(
        jnp.asarray(d_a), jnp.asarray(va), jnp.asarray(d_b), jnp.asarray(vb)
    )
    order = _sorted_by_quality(quality, good)
    ia = order
    ib = np.asarray(idx_b)[order]
    za = _depth_at(depth_a, uv_a[ia])
    ok = za > 0
    ia, ib, za = ia[ok], ib[ok], za[ok]
    pts = np.stack(
        [
            (uv_a[ia, 0] - cam.cx) / cam.fx * za,
            (uv_a[ia, 1] - cam.cy) / cam.fy * za,
            za,
        ],
        axis=-1,
    )
    obs = np.stack(
        [
            (uv_b[ib, 0] - cam.cx) / cam.fx,
            (uv_b[ib, 1] - cam.cy) / cam.fy,
        ],
        axis=-1,
    )
    return pts.astype(np.float32), obs.astype(np.float32)
