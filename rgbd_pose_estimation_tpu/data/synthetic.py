"""Synthetic RGB-D scenes with exact ground truth — the test oracle.

The reference validates on recorded TUM data only; for a hermetic test suite
(SURVEY.md §4.1 "synthetic ground truth is exact") we generate scenes whose
depth is *analytically* raycast (plane + spheres), so every frame, from any
pose, is exact to f32 — no meshes, no assets, no I/O. The same generator
drives kernel parity tests, RANSAC robustness tests, ICP convergence tests
and the odometry/pose-graph integration tests.

Pose convention everywhere: ``T`` maps world → camera (``x_cam = R x_w + t``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics, pixel_grid
from rgbd_pose_estimation_tpu.core.lie import (
    HIGHEST,
    matmul,
    matrix_to_rt,
    se3_apply,
    se3_exp,
)


def synthetic_correspondences(
    key,
    n: int = 512,
    outlier_frac: float = 0.0,
    noise: float = 0.0,
    motion_scale: float = 0.5,
    batch: tuple = (),
):
    """Random 3D-3D correspondence problems with known pose and inlier mask.

    Returns ``(p, q, T_gt, inlier_mask)`` with shapes ``batch + (n, 3)`` etc.
    Outliers replace q with uniform random points in the scene bounding box.
    """
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    p = jax.random.uniform(k1, batch + (n, 3), minval=-1.0, maxval=1.0)
    p = p * jnp.array([2.0, 2.0, 1.0]) + jnp.array([0.0, 0.0, 2.5])
    xi = jax.random.normal(k2, batch + (6,)) * motion_scale
    T = se3_exp(xi)
    q = se3_apply(T, p)
    q = q + noise * jax.random.normal(k3, q.shape)
    out = jax.random.uniform(k4, batch + (n,)) < outlier_frac
    q_out = jax.random.uniform(k5, q.shape, minval=-2.0, maxval=2.0) + jnp.array(
        [0.0, 0.0, 2.5]
    )
    q = jnp.where(out[..., None], q_out, q)
    return p, q, T, ~out


# --- Analytic scene: a back plane plus a few spheres -----------------------

# Scene constants chosen so TUM-like cameras (z forward) see everything.
_PLANE_Z = 3.0
# Plain numpy at module scope: a jnp.array here would initialize the XLA
# backend at IMPORT time, which breaks jax.distributed.initialize() in any
# CLI that merely imports this module. Converted to jnp at first use.
_SPHERES_NP = np.array(
    [
        # cx, cy, cz, r
        [0.0, 0.0, 2.2, 0.5],
        [-0.8, 0.4, 1.8, 0.3],
        [0.7, -0.5, 2.5, 0.4],
        [0.3, 0.6, 1.5, 0.25],
        [-0.5, -0.6, 2.8, 0.35],
    ],
    dtype=np.float32,
)


def _raycast(origins: jnp.ndarray, dirs: jnp.ndarray):
    """Closest hit of rays (o + s*d) against the analytic scene.

    ``dirs`` need not be normalized — the returned s is in units of ``dirs``
    (callers pass unit-z camera rays so s equals camera depth). Shapes:
    origins ``(..., 3)``, dirs ``(..., 3)`` → s ``(...)``, 0 when no hit.
    """
    big = jnp.array(1e9, dirs.dtype)

    # Plane z = _PLANE_Z.
    dz = dirs[..., 2]
    s_plane = (_PLANE_Z - origins[..., 2]) / jnp.where(
        jnp.abs(dz) < 1e-9, 1e-9, dz
    )
    s_plane = jnp.where((s_plane > 0.1) & (jnp.abs(dz) > 1e-9), s_plane, big)

    # Spheres: ||o + s d - c||^2 = r^2.
    spheres = jnp.asarray(_SPHERES_NP)
    oc = origins[..., None, :] - spheres[:, :3]  # (..., S, 3)
    d = dirs[..., None, :]
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - spheres[:, 3] ** 2
    disc = b * b - 4.0 * a * c
    ok = disc > 0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s0 = (-b - sq) / (2.0 * a)
    s1 = (-b + sq) / (2.0 * a)
    s_sph = jnp.where(s0 > 0.1, s0, jnp.where(s1 > 0.1, s1, big))
    s_sph = jnp.where(ok, s_sph, big)
    s_sph = jnp.min(s_sph, axis=-1)

    s = jnp.minimum(s_plane, s_sph)
    return jnp.where(s < big * 0.5, s, 0.0)


def _hash_noise(ix: jnp.ndarray, iy: jnp.ndarray, iz: jnp.ndarray) -> jnp.ndarray:
    """Deterministic integer-lattice hash → [0, 1) (value noise, sharp)."""
    h = ix * 374761393 + iy * 668265263 + iz * 2147483647
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).astype(jnp.float32) / 65535.0


def _texture(points: jnp.ndarray) -> jnp.ndarray:
    """Procedural grayscale texture with sharp, corner-rich detail.

    A blocky value-noise (piecewise-constant on a ~2.5 cm lattice) layered
    over low-frequency shading: the hard block edges give FAST/ORB dense,
    well-localized corners — smooth sinusoid textures starve the sparse
    front-end of keypoints.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    ix = jnp.floor(x * 40.0).astype(jnp.int32)
    iy = jnp.floor(y * 40.0).astype(jnp.int32)
    iz = jnp.floor(z * 40.0).astype(jnp.int32)
    blocks = _hash_noise(ix, iy, iz)
    coarse = _hash_noise(ix >> 3, iy >> 3, iz >> 3)
    v = 0.15 + 0.45 * blocks + 0.3 * coarse + 0.1 * jnp.sin(7.1 * x) * jnp.cos(5.3 * y)
    return jnp.clip(v, 0.0, 1.0)


def synthetic_depth_scene(cam: CameraIntrinsics, T_wc: jnp.ndarray):
    """Render (depth, intensity) of the analytic scene from pose ``T_wc``.

    ``T_wc`` is world→camera ``(4, 4)``. Depth is metric, 0 where no surface
    is hit; intensity is a procedural texture evaluated at the hit points.
    Fully jit-able; used inside vmapped sequence generation.
    """
    R, t = matrix_to_rt(T_wc)
    center = -jnp.einsum("ji,j->i", R, t, precision=HIGHEST)  # camera center in world
    uv = pixel_grid(cam)
    d_cam = jnp.stack(
        [
            (uv[..., 0] - cam.cx) / cam.fx,
            (uv[..., 1] - cam.cy) / cam.fy,
            jnp.ones_like(uv[..., 0]),
        ],
        axis=-1,
    )  # unit-z rays: ray parameter == camera depth
    d_world = jnp.einsum("ji,hwj->hwi", R, d_cam, precision=HIGHEST)
    origins = jnp.broadcast_to(center, d_world.shape)
    depth = _raycast(origins, d_world)
    hits = origins + depth[..., None] * d_world
    # The plane z = 3.0 lies exactly on a texture-lattice boundary (z * 40 =
    # 120): snap its hits to the plane, or rounding (which differs between
    # backends, e.g. fused multiply-adds on a GPU) flips the lattice cell
    # pixel by pixel and the texture turns into view-dependent noise.
    on_plane = jnp.abs(hits[..., 2] - _PLANE_Z) < 1e-4
    hits = hits.at[..., 2].set(jnp.where(on_plane, _PLANE_Z, hits[..., 2]))
    intensity = jnp.where(depth > 0, _texture(hits), 0.0)
    return depth, intensity


# --- Kinect-realistic degradation (round-2 verdict item 2) ------------------
#
# The easy-regime tests use clean analytic depth; TUM fr1/desk is fast
# handheld motion with structured-light depth whose error model is well
# documented (Khoshelham & Elberink 2012): quadratic-in-z random error,
# disparity-step quantization, and missing data at depth edges / borders.


def kinect_degrade(
    key,
    depth: jnp.ndarray,
    noise_coeff: float = 1.425e-3,  # sigma_z = coeff * z^2 (K&E 2012)
    edge_gap: float = 0.04,  # occlusion-shadow holes at jumps > this (m)
    dropout_frac: float = 0.02,  # random speckle dropout blobs
    border: int = 8,  # invalid border band (px)
    f_times_b: float = 348.0,  # focal(580 px) * baseline(0.075 m) * 8 sub-steps
):
    """Degrade an analytic depth map with a Kinect-style sensor model.

    Applied per frame: (1) quadratic-in-z Gaussian noise, (2) disparity
    quantization (the Kinect measures 1/8-pixel disparity d = f·b/z, so
    depth resolution degrades as z²) plus the TUM PNG's 1/5000 m storage
    quantization, (3) holes: occlusion shadows at depth discontinuities,
    random speckle dropout, and an invalid border band. Returns depth with
    0 = invalid, like real TUM frames.
    """
    k1, k2 = jax.random.split(key)
    valid = depth > 0

    # (1) quadratic-in-z noise.
    z = depth + noise_coeff * depth * depth * jax.random.normal(k1, depth.shape)
    z = jnp.maximum(z, 0.0)

    # (2) disparity quantization then PNG quantization.
    disp = f_times_b / jnp.maximum(z, 1e-3)
    z = f_times_b / jnp.maximum(jnp.round(disp), 1.0)
    z = jnp.round(z * 5000.0) / 5000.0

    # (3a) occlusion shadows: a structured-light sensor loses the pixels
    # just past a depth jump (projector shadow). Flag pixels whose left/up
    # neighbor is much closer.
    dl = jnp.abs(jnp.diff(depth, axis=1, prepend=depth[:, :1]))
    du = jnp.abs(jnp.diff(depth, axis=0, prepend=depth[:1]))
    shadow = (dl > edge_gap) | (du > edge_gap)

    # (3b) blobby speckle dropout: threshold low-res value noise so holes
    # come in contiguous chunks (like real specular/absorbing surfaces).
    h, w = depth.shape
    gy = (jnp.arange(h)[:, None] // 4) * jnp.ones((1, w), jnp.int32)
    gx = jnp.ones((h, 1), jnp.int32) * (jnp.arange(w)[None, :] // 4)
    seed = jax.random.randint(k2, (), 0, 1 << 30)
    blob = _hash_noise(gx, gy, seed * jnp.ones_like(gx)) < dropout_frac

    # (3c) border band.
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    in_border = (
        (row < border) | (row >= h - border) | (col < border) | (col >= w - border)
    )

    keep = valid & ~shadow & ~blob & ~in_border
    return jnp.where(keep, z, 0.0)


def handheld_trajectory(key, n_frames: int, trans_scale=0.03, rot_scale=0.025):
    """fr1/desk-like handheld motion: ~2–4 cm and ~1–2°/frame, smoothed.

    Returns (F, 4, 4) world→camera poses starting at identity.
    """
    deltas = jax.random.normal(key, (n_frames, 6))
    deltas = deltas * jnp.concatenate(
        [jnp.full(3, trans_scale), jnp.full(3, rot_scale)]
    )

    def smooth(carry, d):
        v = 0.7 * carry + 0.3 * d
        return v, v

    _, vels = jax.lax.scan(smooth, jnp.zeros(6), deltas)

    def step(T, v):
        T_next = matmul(se3_exp(v), T)
        return T_next, T_next

    T0 = jnp.eye(4)
    _, poses = jax.lax.scan(step, T0, vels)
    return jnp.concatenate([T0[None], poses[:-1]], axis=0)


def synthetic_sequence_hard(
    cam: CameraIntrinsics,
    key,
    n_frames: int,
    trans_scale: float = 0.03,
    rot_scale: float = 0.025,
    **degrade_kwargs,
):
    """Hard-mode synthetic TUM: handheld motion + Kinect sensor model.

    The gate standing in for the unobtainable fr1/desk run (BASELINE.json:2
    metric of record; no dataset on disk, no network — SURVEY.md §0):
    same motion statistics, quantized/noisy/holey depth. Returns
    ``(poses, depths_degraded, intensities, depths_clean)``.
    """
    k_traj, k_deg = jax.random.split(key)
    poses = handheld_trajectory(k_traj, n_frames, trans_scale, rot_scale)
    render = jax.vmap(lambda T: synthetic_depth_scene(cam, T))
    depths_clean, intensities = render(poses)
    keys = jax.random.split(k_deg, n_frames)
    degrade = jax.vmap(lambda k, d: kinect_degrade(k, d, **degrade_kwargs))
    depths = degrade(keys, depths_clean)
    return poses, depths, intensities, depths_clean


def synthetic_sequence(
    cam: CameraIntrinsics, key, n_frames: int, motion_scale: float = 0.02
):
    """A smooth random camera trajectory + rendered (depth, intensity) frames.

    Returns ``(poses, depths, intensities)`` with poses ``(F, 4, 4)``
    (world→camera). Motion is a random walk in the tangent space, smoothed,
    so consecutive frames overlap heavily — the regime dense ICP assumes.
    """
    deltas = jax.random.normal(key, (n_frames, 6)) * motion_scale
    # Exponential smoothing for physically-plausible motion.
    def smooth(carry, d):
        v = 0.8 * carry + 0.2 * d
        return v, v

    _, vels = jax.lax.scan(smooth, jnp.zeros(6), deltas)

    def step(T, v):
        T_next = matmul(se3_exp(v), T)
        return T_next, T_next

    T0 = jnp.eye(4)
    _, poses = jax.lax.scan(step, T0, vels)
    poses = jnp.concatenate([T0[None], poses[:-1]], axis=0)

    render = jax.vmap(lambda T: synthetic_depth_scene(cam, T))
    depths, intensities = render(poses)
    return poses, depths, intensities
