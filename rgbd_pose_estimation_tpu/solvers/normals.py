"""Point+normal reduced-sample minimal solvers (SURVEY.md §2.1).

Surface normals add two rotational constraints per correspondence, so the
minimal sample for a rigid transform shrinks from 3 points to 2 — and
RANSAC's cost to find an uncontaminated sample drops from O(1/w³) to
O(1/w²) at inlier ratio w. With 1 point + its normal the pose is determined
up to the yaw about the normal; we emit a small fan of yaw hypotheses and
let the scoring kernel disambiguate (the same all-roots-as-hypotheses
pattern the P3P path uses — TPU-friendly: no per-sample iteration).

All solvers are pure batched jnp over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import (
    HIGHEST,
    matmul,
    rt_to_matrix,
    so3_exp,
)


def procrustes_rotation(vp: jnp.ndarray, vq: jnp.ndarray, weights=None) -> jnp.ndarray:
    """Best rotation R with vq_i ≈ R vp_i (no centroiding — directions).

    ``vp``/``vq`` are ``(..., M, 3)`` direction sets. Solved via the
    quaternion Horn path (solvers/absolute_orientation.py::
    horn_rotation_directions): mathematically the same optimum as SVD
    Procrustes restricted to proper rotations, but SVD-free: XLA lowers a
    batched 3x3 SVD to an iterative loop, far slower than the quaternion
    power iteration on the K-hypothesis RANSAC path.
    """
    from rgbd_pose_estimation_tpu.solvers.absolute_orientation import (
        horn_rotation_directions,
    )

    return horn_rotation_directions(vp, vq, weights)


def ao_2pt_normals(p: jnp.ndarray, q: jnp.ndarray, np_: jnp.ndarray, nq: jnp.ndarray):
    """Rigid pose from TWO point+normal correspondences.

    Args: ``p``/``q`` ``(..., 2, 3)`` points, ``np_``/``nq`` ``(..., 2, 3)``
    unit normals, with q ≈ R p + t and nq ≈ R np_.
    The rotation aligns the direction triplet {p2-p1, n1, n2}; the
    translation matches centroids. Returns ``(..., 4, 4)``.
    """
    dp = p[..., 1, :] - p[..., 0, :]
    dq = q[..., 1, :] - q[..., 0, :]
    dp = dp / jnp.maximum(jnp.linalg.norm(dp, axis=-1, keepdims=True), 1e-9)
    dq = dq / jnp.maximum(jnp.linalg.norm(dq, axis=-1, keepdims=True), 1e-9)
    vp = jnp.stack([dp, np_[..., 0, :], np_[..., 1, :]], axis=-2)
    vq = jnp.stack([dq, nq[..., 0, :], nq[..., 1, :]], axis=-2)
    R = procrustes_rotation(vp, vq)
    cp = jnp.mean(p, axis=-2)
    cq = jnp.mean(q, axis=-2)
    t = cq - jnp.einsum("...ij,...j->...i", R, cp, precision=HIGHEST)
    return rt_to_matrix(R, t)


def ao_1pt_normal_fan(
    p: jnp.ndarray, q: jnp.ndarray, np_: jnp.ndarray, nq: jnp.ndarray,
    num_yaw: int = 8,
):
    """Pose family from ONE point+normal correspondence.

    Aligning n_p to n_q leaves one free rotation about n_q; returns
    ``num_yaw`` hypotheses sampling that circle uniformly —
    ``(..., num_yaw, 4, 4)``. Downstream MSAC scoring picks the yaw (and
    usually kills the whole sample unless the scene is normal-degenerate).
    """
    np_u = np_ / jnp.maximum(jnp.linalg.norm(np_, axis=-1, keepdims=True), 1e-9)
    nq_u = nq / jnp.maximum(jnp.linalg.norm(nq, axis=-1, keepdims=True), 1e-9)
    # Minimal rotation taking np_u to nq_u (axis = np x nq).
    axis = jnp.cross(np_u, nq_u)
    s = jnp.linalg.norm(axis, axis=-1)
    c = jnp.sum(np_u * nq_u, axis=-1)
    angle = jnp.arctan2(s, c)
    axis_u = axis / jnp.maximum(s[..., None], 1e-9)
    # Antiparallel fallback: any axis orthogonal to np_u.
    ortho = jnp.cross(np_u, jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], np_.dtype), np_u.shape))
    ortho_n = jnp.linalg.norm(ortho, axis=-1, keepdims=True)
    ortho2 = jnp.cross(np_u, jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], np_.dtype), np_u.shape))
    ortho = jnp.where(ortho_n > 1e-6, ortho, ortho2)
    ortho = ortho / jnp.maximum(jnp.linalg.norm(ortho, axis=-1, keepdims=True), 1e-9)
    axis_u = jnp.where(s[..., None] > 1e-6, axis_u, ortho)
    R0 = so3_exp(axis_u * angle[..., None])

    yaw = jnp.arange(num_yaw, dtype=p.dtype) * (2.0 * jnp.pi / num_yaw)
    # Rotation about nq_u by each yaw, composed after the alignment.
    w = nq_u[..., None, :] * yaw[:, None]  # (..., num_yaw, 3)
    Ry = so3_exp(w)
    R = matmul(Ry, R0[..., None, :, :])
    t = q[..., None, :] - jnp.einsum("...yij,...j->...yi", R, p, precision=HIGHEST)
    return rt_to_matrix(R, t)
