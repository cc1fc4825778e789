"""Batched P3P: camera pose from three 2D-3D correspondences.

TPU-native replacement for the reference's 2D-3D minimal solver (SURVEY.md
§2.1 "P3P / PnP solver"). Uses Grunert's classical reduction (as analyzed in
Haralick et al. 1994, "Review and Analysis of Solutions of the Three Point
Perspective Pose Estimation Problem"): the three law-of-cosines constraints
reduce to a quartic in the ratio of two ray depths, giving up to four pose
solutions.

Design (SURVEY.md hard-part #2):
- the quartic is solved in closed form with masked real-root extraction
  (core/poly.py) — no host branching, so the solver ``vmap``s over thousands
  of RANSAC minimal samples;
- each recovered depth triple yields three camera-frame points; the pose is
  then produced by the 3-point HORN solver (quaternion power iteration,
  matmul/elementwise only) — reusing the 3D-3D fast path. The obvious
  alternative, batched Kabsch, lowers to a batched 3x3 SVD whose XLA
  QR-iteration loop is orders of magnitude slower than Horn per root;
- invalid roots surface as ``valid=False`` with finite dummy poses, so
  downstream scoring simply masks them out.

Conventions: ``rays`` are *unit* bearing vectors in the camera frame,
``points`` are the corresponding 3D world points. The returned pose ``T`` is
world→camera: ``x_cam = R x_world + t``.
"""

from __future__ import annotations

import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import HIGHEST
from rgbd_pose_estimation_tpu.core.poly import solve_quartic_real
from rgbd_pose_estimation_tpu.solvers.absolute_orientation import horn_quaternion


def p3p(points: jnp.ndarray, rays: jnp.ndarray):
    """Solve P3P for ``(..., 3, 3)`` world points and unit rays.

    Returns ``(T, valid)`` where ``T`` is ``(..., 4, 4, 4)`` (up to 4 root
    poses, world→camera) and ``valid`` is ``(..., 4)`` boolean.
    """
    P1, P2, P3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    f1, f2, f3 = rays[..., 0, :], rays[..., 1, :], rays[..., 2, :]

    # Side lengths (opposite the same-numbered vertex) and ray angles.
    a2 = jnp.sum((P2 - P3) ** 2, axis=-1)  # a^2, opposite P1
    b2 = jnp.sum((P1 - P3) ** 2, axis=-1)  # b^2, opposite P2
    c2 = jnp.sum((P1 - P2) ** 2, axis=-1)  # c^2, opposite P3
    cos_a = jnp.sum(f2 * f3, axis=-1)  # angle at the camera subtending a
    cos_b = jnp.sum(f1 * f3, axis=-1)
    cos_c = jnp.sum(f1 * f2, axis=-1)

    b2_safe = jnp.maximum(b2, 1e-12)
    acb = (a2 - c2) / b2_safe  # (a^2 - c^2)/b^2
    apc = (a2 + c2) / b2_safe  # (a^2 + c^2)/b^2
    bc = (b2 - c2) / b2_safe
    ba = (b2 - a2) / b2_safe

    # Grunert quartic in v = s3/s1 (Haralick et al. 1994, Eq. for Grunert).
    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2_safe) * cos_a**2
    A3 = 4.0 * (
        acb * (1.0 - acb) * cos_b
        - (1.0 - apc) * cos_a * cos_c
        + 2.0 * (c2 / b2_safe) * cos_a**2 * cos_b
    )
    A2 = 2.0 * (
        acb**2
        - 1.0
        + 2.0 * acb**2 * cos_b**2
        + 2.0 * bc * cos_a**2
        - 4.0 * apc * cos_a * cos_b * cos_c
        + 2.0 * ba * cos_c**2
    )
    A1 = 4.0 * (
        -acb * (1.0 + acb) * cos_b
        + 2.0 * (a2 / b2_safe) * cos_c**2 * cos_b
        - (1.0 - apc) * cos_a * cos_c
    )
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2_safe) * cos_c**2

    v, v_valid = solve_quartic_real(A4, A3, A2, A1, A0)  # (..., 4)

    # Back-substitute: u = s2/s1 as a rational function of v.
    cos_a_, cos_b_, cos_c_ = (
        cos_a[..., None],
        cos_b[..., None],
        cos_c[..., None],
    )
    acb_ = acb[..., None]
    num = (-1.0 + acb_) * v**2 - 2.0 * acb_ * cos_b_ * v + 1.0 + acb_
    den = 2.0 * (cos_c_ - v * cos_a_)
    den_ok = jnp.abs(den) > 1e-9
    u = num / jnp.where(den_ok, den, 1.0)

    # s1 from the b-equation: s1^2 (1 + v^2 - 2 v cos_b) = b^2.
    s1_den = 1.0 + v * v - 2.0 * v * cos_b_
    s1_ok = s1_den > 1e-9
    s1 = jnp.sqrt(b2_safe[..., None] / jnp.where(s1_ok, s1_den, 1.0))
    s2 = u * s1
    s3 = v * s1

    depths_ok = (s1 > 0) & (s2 > 0) & (s3 > 0)
    valid = v_valid & den_ok & s1_ok & depths_ok

    # Camera-frame points for every root: X_i = s_i * f_i.
    # Shapes: (..., 4 roots, 3 pts, 3).
    Xc = jnp.stack(
        [
            s1[..., None] * f1[..., None, :],
            s2[..., None] * f2[..., None, :],
            s3[..., None] * f3[..., None, :],
        ],
        axis=-2,
    )
    Pw = jnp.broadcast_to(points[..., None, :, :], Xc.shape)

    # World→camera rigid transform per root via 3-point Horn (SVD-free —
    # see the module docstring).
    T = horn_quaternion(Pw, Xc)
    return T, valid


def p3p_best(
    points: jnp.ndarray,
    rays: jnp.ndarray,
    extra_point: jnp.ndarray,
    extra_ray: jnp.ndarray,
):
    """P3P + disambiguation by a fourth correspondence.

    Picks, per problem, the root whose reprojection (angular) error on the
    extra point is smallest. Returns ``(T, valid)`` with ``T`` ``(..., 4, 4)``.
    """
    T, valid = p3p(points, rays)  # (..., 4, 4, 4), (..., 4)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Xc = jnp.einsum("...rij,...j->...ri", R, extra_point, precision=HIGHEST) + t
    Xc_dir = Xc / jnp.maximum(
        jnp.linalg.norm(Xc, axis=-1, keepdims=True), 1e-12
    )
    align = jnp.sum(Xc_dir * extra_ray[..., None, :], axis=-1)
    score = jnp.where(valid, align, -jnp.inf)
    k = jnp.argmax(score, axis=-1)
    onehot = (k[..., None] == jnp.arange(4)).astype(T.dtype)
    T_best = jnp.einsum("...rij,...r->...ij", T, onehot, precision=HIGHEST)
    return T_best, jnp.any(valid, axis=-1)
