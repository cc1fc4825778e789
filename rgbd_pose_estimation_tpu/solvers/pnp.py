"""N-point PnP: DLT initialization and Gauss-Newton reprojection refinement.

Complements the P3P minimal solver with the overdetermined 2D-3D case the
reference covers via its PnP path (SURVEY.md §2.1). Batched over leading
axes; fixed iteration counts keep everything jit-friendly.

``pnp_refine`` doubles as the reference's "sparse Gauss-Newton refinement"
component (SURVEY.md §2.1): RANSAC hands it an inlier-weighted correspondence
set and an initial pose, it returns the polished pose. Levenberg-Marquardt
damping is folded in (fixed lambda) so near-degenerate inlier sets don't blow
up the 6x6 solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import (
    HIGHEST,
    matmul,
    matrix_to_rt,
    rt_to_matrix,
    se3_exp,
)


def pnp_dlt(points: jnp.ndarray, obs: jnp.ndarray, weights=None):
    """Direct linear transform PnP from normalized image observations.

    Args:
      points: ``(..., N, 3)`` world points, N >= 6.
      obs: ``(..., N, 2)`` normalized image coordinates (x/z, y/z).
      weights: optional ``(..., N)`` weights.

    Returns ``(..., 4, 4)`` world→camera pose. The DLT estimate of [R|t] is
    projected onto SE(3) (SVD orthonormalization with det fix + scale
    recovery, cheirality-corrected sign).
    """
    if weights is None:
        weights = jnp.ones(points.shape[:-1], dtype=points.dtype)
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    one = jnp.ones_like(X)
    zero = jnp.zeros_like(X)
    x, y = obs[..., 0], obs[..., 1]

    # Two rows per correspondence of A p = 0 with p = vec([R|t]) (12 vector).
    row_x = jnp.stack(
        [X, Y, Z, one, zero, zero, zero, zero, -x * X, -x * Y, -x * Z, -x],
        axis=-1,
    )
    row_y = jnp.stack(
        [zero, zero, zero, zero, X, Y, Z, one, -y * X, -y * Y, -y * Z, -y],
        axis=-1,
    )
    A = jnp.concatenate([row_x, row_y], axis=-2)  # (..., 2N, 12)
    w2 = jnp.concatenate([weights, weights], axis=-1)[..., None]
    # Smallest eigenvector of AtA (12x12 symmetric) — batched eigh.
    AtA = jnp.einsum("...ni,...nj->...ij", A * w2, A, precision=HIGHEST)
    _, vecs = jnp.linalg.eigh(AtA)
    p = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue

    M = p.reshape(p.shape[:-1] + (3, 4))

    # The eigenvector sign is arbitrary: pick the sign giving positive mean
    # projective depth (cheirality) *before* orthonormalization.
    z_raw = (
        jnp.einsum("...j,...nj->...n", M[..., 2, :3], points, precision=HIGHEST)
        + M[..., 2:3, 3]
    )
    flip = jnp.where(jnp.mean(z_raw, axis=-1) < 0, -1.0, 1.0)
    M = M * flip[..., None, None]
    R_raw = M[..., :3]
    t_raw = M[..., 3]

    # Project the rotation block onto SO(3) (det-fixed SVD) and recover the
    # common projective scale from the singular values.
    U, S, Vt = jnp.linalg.svd(R_raw)
    scale = jnp.mean(S, axis=-1)
    det = jnp.linalg.det(matmul(U, Vt))
    D = jnp.zeros_like(R_raw).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    D = D.at[..., 2, 2].set(jnp.where(det < 0, -1.0, 1.0))
    R = matmul(matmul(U, D), Vt)
    t = t_raw / jnp.maximum(scale, 1e-12)[..., None]
    return rt_to_matrix(R, t)


def _reproj_residuals(T, points, obs):
    """Per-point normalized-plane reprojection residuals ``(..., N, 2)``."""
    R, t = matrix_to_rt(T)
    Xc = jnp.einsum("...ij,...nj->...ni", R, points, precision=HIGHEST)
    Xc = Xc + t[..., None, :]
    z = jnp.maximum(Xc[..., 2], 1e-6)
    proj = Xc[..., :2] / z[..., None]
    return proj - obs, Xc


def pnp_refine(
    T0: jnp.ndarray,
    points: jnp.ndarray,
    obs: jnp.ndarray,
    weights=None,
    iters: int = 8,
    damping: float = 1e-6,
):
    """Gauss-Newton (LM-damped) refinement of a world→camera pose.

    Minimizes Σ w_i ||π(R X_i + t) − obs_i||² over SE(3), with analytic
    Jacobians and a fixed number of iterations under ``lax.scan`` (static
    trip count → single XLA while-free program, SURVEY.md §2.1 "Sparse
    Gauss-Newton refinement"). Left-multiplicative update: T ← exp(ξ) T.
    """
    if weights is None:
        weights = jnp.ones(points.shape[:-1], dtype=points.dtype)

    def step(T, _):
        r, Xc = _reproj_residuals(T, points, obs)  # (..., N, 2), (..., N, 3)
        x, y_, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        z = jnp.maximum(z, 1e-6)
        iz = 1.0 / z
        iz2 = iz * iz
        # d proj / d Xc  (2x3), then chain with d Xc/d ξ = [I | -[Xc]_x].
        zero = jnp.zeros_like(x)
        # Rows for u = x/z.
        Ju = jnp.stack(
            [
                iz,
                zero,
                -x * iz2,
                -x * y_ * iz2,
                1.0 + x * x * iz2,
                -y_ * iz,
            ],
            axis=-1,
        )
        Jv = jnp.stack(
            [
                zero,
                iz,
                -y_ * iz2,
                -(1.0 + y_ * y_ * iz2),
                x * y_ * iz2,
                x * iz,
            ],
            axis=-1,
        )
        J = jnp.stack([Ju, Jv], axis=-2)  # (..., N, 2, 6)
        w = weights[..., None, None]
        JtJ = jnp.einsum("...nri,...nrj->...ij", J * w, J, precision=HIGHEST)
        Jtr = jnp.einsum("...nri,...nr->...i", J * w, r, precision=HIGHEST)
        H = JtJ + damping * jnp.broadcast_to(
            jnp.eye(6, dtype=JtJ.dtype), JtJ.shape
        )
        delta = -jnp.linalg.solve(H, Jtr[..., None])[..., 0]
        return matmul(se3_exp(delta), T), None

    T, _ = jax.lax.scan(step, T0, None, length=iters)
    return T
