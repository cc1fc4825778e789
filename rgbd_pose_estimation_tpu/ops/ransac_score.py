"""RANSAC hypothesis scoring: K poses against N correspondences at once.

This is hot loop #1 (SURVEY.md §3.1): the reference scores hypotheses in a
serial CPU loop with early exit; here a K-sized batch of poses is scored
against all N correspondences and each pose reduces to an MSAC score
``Σ min(e, τ²)`` and an inlier count ``Σ [e < τ²]``.

The scorers are plain jnp: twelve ``(K, 1)`` pose columns broadcast
against ``(1, N)`` point rows, then min/compare and a row sum. XLA fuses
the elementwise chain into the row reduction, so the ``(K, N)`` residual
matrix never reaches device memory. (On the H100 this form beat a
Pallas-Triton kernel and a bf16 quadratic-form ranking; see PERF.md.)

``*_reference`` are independent einsum forms at ``HIGHEST`` precision that
materialize ``(K, N, 3)``: the test oracles, never a production path.

Poses are ``(K, 4, 4)`` matrices or packed ``(K, 12)`` rows
(:func:`pack_poses`). N needs no padding: every form handles any N.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import HIGHEST


def pack_poses(T: jnp.ndarray) -> jnp.ndarray:
    """``(K, 4, 4)`` poses → ``(K, 12)`` [9 rotation row-major, 3 translation]."""
    K = T.shape[0]
    return jnp.concatenate(
        [T[:, :3, :3].reshape(K, 9), T[:, :3, 3]], axis=-1
    )


def unpack_pose(row: jnp.ndarray) -> jnp.ndarray:
    """One ``(12,)`` packed pose row → ``(4, 4)`` homogeneous matrix."""
    return (
        jnp.eye(4, dtype=row.dtype)
        .at[:3, :3].set(row[:9].reshape(3, 3))
        .at[:3, 3].set(row[9:12])
    )


def _packed(T: jnp.ndarray) -> jnp.ndarray:
    return T if T.ndim == 2 else pack_poses(T)


def _rotate(c, x, y, z):
    """``R p + t`` per component from 12 pose columns and point rows."""
    return (
        c[0] * x + c[1] * y + c[2] * z + c[9],
        c[3] * x + c[4] * y + c[5] * z + c[10],
        c[6] * x + c[7] * y + c[8] * z + c[11],
    )


def _msac_and_count(e, tau2):
    return (
        jnp.sum(jnp.minimum(e, tau2), axis=-1),
        jnp.sum((e < tau2).astype(jnp.float32), axis=-1),
    )


def _residual_3d3d(c, p, q):
    ex, ey, ez = _rotate(c, p[0], p[1], p[2])
    ex, ey, ez = ex - q[0], ey - q[1], ez - q[2]
    return ex * ex + ey * ey + ez * ez


def _residual_2d3d(c, x, o, *, tau2):
    cx, cy, cz = _rotate(c, x[0], x[1], x[2])
    behind = cz < 1e-6
    iz = 1.0 / jnp.where(behind, 1.0, cz)
    du = cx * iz - o[0]
    dv = cy * iz - o[1]
    # Points behind the camera are outliers.
    return jnp.where(behind, 4.0 * tau2, du * du + dv * dv)


def _score(residual, T, pts, other, tau2):
    P = _packed(T)
    cols = [P[:, i : i + 1] for i in range(12)]  # (K, 1) each
    rows_a = [pts[None, :, i] for i in range(3)]  # (1, N) each
    rows_b = [other[None, :, i] for i in range(other.shape[1])]
    return _msac_and_count(residual(cols, rows_a, rows_b), tau2)


# --------------------------------------------------------------------------
# 3D-3D scoring: residual = ||R p + t - q||
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("threshold",))
def score_poses_3d3d(
    T: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray, threshold: float
):
    """Score K poses against N 3D-3D correspondences.

    Args: T ``(K, 4, 4)`` or ``(K, 12)``, p/q ``(N, 3)``. Returns
    ``(msac_score, inlier_count)`` both ``(K,)`` f32.
    """
    return _score(_residual_3d3d, T, p, q, threshold * threshold)


def score_poses_3d3d_reference(T, p, q, threshold: float):
    """Oracle for :func:`score_poses_3d3d`: einsum at HIGHEST precision."""
    P = _packed(T)
    R = P[:, :9].reshape(-1, 3, 3)
    t = P[:, 9:12]
    pred = jnp.einsum("kij,nj->kni", R, p, precision=HIGHEST) + t[:, None, :]
    e = jnp.sum((pred - q[None]) ** 2, axis=-1)  # (K, N)
    return _msac_and_count(e, threshold * threshold)


@functools.partial(jax.jit, static_argnames=("threshold", "return_pose"))
def best_pose_3d3d(T, p, q, threshold: float, return_pose: bool = False):
    """Select the best of K poses by MSAC score.

    NaN scores (degenerate minimal sets) rank last. Returns
    ``(best_index, best_msac)``, plus the winning ``(4, 4)`` pose when
    ``return_pose=True``.
    """
    msac, _ = score_poses_3d3d(T, p, q, threshold)
    msac = jnp.where(jnp.isnan(msac), jnp.inf, msac)
    best = jnp.argmin(msac)
    return (best, msac[best], T[best]) if return_pose else (best, msac[best])


# --------------------------------------------------------------------------
# 2D-3D scoring: residual = || proj(R X + t) - obs ||  (normalized plane)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("threshold",))
def score_poses_2d3d(
    T: jnp.ndarray, points: jnp.ndarray, obs: jnp.ndarray, threshold: float
):
    """Score K world→camera poses against N (3D point, normalized-2D) pairs.

    Args: T ``(K, 4, 4)`` or packed ``(K, 12)`` rows, ``points`` ``(N, 3)``,
    ``obs`` ``(N, 2)``. Returns ``(msac_score, inlier_count)`` both
    ``(K,)`` f32. Points behind the camera are treated as outliers.
    """
    tau2 = threshold * threshold
    residual = functools.partial(_residual_2d3d, tau2=tau2)
    return _score(residual, T, points, obs, tau2)


def score_poses_2d3d_reference(T, points, obs, threshold: float):
    """Oracle for :func:`score_poses_2d3d`: einsum at HIGHEST precision."""
    P = _packed(T)
    R = P[:, :9].reshape(-1, 3, 3)
    t = P[:, 9:12]
    Xc = jnp.einsum("kij,nj->kni", R, points, precision=HIGHEST) + t[:, None, :]
    z = Xc[..., 2]
    behind = z < 1e-6
    proj = Xc[..., :2] / jnp.where(behind, 1.0, z)[..., None]
    e = jnp.sum((proj - obs[None]) ** 2, axis=-1)
    tau2 = threshold * threshold
    e = jnp.where(behind, 4.0 * tau2, e)
    return _msac_and_count(e, tau2)
