"""Batched SO(3)/SE(3) Lie-group operations in pure JAX.

Replacement for the reference's Eigen geometry core (SURVEY.md L0:
``Matrix3/Vector3/Quaterniond`` + SO(3)/SE(3) ops). Everything here:

- is batched over arbitrary leading axes (``...`` in shapes);
- is float32-safe: small-angle Taylor fallbacks everywhere a ``sin(x)/x``-style
  ratio appears, so gradients and values are finite at the identity;
- contains no Python branching on traced values — only ``jnp.where`` masks —
  so it jits, vmaps and shards cleanly.

Poses are canonically 4x4 homogeneous matrices (``(..., 4, 4)``): composition
is then a plain matmul. ``(R, t)`` accessors are provided for code that wants
the split form.

Every matrix product here, and every geometric product in the package, runs
at ``HIGHEST`` precision: on a GPU a DEFAULT-precision f32 matmul may run in
TF32 (about three decimal digits), which drifts chained poses and moves
inlier decisions, and these products are far too small for TF32 to save
time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

# Below this angle (radians) we switch to Taylor expansions of the
# trigonometric ratios; 1e-4 keeps full f32 accuracy on both branches.
_SMALL_ANGLE = 1e-4


def matmul(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """``A @ B`` at full f32 precision (see the module docstring)."""
    return jnp.matmul(A, B, precision=HIGHEST)


def so3_hat(w: jnp.ndarray) -> jnp.ndarray:
    """Map ``(..., 3)`` axis-angle vectors to ``(..., 3, 3)`` skew matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`so3_hat`: ``(..., 3, 3)`` skew → ``(..., 3)``."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc(theta: jnp.ndarray) -> jnp.ndarray:
    """sin(t)/t with Taylor fallback (1 - t^2/6) near zero."""
    small = theta < _SMALL_ANGLE
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    return jnp.where(small, 1.0 - theta * theta / 6.0, jnp.sin(safe) / safe)


def _cosc(theta: jnp.ndarray) -> jnp.ndarray:
    """(1 - cos(t))/t^2 with Taylor fallback (1/2 - t^2/24) near zero."""
    small = theta < _SMALL_ANGLE
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    return jnp.where(
        small, 0.5 - theta * theta / 24.0, (1.0 - jnp.cos(safe)) / (safe * safe)
    )


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula: ``(..., 3)`` tangent → ``(..., 3, 3)`` rotation."""
    theta = jnp.linalg.norm(w, axis=-1)
    W = so3_hat(w)
    W2 = matmul(W, W)
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix → axis-angle, safe near 0 and near pi.

    Near theta = pi the standard ``vee(R - R^T)/(2 sinc)`` formula loses the
    axis; we recover it from the diagonal of ``R + I`` (whose columns are
    proportional to the axis outer product) and fix signs from the off-diagonal.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)

    # Generic branch: w = theta/(2 sin(theta)) * vee(R - R^T).
    vee = so3_vee(R - jnp.swapaxes(R, -1, -2))
    generic = 0.5 / _sinc(theta)[..., None] * vee

    # Near-pi branch: axis from the largest diagonal of B = (R + I)/2;
    # B = axis axis^T when theta == pi exactly.
    B = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    # Take column k of B and normalize; gather via one-hot to stay batched.
    onehot = jax_one_hot(k, 3, R.dtype)
    col = jnp.einsum("...ij,...j->...i", B, onehot, precision=HIGHEST)
    axis = col / jnp.maximum(jnp.linalg.norm(col, axis=-1, keepdims=True), 1e-12)
    # Sign: make axis agree with vee(R - R^T) when that is nonzero.
    sign = jnp.where(
        jnp.sum(axis * vee, axis=-1, keepdims=True) < 0.0, -1.0, 1.0
    )
    near_pi = (axis * sign) * theta[..., None]

    use_pi = (jnp.pi - theta) < 1e-3
    return jnp.where(use_pi[..., None], near_pi, generic)


def jax_one_hot(idx: jnp.ndarray, n: int, dtype) -> jnp.ndarray:
    """Tiny one-hot helper (avoids importing jax.nn for a single call)."""
    return (idx[..., None] == jnp.arange(n)).astype(dtype)


def _left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V(w): translation part of the SE(3) exponential."""
    theta = jnp.linalg.norm(w, axis=-1)
    W = so3_hat(w)
    W2 = matmul(W, W)
    b = _cosc(theta)[..., None, None]
    # (theta - sin theta)/theta^3 with Taylor fallback 1/6 - t^2/120.
    small = theta < _SMALL_ANGLE
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    c = jnp.where(
        small,
        1.0 / 6.0 - theta * theta / 120.0,
        (safe - jnp.sin(safe)) / (safe * safe * safe),
    )[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b * W + c * W2


def _left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta = jnp.linalg.norm(w, axis=-1)
    W = so3_hat(w)
    W2 = matmul(W, W)
    small = theta < _SMALL_ANGLE
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    half = safe * 0.5
    # (1/theta^2) (1 - theta sin / (2 (1 - cos))) = (1 - half*cot(half))/theta^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / (safe * safe),
    )[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_term * W2


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exponential: ``(..., 6)`` twist [v, w] → ``(..., 4, 4)`` pose.

    Convention: ``xi[..., :3]`` is the translational part v, ``xi[..., 3:]``
    the rotational part w, matching the Jacobians used in ``icp`` and ``graph``.
    """
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = jnp.einsum("...ij,...j->...i", _left_jacobian(w), v, precision=HIGHEST)
    return rt_to_matrix(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) logarithm: ``(..., 4, 4)`` pose → ``(..., 6)`` twist [v, w]."""
    R, t = matrix_to_rt(T)
    w = so3_log(R)
    v = jnp.einsum("...ij,...j->...i", _left_jacobian_inv(w), t, precision=HIGHEST)
    return jnp.concatenate([v, w], axis=-1)


def rt_to_matrix(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Pack ``(..., 3, 3)`` + ``(..., 3)`` into ``(..., 4, 4)`` homogeneous."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def matrix_to_rt(T: jnp.ndarray):
    """Split ``(..., 4, 4)`` homogeneous pose into ``(R, t)``."""
    return T[..., :3, :3], T[..., :3, 3]


def se3_matrix(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:  # alias
    return rt_to_matrix(R, t)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a rigid transform without a general 4x4 solve."""
    R, t = matrix_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    Rt_t = jnp.einsum("...ij,...j->...i", Rt, t, precision=HIGHEST)
    return rt_to_matrix(Rt, -Rt_t)


def se3_compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B — spelled out so intent is greppable at call sites."""
    return matmul(A, B)


def se3_apply(T: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply ``(..., 4, 4)`` pose(s) to ``(..., N, 3)`` points."""
    R, t = matrix_to_rt(T)
    Rp = jnp.einsum("...ij,...nj->...ni", R, points, precision=HIGHEST)
    return Rp + t[..., None, :]


def se3_adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of SE(3) for twist order [v, w]: ``(..., 6, 6)``.

    Satisfies ``T exp(xi^) T^-1 = exp((Ad_T xi)^)``:
    ``Ad = [[R, [t]x R], [0, R]]``.
    """
    R, t = matrix_to_rt(T)
    tx = so3_hat(t)
    top = jnp.concatenate([R, matmul(tx, R)], axis=-1)
    bottom = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion ``(..., 4)`` in (w, x, y, z) order → rotation matrix."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z), branchless.

    Computes all four of Shepperd's candidate solutions (one per largest
    element of the quaternion) and selects by mask — no host branching, so it
    batches/vmaps. Each candidate is scaled so the shared element is the
    squared magnitude; normalization at the end removes the scale.
    """
    m = R
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]

    # Candidate built around w being largest.
    qw0 = jnp.stack(
        [
            1.0 + t,
            m[..., 2, 1] - m[..., 1, 2],
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 1, 0] - m[..., 0, 1],
        ],
        axis=-1,
    )
    # Around x largest.
    qx0 = jnp.stack(
        [
            m[..., 2, 1] - m[..., 1, 2],
            1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
            m[..., 0, 1] + m[..., 1, 0],
            m[..., 0, 2] + m[..., 2, 0],
        ],
        axis=-1,
    )
    # Around y largest.
    qy0 = jnp.stack(
        [
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 0, 1] + m[..., 1, 0],
            1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
            m[..., 1, 2] + m[..., 2, 1],
        ],
        axis=-1,
    )
    # Around z largest.
    qz0 = jnp.stack(
        [
            m[..., 1, 0] - m[..., 0, 1],
            m[..., 0, 2] + m[..., 2, 0],
            m[..., 1, 2] + m[..., 2, 1],
            1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
        ],
        axis=-1,
    )
    # Pick the candidate whose pivot (its first squared element) is largest —
    # that is the numerically safest of the four.
    pivots = jnp.stack(
        [
            1.0 + t,
            1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
            1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
            1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
        ],
        axis=-1,
    )
    k = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw0, qx0, qy0, qz0], axis=-2)  # (..., 4 cands, 4)
    onehot = jax_one_hot(k, 4, R.dtype)
    q = jnp.einsum("...ck,...c->...k", cands, onehot, precision=HIGHEST)
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
