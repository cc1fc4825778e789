"""Point-to-plane JtJ/Jtr accumulation: the dense-ICP reduction.

Hot loop #2 (SURVEY.md §3.2). Given per-pixel associated data (source points
already transformed into the target camera frame, gathered target
points/normals, robust weights), accumulate the 6x6 Gauss-Newton normal
equations for the point-to-plane residual

    r_i = n_i · (p_i - q_i),   J_i = [n_i ; p_i × n_i]   (6-vector)

Augmented-Jacobian trick: append the residual and a constant-1 column to J;
the symmetric 8x8 product of the weighted J then yields *everything* —
``A[:6,:6] = JtJ``, ``A[:6, 6] = Jtr``, ``A[6, 6] = Σ w r²``, ``A[7, 7] =
Σ w``.

The reduction is plain jnp: the 64 products ``(w J)_i J_j`` summed over
pixels in f32 — one column reduction that XLA fuses with the Jacobian's
construction, so the ``(M, 8)`` Jacobian never reaches device memory. It
has no matrix product, so no TF32 rounding either. (On the H100 this form
beat a Pallas-Triton block reduction and an f32 einsum; see PERF.md.)

:func:`icp_jtj_jtr_reference` is the einsum form at ``HIGHEST`` precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import HIGHEST


def _jacobian(p, q, n):
    """(M, 8) augmented Jacobian [n, p × n, r, 1] from (M, 3) points,
    targets and normals."""
    r = jnp.sum(n * (p - q), axis=-1, keepdims=True)
    return jnp.concatenate([n, jnp.cross(p, n), r, jnp.ones_like(r)], axis=-1)


def _split(A):
    return A[:6, :6], A[:6, 6], A[6, 6], A[7, 7]


@jax.jit
def icp_jtj_jtr(p, q, n, w):
    """Accumulate the weighted point-to-plane normal equations.

    Args: ``p``, ``q``, ``n`` ``(M, 3)`` and ``w`` ``(M,)``; rows with
    ``w = 0`` contribute nothing. Returns ``(JtJ (6,6), Jtr (6,), err_sum,
    weight_sum)``.
    """
    J = _jacobian(p, q, n)
    return _split(jnp.sum((J * w[:, None])[:, :, None] * J[:, None, :], axis=0))


def icp_jtj_jtr_reference(p, q, n, w):
    """Oracle for :func:`icp_jtj_jtr`: ``(wJ)ᵀJ`` as an einsum at HIGHEST."""
    J = _jacobian(p, q, n)
    A = jnp.einsum("mi,mj->ij", J * w[:, None], J, precision=HIGHEST)
    return _split(A)
