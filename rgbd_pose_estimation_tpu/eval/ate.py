"""Trajectory evaluation: ATE and RPE (Sturm et al. 2012, TUM benchmark).

TPU-native twist on the reference's offline evaluation (SURVEY.md L6): the
Umeyama alignment *reuses the L1 absolute-orientation solver* — the evaluator
and the pose solver share one code path, cross-checking each other (SURVEY.md
§3.5). Runs happily on the CPU backend; inputs are small (F x 3).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from rgbd_pose_estimation_tpu.solvers.absolute_orientation import umeyama
from rgbd_pose_estimation_tpu.core.lie import matmul, matrix_to_rt, se3_inverse


def align_umeyama(est_xyz, gt_xyz, with_scale: bool = False):
    """Best similarity/rigid alignment est → gt. Returns ``(T, s)``."""
    T, s = umeyama(
        jnp.asarray(est_xyz, jnp.float32),
        jnp.asarray(gt_xyz, jnp.float32),
        with_scale=with_scale,
    )
    return np.asarray(T), float(np.asarray(s))


def ate_rmse(est_xyz, gt_xyz, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment (meters)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    T, s = align_umeyama(est, gt, with_scale)
    R, t = T[:3, :3], T[:3, 3]
    aligned = s * est @ R.T + t
    err = aligned - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a fixed frame delta.

    Args are ``(F, 4, 4)`` world→camera pose arrays. Returns dict with
    translational RMSE (m) and rotational RMSE (rad).
    """
    est = jnp.asarray(est_poses, jnp.float32)
    gt = jnp.asarray(gt_poses, jnp.float32)
    # Relative motions i -> i+delta in each trajectory.
    e_rel = matmul(est[delta:], se3_inverse(est[:-delta]))
    g_rel = matmul(gt[delta:], se3_inverse(gt[:-delta]))
    err = matmul(se3_inverse(g_rel), e_rel)
    R, t = matrix_to_rt(err)
    t_err = np.asarray(jnp.linalg.norm(t, axis=-1), np.float64)
    cos = np.clip(
        (np.trace(np.asarray(R), axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0
    )
    r_err = np.arccos(cos)
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_err**2))),
        "rot_rmse": float(np.sqrt(np.mean(r_err**2))),
    }
