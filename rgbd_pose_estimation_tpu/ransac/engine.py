"""Batched RANSAC/PROSAC engine: hypothesize → score → refit, one jit region.

The central structural difference from the reference (SURVEY.md §3.1): the
reference iterates hypotheses *serially* on the CPU with adaptive early
exit; here a fixed batch of K hypotheses is generated by one vmapped minimal
solver call, all K are scored against all N correspondences at once
(ops/ransac_score.py), and argmin + masked refit finish the job —
static shapes throughout, so the whole estimator is a single compiled XLA
program with no host round-trips.

Entry points:
- :func:`estimate_pose_3d3d` — depth-to-depth correspondences (Kabsch/Horn
  hypotheses), the reference's primary path.
- :func:`estimate_pose_2d3d` — 2D-3D via P3P: all quartic roots of every
  minimal sample are scored as independent hypotheses (4K total), which
  subsumes root disambiguation — the scoring argmin *is* the disambiguator.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import typing

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import HIGHEST
from rgbd_pose_estimation_tpu.ops.ransac_score import (
    best_pose_3d3d,
    pack_poses,
    score_poses_2d3d,
    unpack_pose,
)
from rgbd_pose_estimation_tpu.ransac.prosac import sample_minimal_sets
from rgbd_pose_estimation_tpu.solvers.absolute_orientation import (
    horn_quaternion,
    kabsch,
)
from rgbd_pose_estimation_tpu.solvers.p3p import p3p
from rgbd_pose_estimation_tpu.solvers.pnp import pnp_refine
from rgbd_pose_estimation_tpu.utils.config import RansacConfig


class RansacResult(typing.NamedTuple):
    pose: jnp.ndarray  # (4, 4) best pose
    inlier_mask: jnp.ndarray  # (N,) bool under the best pose
    num_inliers: jnp.ndarray  # () f32
    score: jnp.ndarray  # () MSAC score of the best hypothesis (pre-refit)
    valid: jnp.ndarray  # () bool — enough inliers found
    # Static: candidate poses scored against all correspondences — the one
    # metric definition (utils/metrics.py HYPOTHESES_DEFINITION): P3P
    # samples count their 4 roots, adaptive schedules sum their rounds.
    num_hypotheses: int


def pad_correspondences_3d3d(p, q, n_target: int):
    """Pad (p, q) to ``n_target`` rows with rigid-INCONSISTENT sentinels.

    Naive constant sentinels are dangerous: identical pad pairs are mutually
    consistent, so a hypothesis mapping the pad point to the pad target
    scores every pad row as an inlier and can beat the true model. Instead
    the pads lie on two lines with *different* point spacings (173 vs 171.6
    per index) — an isometry can match at most one pad pair within any
    threshold below ~0.7, and the pads sit ~1e4 away from any real scene so
    they can never mix with real inliers.
    """
    n = p.shape[0]
    pad = n_target - n
    if pad <= 0:
        return p, q
    i = jnp.arange(pad, dtype=p.dtype)
    p_pad = jnp.stack(
        [1e4 + 137.0 * i, -2e4 - 91.0 * i, 3e4 + 53.0 * i], axis=-1
    )
    q_pad = jnp.stack(
        [-3e4 - 71.0 * i, 1e4 + 119.0 * i, -2e4 - 101.0 * i], axis=-1
    )
    return jnp.concatenate([p, p_pad]), jnp.concatenate([q, q_pad])


def pad_points_obs_2d3d(points, obs, n_target: int):
    """Pad (points, obs) to ``n_target`` with always-outlier sentinels: the
    pad points sit at distinct negative depths (behind every plausible
    camera), which the scorers and refit already treat as outliers."""
    n = points.shape[0]
    pad = n_target - n
    if pad <= 0:
        return points, obs
    i = jnp.arange(pad, dtype=points.dtype)
    pts_pad = jnp.stack(
        [1e4 + 137.0 * i, -2e4 - 91.0 * i, -(1e4 + 53.0 * i)], axis=-1
    )
    obs_pad = jnp.stack([50.0 + i, -50.0 - 2.0 * i], axis=-1)
    return jnp.concatenate([points, pts_pad]), jnp.concatenate([obs, obs_pad])


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_pose_3d3d(key, p, q, cfg: RansacConfig = RansacConfig()):
    """Robust rigid pose from N 3D-3D correspondences (q ≈ R p + t).

    ``p``/``q`` are ``(N, 3)``; for PROSAC, order them by descending match
    quality. Returns a :class:`RansacResult`.
    """
    N = p.shape[0]
    K = cfg.num_hypotheses

    idx = sample_minimal_sets(key, N, K, cfg.sample_size, cfg.prosac)  # (K, m)
    pm = jnp.take(p, idx, axis=0)  # (K, m, 3)
    qm = jnp.take(q, idx, axis=0)
    solver = horn_quaternion if cfg.solver == "horn" else kabsch
    T = solver(pm, qm)  # (K, 4, 4)

    # NaN scores from degenerate minimal sets rank last.
    best, best_score, T_best = best_pose_3d3d(
        T, p, q, cfg.threshold, return_pose=True
    )
    T_best, inliers = _refit_3d3d(T_best, p, q, cfg)
    num = jnp.sum(inliers.astype(jnp.float32))
    return RansacResult(
        pose=T_best,
        inlier_mask=inliers,
        num_inliers=num,
        score=best_score,
        valid=num >= cfg.min_inliers,
        num_hypotheses=K,
    )


def _transform(p, T):
    """``R p + t`` for (N, 3) points, at full f32 precision."""
    return jnp.dot(p, T[:3, :3].T, precision=HIGHEST) + T[:3, 3]


def _refit_3d3d(T_best, p, q, cfg: RansacConfig):
    """Iteratively refit on the hard inliers of the current model (static
    rounds); returns the refit pose and its inlier mask."""

    def sq_err(T_cur):
        return jnp.sum((q - _transform(p, T_cur)) ** 2, axis=-1)

    def refit(T_cur, _):
        w = (sq_err(T_cur) < cfg.threshold**2).astype(p.dtype)
        # Degenerate guard: with <3 inliers keep the current model.
        enough = jnp.sum(w) >= 3
        # Horn's weighted quaternion power iteration: the same
        # least-squares optimum as Kabsch, without a 3x3 SVD.
        T_new = horn_quaternion(
            p, q, weights=jnp.where(enough, w, jnp.ones_like(w))
        )
        return jnp.where(enough, T_new, T_cur), None

    T_best, _ = jax.lax.scan(refit, T_best, None, length=cfg.refit_rounds)
    return T_best, sq_err(T_best) < cfg.threshold**2


def required_hypotheses(
    inlier_ratio: float, sample_size: int, confidence: float
) -> int:
    """Standard RANSAC stopping bound (Chum–Matas use the same form for
    PROSAC's non-randomness test): minimal samples needed so that the
    probability of drawing at least one uncontaminated set reaches
    ``confidence`` at the given inlier ratio. Uniform-sampling bound —
    conservative under PROSAC's quality-ordered sampling."""
    eps = min(max(float(inlier_ratio), 0.0), 1.0 - 1e-9)
    p_good = eps**sample_size
    if p_good <= 1e-12:
        return 1 << 30
    if p_good >= 1.0 - 1e-12:
        return 1
    return int(math.ceil(math.log(1.0 - confidence) / math.log(1.0 - p_good)))


def estimate_pose_3d3d_adaptive(key, p, q, cfg: RansacConfig = RansacConfig()):
    """Two-round adaptive schedule around :func:`estimate_pose_3d3d`.

    SURVEY.md §7 hard-part #6 / §3.1 "re-batching": a fixed large K wastes
    work at high inlier ratios, but data-dependent shapes would break jit.
    Resolution: TWO static shapes. A ``cfg.probe_hypotheses`` probe runs
    first; its inlier ratio is fetched (the function's single host sync)
    and plugged into the standard confidence bound — only when the bound
    demands more samples than the probe drew does the full
    ``cfg.num_hypotheses`` round run (keyed off the same PRNG key stream).
    Both programs are compiled once each; per-frame cost adapts while every
    shape stays static.

    Returns a :class:`RansacResult` whose ``num_hypotheses`` is the total
    actually scored this call (the per-frame work metric, SURVEY.md §5.5).
    """
    k_probe, k_full = jax.random.split(key)
    probe_cfg = dataclasses.replace(
        cfg, num_hypotheses=cfg.probe_hypotheses
    )
    res = estimate_pose_3d3d(k_probe, p, q, probe_cfg)
    ratio = float(res.num_inliers) / max(int(p.shape[0]), 1)
    need = required_hypotheses(ratio, cfg.sample_size, cfg.confidence)
    if need <= cfg.probe_hypotheses or cfg.num_hypotheses <= cfg.probe_hypotheses:
        return res
    full = estimate_pose_3d3d(k_full, p, q, cfg)
    # One definition everywhere (utils/metrics.py HYPOTHESES_DEFINITION):
    # num_hypotheses counts candidate POSES scored, so adaptive totals sum
    # the rounds' own fields — identical convention to the 2d3d path,
    # where each minimal sample contributes its 4 quartic roots.
    total = res.num_hypotheses + full.num_hypotheses
    best = full if float(full.num_inliers) >= float(res.num_inliers) else res
    return best._replace(num_hypotheses=total)


def estimate_pose_2d3d_adaptive(
    key, points, obs, cfg: RansacConfig = RansacConfig(), refine_iters: int = 8
):
    """Two-round adaptive schedule around :func:`estimate_pose_2d3d`
    (same contract as :func:`estimate_pose_3d3d_adaptive`)."""
    k_probe, k_full = jax.random.split(key)
    probe_cfg = dataclasses.replace(
        cfg, num_hypotheses=max(cfg.probe_hypotheses, 64)
    )
    res = estimate_pose_2d3d(k_probe, points, obs, probe_cfg, refine_iters)
    ratio = float(res.num_inliers) / max(int(points.shape[0]), 1)
    need = required_hypotheses(ratio, 3, cfg.confidence)
    if need <= probe_cfg.num_hypotheses or cfg.num_hypotheses <= probe_cfg.num_hypotheses:
        return res
    full = estimate_pose_2d3d(k_full, points, obs, cfg, refine_iters)
    total = res.num_hypotheses + full.num_hypotheses
    best = full if float(full.num_inliers) >= float(res.num_inliers) else res
    return best._replace(num_hypotheses=total)


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_pose_3d3d_normals(
    key, p, q, n_p, n_q, cfg: RansacConfig = RansacConfig()
):
    """Robust rigid pose from point+normal correspondences (2-pt samples).

    Uses the reduced 2-correspondence minimal solver (solvers/normals.py):
    at inlier ratio w the chance of an uncontaminated sample is w² instead
    of w³, so far fewer hypotheses are needed under heavy contamination.
    Scoring/refit are identical to :func:`estimate_pose_3d3d` (normals are
    only used for hypothesis generation).
    """
    from rgbd_pose_estimation_tpu.solvers.normals import ao_2pt_normals

    N = p.shape[0]
    K = cfg.num_hypotheses

    idx = sample_minimal_sets(key, N, K, 2, cfg.prosac)  # (K, 2)
    T = ao_2pt_normals(
        jnp.take(p, idx, axis=0),
        jnp.take(q, idx, axis=0),
        jnp.take(n_p, idx, axis=0),
        jnp.take(n_q, idx, axis=0),
    )

    best, best_score, T_best = best_pose_3d3d(
        T, p, q, cfg.threshold, return_pose=True
    )
    T_best, inliers = _refit_3d3d(T_best, p, q, cfg)
    num = jnp.sum(inliers.astype(jnp.float32))
    return RansacResult(
        pose=T_best,
        inlier_mask=inliers,
        num_inliers=num,
        score=best_score,
        valid=num >= cfg.min_inliers,
        num_hypotheses=K,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "refine_iters"))
def estimate_pose_2d3d(
    key, points, obs, cfg: RansacConfig = RansacConfig(), refine_iters: int = 8
):
    """Robust world→camera pose from N (3D point, normalized-2D obs) pairs.

    P3P hypotheses: every real quartic root of every minimal sample enters
    the scoring batch (4K poses); invalid roots get +inf score. The winner
    is polished by damped Gauss-Newton on its inliers (SURVEY.md §3.1).
    """
    N = points.shape[0]
    K = cfg.num_hypotheses
    idx = sample_minimal_sets(key, N, K, 3, cfg.prosac)  # (K, 3)
    pm = jnp.take(points, idx, axis=0)  # (K, 3, 3)
    om = jnp.take(obs, idx, axis=0)  # (K, 3, 2)
    rays = jnp.concatenate([om, jnp.ones_like(om[..., :1])], axis=-1)
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)

    T_roots, valid = p3p(pm, rays)  # (K, 4, 4, 4), (K, 4)
    valid_all = valid.reshape(K * 4)
    P_all = pack_poses(T_roots.reshape(K * 4, 4, 4))
    # Invalid roots: replace with identity (finite math) and inf the score.
    ident = jnp.concatenate([jnp.eye(3).reshape(9), jnp.zeros(3)])
    P_all = jnp.where(valid_all[:, None], P_all, ident.astype(P_all.dtype))

    msac, _counts = score_poses_2d3d(P_all, points, obs, cfg.threshold)
    msac = jnp.where(valid_all & ~jnp.isnan(msac), msac, jnp.inf)
    best = jnp.argmin(msac)
    T_best = unpack_pose(P_all[best])
    best_score = msac[best]

    def inlier_w(T_cur):
        Xc = _transform(points, T_cur)
        z = jnp.maximum(Xc[:, 2], 1e-6)
        e = jnp.sum((Xc[:, :2] / z[:, None] - obs) ** 2, axis=-1)
        e = jnp.where(Xc[:, 2] < 1e-6, jnp.inf, e)
        return (e < cfg.threshold**2).astype(points.dtype)

    w = inlier_w(T_best)
    T_ref = pnp_refine(T_best, points, obs, weights=w, iters=refine_iters)
    # Keep the refinement only if it didn't lose inliers (robustness guard).
    w_ref = inlier_w(T_ref)
    better = jnp.sum(w_ref) >= jnp.sum(w)
    T_best = jnp.where(better, T_ref, T_best)

    inliers = inlier_w(T_best) > 0
    num = jnp.sum(inliers.astype(jnp.float32))
    return RansacResult(
        pose=T_best,
        inlier_mask=inliers,
        num_inliers=num,
        score=best_score,
        valid=num >= cfg.min_inliers,
        num_hypotheses=K * 4,
    )
