"""Schur-complement bundle adjustment, matrix-free and shardable.

Driver config 5 (not in the reference — SURVEY.md §2.1 "new-build"). The
design follows SURVEY.md §3.4 and the retrieved literature (PAPERS.md:
Power-BA's inverse-free reduced solves motivate the matrix-free CG; the
Stochastic-BA / PI-BA clustering ideas inform the sharding layout):

- the reduced camera system  S = U − W V⁻¹ Wᵀ  is never materialized:
  each CG matvec is two ``segment_sum`` sweeps over the observation array
  (camera-side and landmark-side) plus a batched 3x3 solve — all dense
  vectorized work that shards over observations;
- per-landmark 3x3 blocks (V) are eliminated in closed form (HOT LOOP #4);
- CG on the reduced system (HOT LOOP #5) runs a fixed iteration count under
  ``lax.scan`` so the whole BA step is one XLA program;
- gauge: camera 0 is frozen (its delta masked to zero).

The same ``ba_step`` body runs **unchanged** under ``shard_map`` with
observations sharded across a device mesh — every ``segment_sum`` is then
followed by a ``psum`` (parallel/sharded.py) — which is exactly the
"landmark blocks local, reduced camera contributions psum'd over ICI"
layout of SURVEY.md §3.4.
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.lie import (
    HIGHEST,
    matmul,
    se3_adjoint,
    se3_exp,
    se3_inverse,
    se3_log,
)
from rgbd_pose_estimation_tpu.utils.config import BAConfig


class BAProblem(typing.NamedTuple):
    poses: jnp.ndarray  # (C, 4, 4) world→camera
    points: jnp.ndarray  # (L, 3) world landmarks
    cam_idx: jnp.ndarray  # (O,) int32
    lm_idx: jnp.ndarray  # (O,) int32
    obs: jnp.ndarray  # (O, 2) normalized-plane observations
    w: jnp.ndarray  # (O,) observation weights (0 = padding)
    obs_z: jnp.ndarray = None  # (O,) measured depth (m); 0/neg = RGB-only.
    # RGB-D BA: the depth residual removes the scale-gauge freedom a pure
    # reprojection BA has (scaling landmarks+translations about the gauge
    # camera leaves pixel residuals unchanged — noise then drifts the scale).
    #
    # Relative-pose priors (odometry fusion). A feature-only BA on few/short
    # tracks is weakly determined and will happily trade real pose accuracy
    # for reprojection residual; dense odometry knows the relative motion to
    # sub-mm. These edges add  w·‖log(T_meas⁻¹ T_i T_j⁻¹)‖²  terms coupling
    # camera pairs — the production-SLAM "motion prior" — so feature
    # information refines poses instead of replacing the odometry estimate.
    prior_i: jnp.ndarray = None  # (E,) int32 camera index i
    prior_j: jnp.ndarray = None  # (E,) int32 camera index j
    prior_T_inv: jnp.ndarray = None  # (E, 4, 4) measured (cam j → cam i)⁻¹
    prior_w: jnp.ndarray = None  # (E,) information weights


def _residual_jacobians(T, X, cam_idx, lm_idx, obs, obs_z=None, depth_weight=1.0):
    """Per-observation residual + camera/landmark Jacobians.

    Returns r (O,3), Jc (O,3,6), Jl (O,3,3): two reprojection rows plus one
    depth row  dw*(z - obs_z)  that is zeroed for RGB-only observations.
    Camera perturbation is a left twist on T_c (same convention as
    pnp_refine); landmark Jacobians chain through R_c.
    """
    Tc = T[cam_idx]  # (O, 4, 4)
    Xl = X[lm_idx]  # (O, 3)
    R = Tc[:, :3, :3]
    Xc = jnp.einsum("oij,oj->oi", R, Xl, precision=HIGHEST) + Tc[:, :3, 3]
    x, y, z = Xc[:, 0], Xc[:, 1], jnp.maximum(Xc[:, 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    if obs_z is None:
        obs_z = jnp.zeros_like(z)
    has_z = (obs_z > 0).astype(z.dtype) * depth_weight
    rz = has_z * (z - obs_z)
    r = jnp.stack([x * iz - obs[:, 0], y * iz - obs[:, 1], rz], axis=-1)

    zero = jnp.zeros_like(x)
    Ju = jnp.stack([iz, zero, -x * iz2, -x * y * iz2, 1.0 + x * x * iz2, -y * iz], axis=-1)
    Jv = jnp.stack([zero, iz, -y * iz2, -(1.0 + y * y * iz2), x * y * iz2, x * iz], axis=-1)
    # d z / d xi = row 3 of [I | -[Xc]x] = [0, 0, 1, y, -x, 0].
    Jz = has_z[:, None] * jnp.stack([zero, zero, zero + 1.0, y, -x, zero], axis=-1)
    Jc = jnp.stack([Ju, Jv, Jz], axis=-2)  # (O, 3, 6)

    # d r / d X_world = (d [proj; z] / d Xc) @ R.
    P = jnp.stack(
        [
            jnp.stack([iz, zero, -x * iz2], axis=-1),
            jnp.stack([zero, iz, -y * iz2], axis=-1),
            has_z[:, None] * jnp.stack([zero, zero, zero + 1.0], axis=-1),
        ],
        axis=-2,
    )  # (O, 3, 3)
    Jl = jnp.einsum("oai,oij->oaj", P, R, precision=HIGHEST)
    return r, Jc, Jl


def _huber_w(r, delta):
    nrm = jnp.linalg.norm(r, axis=-1)
    return jnp.where(nrm <= delta, 1.0, delta / jnp.maximum(nrm, 1e-12))


def make_reduction_slots(idx, n: int, max_inflation: float = 1.6):
    """Host-side slot table turning ``segment_sum`` into gather + free sum.

    The BA CG matvec does two segment_sums per iteration, and a scatter
    can be slower than a gather on the device. ``slots[i]`` lists the
    observation rows of segment ``i`` (padded with the sentinel
    ``len(idx)``); the reduction then becomes ``x_padded[slots].sum(1)``
    — a gather plus a bucketed sum that is pure streaming. Whether this
    pays on the H100 is not measured yet (ROADMAP Queue 1).

    Returns ``None`` when the padded table would exceed ``max_inflation``
    × O indices (pathological imbalance — scatter wins there), letting
    callers fall back. Host-only: ``idx`` must be a concrete array.
    """
    import numpy as np

    idx = np.asarray(idx)
    O = len(idx)
    cnt = np.bincount(idx, minlength=n)
    cap = int(cnt.max()) if O else 1
    if n * cap > max_inflation * max(O, 1):
        return None
    order = np.argsort(idx, kind="stable")
    slot = np.full((n, cap), O, np.int32)
    pos = np.searchsorted(idx[order], np.arange(n))
    for i in range(n):
        k = cnt[i]
        slot[i, :k] = order[pos[i] : pos[i] + k]
    return slot


def _seg_by_slots(x, slots):
    """``segment_sum(x, idx, n)`` given the slot table for ``idx``."""
    pad = jnp.zeros((1,) + x.shape[1:], x.dtype)
    return jnp.concatenate([x, pad])[slots].sum(axis=1)


def ba_step(prob: BAProblem, cfg: BAConfig, psum=None, psum_lm=None,
            cam_slots=None, lm_slots=None):
    """One damped GN step with Schur elimination + matrix-free CG.

    ``psum``: optional reduction applied after camera-indexed (and global)
    ``segment_sum``s — identity on one device, ``lax.psum`` under shard_map.

    ``psum_lm``: reduction for landmark-indexed segment sums. Defaults to
    ``psum`` (replicated-landmark layout, parallel/sharded.py). Under the
    landmark-**blocked** layout (ba/cluster.py) every landmark's
    observations live on its own shard, so landmark sums are already
    complete locally — pass identity and the O(L) collective disappears:
    per CG matvec only the (C, 6) camera vector rides the mesh
    (SURVEY.md §3.4 "landmark blocks local, reduced camera system psum'd").

    ``cam_slots``/``lm_slots``: optional :func:`make_reduction_slots`
    tables; when given, the camera/landmark reductions run scatter-free
    (gather + bucketed sum — TPU scatter is half the gather unit's index
    rate). Same math, different summation order (f32-reduction-order
    deviation only).
    """
    if psum is None:
        psum = lambda x: x
    if psum_lm is None:
        psum_lm = psum
    T, X = prob.poses, prob.points
    C, L = T.shape[0], X.shape[0]
    lam = cfg.damping

    r, Jc, Jl = _residual_jacobians(
        T, X, prob.cam_idx, prob.lm_idx, prob.obs, prob.obs_z, cfg.depth_weight
    )
    w = prob.w * _huber_w(r, cfg.huber_delta)
    cost = psum(jnp.sum(w * jnp.sum(r * r, axis=-1)))

    wJc = Jc * w[:, None, None]
    wJl = Jl * w[:, None, None]

    def seg_cam(x):  # (O, ...) → (C, ...)
        if cam_slots is not None:
            return psum(_seg_by_slots(x, cam_slots))
        return psum(jax.ops.segment_sum(x, prob.cam_idx, num_segments=C))

    def seg_lm(x):  # (O, ...) → (L, ...)
        if lm_slots is not None:
            return psum_lm(_seg_by_slots(x, lm_slots))
        return psum_lm(jax.ops.segment_sum(x, prob.lm_idx, num_segments=L))

    U = seg_cam(jnp.einsum("oai,oaj->oij", wJc, Jc, precision=HIGHEST))  # (C, 6, 6)
    V = seg_lm(jnp.einsum("oai,oaj->oij", wJl, Jl, precision=HIGHEST))  # (L, 3, 3)
    bc = -seg_cam(jnp.einsum("oai,oa->oi", wJc, r, precision=HIGHEST))  # (C, 6)
    bl = -seg_lm(jnp.einsum("oai,oa->oi", wJl, r, precision=HIGHEST))  # (L, 3)

    U = U + lam * jnp.eye(6, dtype=T.dtype)
    V = V + lam * jnp.eye(3, dtype=T.dtype)
    Vinv = jnp.linalg.inv(V)  # batched 3x3

    # Relative-pose odometry priors (see BAProblem). Added AFTER the psum
    # of observation quantities: prior inputs are replicated, so every
    # shard adds identical terms — no collective, still bit-consistent.
    # Left-perturbation Jacobians of r = log(Tm⁻¹ T_i T_j⁻¹):
    # J_i = Ad(Tm⁻¹), J_j = −I (small-residual approximation).
    prior_cross = None
    if prob.prior_i is not None:
        pi, pj, wp = prob.prior_i, prob.prior_j, prob.prior_w
        Ai = se3_adjoint(prob.prior_T_inv)  # (E, 6, 6)
        r_p = se3_log(matmul(matmul(prob.prior_T_inv, T[pi]), se3_inverse(T[pj])))
        cost = cost + jnp.sum(wp * jnp.sum(r_p * r_p, axis=-1))
        U = U.at[pi].add(
            jnp.einsum("eki,ekj->eij", Ai, Ai, precision=HIGHEST)
            * wp[:, None, None]
        )
        U = U.at[pj].add(wp[:, None, None] * jnp.eye(6, dtype=T.dtype))
        bc = bc.at[pi].add(
            -jnp.einsum("eki,ek->ei", Ai, r_p, precision=HIGHEST) * wp[:, None]
        )
        bc = bc.at[pj].add(wp[:, None] * r_p)

        def prior_cross(x):  # off-diagonal camera-camera blocks of H
            yi = -jnp.einsum("eki,ek->ei", Ai, x[pj], precision=HIGHEST) * wp[:, None]
            yj = -jnp.einsum("eik,ek->ei", Ai, x[pi], precision=HIGHEST) * wp[:, None]
            return jnp.zeros_like(x).at[pi].add(yi).at[pj].add(yj)

    def cam_from_lm(u_l):
        """y_c = Σ_obs Jcᵀ w Jl u_{l(o)}  — camera-side gather of landmark vec."""
        t = jnp.einsum("oaj,oj->oa", Jl, u_l[prob.lm_idx], precision=HIGHEST)  # (O, 2)
        return seg_cam(jnp.einsum("oai,oa->oi", wJc, t, precision=HIGHEST))

    def lm_from_cam(x_c):
        """t_l = Σ_obs Jlᵀ w Jc x_{c(o)}  — landmark-side gather of camera vec."""
        t = jnp.einsum("oai,oi->oa", Jc, x_c[prob.cam_idx], precision=HIGHEST)  # (O, 2)
        return seg_lm(jnp.einsum("oaj,oa->oj", wJl, t, precision=HIGHEST))

    gauge_mask = (jnp.arange(C) > 0).astype(T.dtype)[:, None]

    def S_matvec(x_c):
        x_c = x_c * gauge_mask
        ux = jnp.einsum("cij,cj->ci", U, x_c, precision=HIGHEST)
        t_l = lm_from_cam(x_c)
        u_l = jnp.einsum("lij,lj->li", Vinv, t_l, precision=HIGHEST)
        y = ux - cam_from_lm(u_l)
        if prior_cross is not None:
            y = y + prior_cross(x_c)
        return y * gauge_mask

    vb = jnp.einsum("lij,lj->li", Vinv, bl, precision=HIGHEST)
    rhs = (bc - cam_from_lm(vb)) * gauge_mask

    # Fixed-iteration CG on the reduced camera system (HOT LOOP #5).
    def cg_body(carry, _):
        x, rr, p = carry
        Ap = S_matvec(p)
        rr_dot = jnp.sum(rr * rr)
        alpha = rr_dot / jnp.maximum(jnp.sum(p * Ap), 1e-20)
        x = x + alpha * p
        rr_new = rr - alpha * Ap
        beta = jnp.sum(rr_new * rr_new) / jnp.maximum(rr_dot, 1e-20)
        p = rr_new + beta * p
        return (x, rr_new, p), None

    x0 = jnp.zeros_like(rhs)
    (dx_c, _, _), _ = jax.lax.scan(
        cg_body, (x0, rhs, rhs), None, length=cfg.cg_iters
    )
    dx_c = dx_c * gauge_mask

    # Back-substitute landmark updates (HOT LOOP #4's closure).
    dl = jnp.einsum(
        "lij,lj->li", Vinv, bl - lm_from_cam(dx_c), precision=HIGHEST,
    )

    T_new = matmul(se3_exp(dx_c), T)
    X_new = X + dl
    return prob._replace(poses=T_new, points=X_new), cost


@functools.partial(jax.jit, static_argnames=("cfg",))
def _ba_solve_impl(prob, cfg, cam_slots, lm_slots):
    def body(p, _):
        p2, cost = ba_step(p, cfg, cam_slots=cam_slots, lm_slots=lm_slots)
        return p2, cost

    return jax.lax.scan(body, prob, None, length=cfg.outer_iters)


def ba_solve(prob: BAProblem, cfg: BAConfig = BAConfig(), slots: bool = True):
    """Run ``cfg.outer_iters`` damped GN steps; returns (problem, costs).

    ``slots=True`` (default) builds scatter-free reduction tables on the
    host when the index arrays are concrete and well-balanced
    (:func:`make_reduction_slots`); pass False (or call under jit with traced indices) to
    keep the segment_sum path.
    """
    cam_slots = lm_slots = None
    if slots:
        try:  # concrete index arrays only — traced (under an outer jit)
            import numpy as np  # or non-addressable arrays keep scatter.

            ci = np.asarray(prob.cam_idx)
            li = np.asarray(prob.lm_idx)
        except Exception:
            ci = li = None
        if ci is not None:
            cs = make_reduction_slots(ci, int(prob.poses.shape[0]))
            ls = make_reduction_slots(li, int(prob.points.shape[0]))
            cam_slots = None if cs is None else jnp.asarray(cs)
            lm_slots = None if ls is None else jnp.asarray(ls)
    return _ba_solve_impl(prob, cfg, cam_slots, lm_slots)


def with_odometry_priors(
    prob: BAProblem, weight: float, edges=None
) -> BAProblem:
    """Attach relative-pose priors measured from the problem's CURRENT
    poses (call before stepping: the initialization is the odometry/pose-
    graph estimate being trusted). ``edges`` defaults to consecutive
    camera pairs; pass extras (e.g. verified loop pairs) to trust those
    relative transforms too."""
    C = int(prob.poses.shape[0])
    if edges is None:
        edges = [(a, a + 1) for a in range(C - 1)]
    if not edges:
        return prob
    pi = jnp.asarray([a for a, _ in edges], jnp.int32)
    pj = jnp.asarray([b for _, b in edges], jnp.int32)
    Tm = matmul(prob.poses[pi], se3_inverse(prob.poses[pj]))
    return prob._replace(
        prior_i=pi,
        prior_j=pj,
        prior_T_inv=se3_inverse(Tm),
        prior_w=jnp.full(len(edges), weight, prob.poses.dtype),
    )


def prune_observations(prob: BAProblem, max_residual: float, depth_weight=1.0) -> BAProblem:
    """Zero the weight of observations with residual norm beyond a bound.

    Wrong feature matches survive track building as high-residual
    observations; left in, they drag BA *away* from a good initialization.
    Standard practice is to prune between GN rounds — callers run a couple
    of damped steps, prune, then continue (see models/slam.py, cli ba).
    """
    r, _, _ = _residual_jacobians(
        prob.poses, prob.points, prob.cam_idx, prob.lm_idx, prob.obs,
        prob.obs_z, depth_weight,
    )
    keep = jnp.linalg.norm(r, axis=-1) <= max_residual
    return prob._replace(w=jnp.where(keep, prob.w, 0.0))


def reprojection_rmse(prob: BAProblem) -> jnp.ndarray:
    """Reprojection-only RMSE (depth rows excluded) over weighted obs."""
    r, _, _ = _residual_jacobians(
        prob.poses, prob.points, prob.cam_idx, prob.lm_idx, prob.obs
    )
    r = r[:, :2]
    m = prob.w > 0
    return jnp.sqrt(
        jnp.sum(jnp.where(m, jnp.sum(r * r, -1), 0.0)) / jnp.maximum(jnp.sum(m), 1)
    )


def make_synthetic_ba_problem(
    key,
    num_cameras: int = 8,
    num_points: int = 200,
    obs_per_point: int = 4,
    pixel_noise: float = 0.001,
    pose_noise: float = 0.01,
    point_noise: float = 0.02,
):
    """Random BA problem with known ground truth + perturbed initialization.

    Returns ``(problem_with_noisy_init, gt_poses, gt_points)``. Observations
    are exact projections of the ground truth plus ``pixel_noise``.
    """
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    # Cameras along a gentle arc looking at the landmark cloud.
    xi = jax.random.normal(k1, (num_cameras, 6)) * 0.1
    xi = xi.at[:, 0].add(jnp.linspace(-0.5, 0.5, num_cameras))
    T_gt = se3_exp(xi).at[:, 2, 3].add(3.0)
    X_gt = jax.random.uniform(k2, (num_points, 3), minval=-1.5, maxval=1.5)

    cam_idx = (
        jax.random.randint(k3, (num_points, obs_per_point), 0, num_cameras)
        .reshape(-1)
        .astype(jnp.int32)
    )
    lm_idx = jnp.repeat(
        jnp.arange(num_points, dtype=jnp.int32), obs_per_point
    )
    Xc = jnp.einsum(
        "oij,oj->oi", T_gt[cam_idx, :3, :3], X_gt[lm_idx], precision=HIGHEST
    ) + T_gt[
        cam_idx, :3, 3
    ]
    z = jnp.maximum(Xc[:, 2], 1e-3)
    obs = Xc[:, :2] / z[:, None] + pixel_noise * jax.random.normal(
        k4, (len(cam_idx), 2)
    )
    obs_z = Xc[:, 2] + pixel_noise * 2.0 * jax.random.normal(k4, (len(cam_idx),))
    w = (Xc[:, 2] > 0.2).astype(jnp.float32)

    # Perturbed initialization (what odometry would hand BA).
    dxi = jax.random.normal(k5, (num_cameras, 6)) * pose_noise
    dxi = dxi.at[0].set(0.0)  # gauge camera stays
    T0 = matmul(se3_exp(dxi), T_gt)
    X0 = X_gt + jax.random.normal(k6, (num_points, 3)) * point_noise
    prob = BAProblem(
        poses=T0, points=X0, cam_idx=cam_idx, lm_idx=lm_idx, obs=obs, w=w,
        obs_z=obs_z,
    )
    return prob, T_gt, X_gt
