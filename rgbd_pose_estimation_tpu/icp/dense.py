"""Dense projective point-to-plane ICP odometry (KinectFusion-style).

HOT LOOP #2 (SURVEY.md §3.2): the reference runs nested C++ pixel loops per
GN iteration; here each iteration is three fused device stages —

1. warp: transform every source vertex by the current pose and project it
   into the target camera (pure elementwise jnp);
2. associate: bilinear-gather target vertices / nearest-gather normals at
   the projected pixels (the one gather, kept in XLA — SURVEY.md hard-part
   #4), gate by distance / normal-agreement / depth validity, weight by a
   Huber robust kernel;
3. accumulate: ops/icp_jtj.py reduces the point-to-plane normal equations
   on the device; a 6x6 LM-damped solve and an SE(3) retraction finish the
   iteration.

The pyramid is coarse-to-fine; iterations per level are static
(``lax.scan``), so a whole multi-level track compiles to one XLA program
with zero host round-trips. Pose convention: ``T`` maps source camera frame
→ target camera frame.
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu.core.lie import HIGHEST, matmul, se3_exp
from rgbd_pose_estimation_tpu.data.geometry import (
    bilinear_sample,
    build_pyramid,
    nearest_sample,
    normal_map,
    vertex_map,
)
from rgbd_pose_estimation_tpu.ops.icp_jtj import icp_jtj_jtr
from rgbd_pose_estimation_tpu.utils.config import IcpConfig


class IcpFrame(typing.NamedTuple):
    """Per-level vertex/normal maps of one RGB-D frame (finest first).

    ``photo`` is optionally the per-level ``(H_l, W_l, 3)`` stack
    ``[intensity, dI/du, dI/dv]`` (data/geometry.py::photo_map) consumed by
    the photometric residual; empty when tracking is depth-only.
    """

    vertices: tuple  # level → (H_l, W_l, 3)
    normals: tuple  # level → (H_l, W_l, 3)
    photo: tuple = ()  # level → (H_l, W_l, 3) or empty


def make_icp_frame(
    cam: CameraIntrinsics,
    depth: jnp.ndarray,
    cfg: IcpConfig,
    intensity: jnp.ndarray | None = None,
) -> IcpFrame:
    """Build the ICP pyramid for a depth image (device-side, jit-able).

    Pass ``intensity`` (H, W float in [0,1]) to enable the photometric
    term (cfg.photometric_weight > 0)."""
    from rgbd_pose_estimation_tpu.data.geometry import (
        downsample_intensity,
        photo_map,
    )

    depth = jnp.where(
        (depth >= cfg.min_depth) & (depth <= cfg.max_depth), depth, 0.0
    )
    pyr = build_pyramid(depth, cfg.levels)
    verts, norms, photos = [], [], []
    img = intensity
    for lvl, d in enumerate(pyr):
        c = cam.scaled(0.5**lvl)
        v = vertex_map(c, d)
        verts.append(v)
        norms.append(normal_map(v))
        if img is not None:
            photos.append(photo_map(img))
            img = downsample_intensity(img)
    return IcpFrame(
        vertices=tuple(verts), normals=tuple(norms), photo=tuple(photos)
    )


def _level_iteration(
    cam_l: CameraIntrinsics, cfg: IcpConfig, src_v, src_n, tgt_v, tgt_n,
    src_ph=None, tgt_ph=None, level: int = 0,
):
    """Returns step(T) → (T', stats) for one pyramid level (closure is
    compile-time; shapes static per level).

    With ``cfg.photometric_weight > 0`` and photo maps present, a DVO-style
    intensity residual r_I = I_tgt(π(Tp)) − I_src rides alongside point-to-
    plane. Its Jacobian has the same [a; p×a] structure with a = ∇I·dπ/dp,
    so BOTH residuals accumulate through the one JtJ reduction: the
    photometric rows enter as (p, q_virtual, a, w) with q_virtual chosen
    so the reduction's n·(p−q) reproduces r_I exactly.
    """

    stride = cfg.source_stride[level] if level < len(cfg.source_stride) else 1
    if stride > 1:
        # Thin the residual sample (stride^2 fewer gathered pixels; see
        # IcpConfig.source_stride).
        src_v = src_v[::stride, ::stride]
        src_n = src_n[::stride, ::stride]
        if src_ph is not None:
            src_ph = src_ph[::stride, ::stride]
    sv = src_v.reshape(-1, 3)
    sn = src_n.reshape(-1, 3)
    src_valid = (sv[:, 2] > 0) & (jnp.sum(sn * sn, axis=-1) > 0.5)

    use_photo = (
        cfg.photometric_weight > 0.0
        and src_ph is not None
        and tgt_ph is not None
    )
    if use_photo and cfg.association != "nearest":
        raise NotImplementedError(
            "photometric term requires association='nearest'"
        )

    # For nearest association, pack everything the step needs — vertex,
    # normal, and optionally intensity+gradient — into ONE flat map and
    # gather it once per iteration instead of five times (4 bilinear
    # vertex taps + normals).
    th, tw = tgt_v.shape[:2]
    if cfg.association == "nearest":
        packs = [tgt_v.reshape(-1, 3), tgt_n.reshape(-1, 3)]
        if use_photo:
            packs.append(tgt_ph.reshape(-1, 3))
        tgt_pack = jnp.concatenate(packs, axis=-1)
    if use_photo:
        si = src_ph.reshape(-1, 3)[:, 0]  # source intensity

    # Fixed-correspondence inner steps (cfg.reassoc_every > 1): the gather
    # is the whole step cost, while a GN step on FIXED (q, n) pairs is pure
    # elementwise math — standard ICP alternation allows several minimize
    # steps per association. The fresh/stale choice is made at TRACE time
    # (``assoc=None`` → re-gather): an earlier lax.cond formulation lowered
    # to a select that executed BOTH branches, so k>1 bought no time at
    # all; icp_track unrolls the k-pattern statically instead.

    def step(T, assoc=None):
        """One GN iteration. ``assoc=None`` performs fresh association (the
        gather); passing the previous step's ``assoc`` reuses it — a purely
        static (trace-time) decision. Returns ``(T_new, stats, assoc)``."""
        R, t = T[:3, :3], T[:3, 3]
        p = jnp.dot(sv, R.T, precision=HIGHEST) + t  # target frame
        n_src = jnp.dot(sn, R.T, precision=HIGHEST)

        z = jnp.maximum(p[:, 2], 1e-6)
        u = cam_l.fx * p[:, 0] / z + cam_l.cx
        v = cam_l.fy * p[:, 1] / z + cam_l.cy
        uv = jnp.stack([u, v], axis=-1)

        if cfg.association == "nearest":
            if assoc is None:
                ui = jnp.round(u).astype(jnp.int32)
                vi = jnp.round(v).astype(jnp.int32)
                in_b = (ui >= 0) & (ui < tw) & (vi >= 0) & (vi < th)
                idx = jnp.clip(vi, 0, th - 1) * tw + jnp.clip(ui, 0, tw - 1)
                g = jnp.take(tgt_pack, idx, axis=0)  # the ONE gather
                assoc = (g, in_b, ui, vi)
            g, in_b, ui, vi = assoc
            q, nt = g[:, 0:3], g[:, 3:6]
            q = jnp.where(in_b[:, None], q, 0.0)
            nt = jnp.where(in_b[:, None], nt, 0.0)
        else:
            q, in_b = bilinear_sample(tgt_v, uv)
            nt, _ = nearest_sample(tgt_n, uv)

        diff = p - q
        dist2 = jnp.sum(diff * diff, axis=-1)
        ncos = jnp.sum(nt * n_src, axis=-1)
        r = jnp.sum(nt * diff, axis=-1)

        valid = (
            src_valid
            & in_b
            & (p[:, 2] > 0)
            & (q[:, 2] > 0)
            & (jnp.sum(nt * nt, axis=-1) > 0.5)
            & (dist2 < cfg.dist_threshold**2)
            & (ncos > cfg.normal_threshold)
        )
        # Huber weight on the point-to-plane residual.
        absr = jnp.abs(r)
        w_rob = jnp.where(absr <= cfg.huber_delta, 1.0, cfg.huber_delta / jnp.maximum(absr, 1e-12))
        w = jnp.where(valid, w_rob, 0.0)
        data = (p, q, nt, w)

        if use_photo:
            # First-order subpixel correction of the nearest-gathered
            # intensity, then the DVO chain a = ∇I · dπ/dp.
            ti, tgx, tgy = g[:, 6], g[:, 7], g[:, 8]
            du = u - ui.astype(u.dtype)
            dv = v - vi.astype(v.dtype)
            r_i = ti + tgx * du + tgy * dv - si
            ax = tgx * cam_l.fx / z
            ay = tgy * cam_l.fy / z
            az = -(tgx * cam_l.fx * p[:, 0] + tgy * cam_l.fy * p[:, 1]) / (
                z * z
            )
            a = jnp.stack([ax, ay, az], axis=-1)
            a2 = jnp.sum(a * a, axis=-1)
            valid_ph = (
                src_valid
                & in_b
                & (p[:, 2] > 0)
                & (q[:, 2] > 0)
                & (dist2 < cfg.dist_threshold**2)
                & (a2 > 1e-8)
            )
            abri = jnp.abs(r_i)
            w_ph = jnp.where(
                abri <= cfg.photo_huber,
                1.0,
                cfg.photo_huber / jnp.maximum(abri, 1e-12),
            )
            w_ph = jnp.where(valid_ph, w_ph * cfg.photometric_weight, 0.0)
            # Virtual target point: the reduction computes n·(p − q), so
            # pick q_virt with a·(p − q_virt) = r_I.
            q_virt = p - (r_i / jnp.maximum(a2, 1e-8))[:, None] * a
            data_ph = (p, q_virt, a, w_ph)
            data = tuple(
                jnp.concatenate([x, y]) for x, y in zip(data, data_ph)
            )

        JtJ, Jtr, err, wsum_all = icp_jtj_jtr(*data)
        # Overlap bookkeeping stays GEOMETRIC-only (keyframe policy signal).
        wsum = jnp.sum(w) if use_photo else wsum_all

        H = JtJ + cfg.damping * jnp.eye(6, dtype=JtJ.dtype)
        # Guard: if almost nothing associated, take no step.
        ok = wsum > 50.0
        delta = jnp.linalg.solve(H, -Jtr[:, None])[:, 0]
        delta = jnp.where(ok, delta, jnp.zeros(6, dtype=delta.dtype))
        T_new = matmul(se3_exp(delta), T)
        stats = jnp.stack([err, wsum])
        return T_new, stats, assoc

    return step


@functools.partial(jax.jit, static_argnames=("cam", "cfg"))
def icp_track(
    cam: CameraIntrinsics,
    cfg: IcpConfig,
    T_init: jnp.ndarray,
    src: IcpFrame,
    tgt: IcpFrame,
):
    """Track source→target pose by coarse-to-fine projective ICP.

    Returns ``(T, stats)`` where stats is ``(2,)``: final [robust error sum,
    associated weight sum] at the finest level — the weight sum relative to
    the pixel count is the overlap signal keyframe selection uses.
    """
    T = T_init
    stats = jnp.zeros(2)
    has_photo = len(src.photo) > 0 and len(tgt.photo) > 0
    reassoc = max(int(getattr(cfg, "reassoc_every", 1)), 1)
    use_carry = reassoc > 1 and cfg.association == "nearest"
    for lvl in range(cfg.levels - 1, -1, -1):
        cam_l = cam.scaled(0.5**lvl)
        step = _level_iteration(
            cam_l, cfg, src.vertices[lvl], src.normals[lvl],
            tgt.vertices[lvl], tgt.normals[lvl],
            src.photo[lvl] if has_photo else None,
            tgt.photo[lvl] if has_photo else None,
            level=lvl,
        )
        iters = cfg.iters_per_level[lvl]
        if use_carry:
            # Static unroll (iters <= ~10): iteration i re-gathers iff
            # i % reassoc == 0, everything else reuses the association —
            # the skip is real at trace time (no cond/select executing
            # both branches; see the note in _level_iteration).
            assoc = None
            for i in range(iters):
                T, stats, assoc = step(
                    T, None if i % reassoc == 0 else assoc
                )
        else:
            def body(T, _):
                T2, st, _assoc = step(T)
                return T2, st

            T, stats_seq = jax.lax.scan(body, T, None, length=iters)
            stats = stats_seq[-1]
    return T, stats


@functools.partial(jax.jit, static_argnames=("cam", "cfg"))
def icp_track_batch(
    cam: CameraIntrinsics,
    cfg: IcpConfig,
    T_init: jnp.ndarray,  # (B, 4, 4)
    src: IcpFrame,  # leaves stacked along a leading batch axis
    tgt: IcpFrame,
):
    """vmapped :func:`icp_track` over B frame pairs in ONE program.

    Used by the loop-closure backend to verify all candidate pairs in a
    single batched dispatch instead of B serial device round-trips
    (SURVEY.md §5.7(2) single-host twin; round-2 verdict item 10).
    """
    body = icp_track.__wrapped__  # un-jitted impl; the outer jit compiles it
    return jax.vmap(lambda T0, s, t: body(cam, cfg, T0, s, t))(T_init, src, tgt)
