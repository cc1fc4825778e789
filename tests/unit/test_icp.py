import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu.core.lie import se3_exp, se3_inverse
from rgbd_pose_estimation_tpu.data.synthetic import synthetic_depth_scene
from rgbd_pose_estimation_tpu.icp import icp_track, make_icp_frame
from rgbd_pose_estimation_tpu.utils.config import IcpConfig

# Small camera for fast CPU tests; geometry matches TUM aspect ratio.
CAM = CameraIntrinsics(160.0, 160.0, 79.5, 59.5, 160, 120)
CFG = IcpConfig(levels=3, iters_per_level=(4, 5, 8))


def _frames(xi):
    """Render the analytic scene from identity and from exp(xi)."""
    T0 = jnp.eye(4)
    T1 = se3_exp(jnp.asarray(xi, jnp.float32))
    d0, _ = synthetic_depth_scene(CAM, T0)
    d1, _ = synthetic_depth_scene(CAM, T1)
    f0 = make_icp_frame(CAM, d0, CFG)
    f1 = make_icp_frame(CAM, d1, CFG)
    # Ground-truth source(frame0)→target(frame1) camera transform:
    # x_c1 = T1 x_w and x_c0 = T0 x_w = x_w  →  T_01 = T1 T0^-1 = T1.
    return f0, f1, T1


class TestIcp:
    def test_identity_stays_identity(self):
        f0, _, _ = _frames([0.0] * 6)
        T, stats = icp_track(CAM, CFG, jnp.eye(4), f0, f0)
        np.testing.assert_allclose(np.asarray(T), np.eye(4), atol=1e-4)
        assert float(stats[1]) > 1000  # plenty of associations

    @pytest.mark.parametrize(
        "xi",
        [
            [0.01, -0.005, 0.008, 0.004, -0.006, 0.003],
            [-0.02, 0.01, 0.015, -0.008, 0.005, 0.01],
        ],
    )
    def test_recovers_small_motion_from_identity_init(self, xi):
        f0, f1, T_gt = _frames(xi)
        T, stats = icp_track(CAM, CFG, jnp.eye(4), f0, f1)
        err = np.abs(np.asarray(T) - np.asarray(T_gt)).max()
        assert err < 2e-3, err

    def test_larger_motion_with_pyramid(self):
        xi = [0.05, 0.03, -0.04, 0.02, -0.015, 0.02]
        f0, f1, T_gt = _frames(xi)
        T, _ = icp_track(CAM, CFG, jnp.eye(4), f0, f1)
        err = np.abs(np.asarray(T) - np.asarray(T_gt)).max()
        assert err < 5e-3, err

    def test_no_overlap_takes_no_wild_step(self):
        # Target far away: associations gated out → pose stays near init.
        f0, _, _ = _frames([0.0] * 6)
        T_far = se3_exp(jnp.asarray([5.0, 0, 0, 0, 0, 0], jnp.float32))
        d_far, _ = synthetic_depth_scene(CAM, T_far)
        f_far = make_icp_frame(CAM, d_far, CFG)
        T, stats = icp_track(CAM, CFG, jnp.eye(4), f0, f_far)
        assert np.isfinite(np.asarray(T)).all()
        # Translation must not explode beyond the scene scale.
        assert np.linalg.norm(np.asarray(T[:3, 3])) < 1.0

    def test_deterministic(self):
        f0, f1, _ = _frames([0.01, 0.0, 0.0, 0.0, 0.005, 0.0])
        a, _ = icp_track(CAM, CFG, jnp.eye(4), f0, f1)
        b, _ = icp_track(CAM, CFG, jnp.eye(4), f0, f1)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestAssociationModes:
    """nearest (packed one-gather) vs bilinear association parity."""

    def test_both_modes_recover_pose(self):
        import dataclasses

        from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
        from rgbd_pose_estimation_tpu.core.lie import se3_exp, se3_log
        from rgbd_pose_estimation_tpu.data.synthetic import synthetic_depth_scene
        from rgbd_pose_estimation_tpu.icp.dense import icp_track, make_icp_frame
        from rgbd_pose_estimation_tpu.utils.config import IcpConfig

        cam = CameraIntrinsics(120.0, 120.0, 79.5, 59.5, 160, 120)
        T_gt = se3_exp(jnp.asarray([0.01, -0.008, 0.005, 0.01, -0.012, 0.008]))
        d0, _ = synthetic_depth_scene(cam, jnp.eye(4))
        d1, _ = synthetic_depth_scene(cam, T_gt)
        errs = {}
        for assoc in ("nearest", "bilinear"):
            cfg = IcpConfig(association=assoc)
            f0 = make_icp_frame(cam, d0, cfg)
            f1 = make_icp_frame(cam, d1, cfg)
            # source = f1 (camera at T_gt), target = f0 (identity):
            # x_f0 = T_gt^-1 x_f1, so the expected estimate is inv(T_gt).
            T, stats = icp_track(cam, cfg, jnp.eye(4), f1, f0)
            err = float(jnp.abs(se3_log(T @ T_gt)).max())
            errs[assoc] = err
            assert err < 2e-3, (assoc, err)
        # The fast path must not be meaningfully less accurate.
        assert errs["nearest"] < max(5 * errs["bilinear"], 1e-3), errs


def test_icp_track_batch_matches_serial():
    """icp_track_batch (the batched loop-verify path) == per-pair icp_track."""
    import jax

    from rgbd_pose_estimation_tpu.data.synthetic import synthetic_sequence
    from rgbd_pose_estimation_tpu.icp.dense import (
        icp_track,
        icp_track_batch,
        make_icp_frame,
    )
    from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
    from rgbd_pose_estimation_tpu.utils.config import IcpConfig

    cam = CameraIntrinsics(80.0, 80.0, 39.5, 29.5, 80, 60)
    cfg = IcpConfig(levels=2, iters_per_level=(4, 6))
    _, depths, _ = synthetic_sequence(cam, jax.random.key(2), 4, 0.01)
    frames = [make_icp_frame(cam, d, cfg) for d in depths]
    pairs = [(0, 1), (1, 2), (2, 3), (0, 2)]
    T_init = jnp.stack([jnp.eye(4)] * len(pairs))
    src = jax.tree.map(lambda *xs: jnp.stack(xs), *[frames[b] for _, b in pairs])
    tgt = jax.tree.map(lambda *xs: jnp.stack(xs), *[frames[a] for a, _ in pairs])
    Tb, sb = icp_track_batch(cam, cfg, T_init, src, tgt)
    for k, (a, b) in enumerate(pairs):
        T1, s1 = icp_track(cam, cfg, jnp.eye(4), frames[b], frames[a])
        np.testing.assert_allclose(np.asarray(Tb[k]), np.asarray(T1), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sb[k]), np.asarray(s1), rtol=1e-4)


class TestPhotometric:
    """DVO-style intensity residual (round-2 verdict item 8): on a flat
    textured wall, point-to-plane ICP is blind to in-plane motion (the
    plane constrains only 3 of 6 DoF); the photometric term recovers it."""

    @staticmethod
    def _flat_wall(cam, T_wc, plane_z=3.0):
        import jax.numpy as jnp

        from rgbd_pose_estimation_tpu.core.camera import pixel_grid
        from rgbd_pose_estimation_tpu.core.lie import matrix_to_rt
        from rgbd_pose_estimation_tpu.data.synthetic import _texture

        R, t = matrix_to_rt(T_wc)
        center = -jnp.einsum("ji,j->i", R, t)
        uv = pixel_grid(cam)
        d_cam = jnp.stack(
            [
                (uv[..., 0] - cam.cx) / cam.fx,
                (uv[..., 1] - cam.cy) / cam.fy,
                jnp.ones_like(uv[..., 0]),
            ],
            axis=-1,
        )
        d_world = jnp.einsum("ji,hwj->hwi", R, d_cam)
        s = (plane_z - center[2]) / d_world[..., 2]
        hits = center + s[..., None] * d_world
        intensity = _texture(hits)
        return s, intensity  # unit-z rays: s == camera depth

    def test_photometric_fixes_flat_wall(self):
        import jax

        from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
        from rgbd_pose_estimation_tpu.core.lie import se3_exp
        from rgbd_pose_estimation_tpu.icp.dense import icp_track, make_icp_frame
        from rgbd_pose_estimation_tpu.utils.config import IcpConfig

        w, h = 160, 120
        cam = CameraIntrinsics(160.0, 160.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
        # In-plane motion: x/y translation + roll — exactly the null space
        # of point-to-plane on a fronto-parallel wall.
        xi = jnp.asarray([0.02, -0.015, 0.0, 0.0, 0.0, 0.01], jnp.float32)
        T_gt = se3_exp(xi)  # camera A → camera B... (world=A frame)
        dA, iA = self._flat_wall(cam, jnp.eye(4))
        dB, iB = self._flat_wall(cam, T_gt)

        geo_cfg = IcpConfig(levels=2, iters_per_level=(6, 8))
        ph_cfg = IcpConfig(
            levels=2, iters_per_level=(6, 8), photometric_weight=1.0
        )
        fA = make_icp_frame(cam, dA, geo_cfg, iA)
        fB = make_icp_frame(cam, dB, geo_cfg, iB)

        # icp_track(cam, cfg, T, src=B, tgt=A) estimates B→A = T_gt^-1...
        # convention: process() passes (frame_new, frame_kf); T maps
        # source→target. Here source=B, target=A, truth = inv(T_gt)?
        # B frame sees point x_B = T_gt x_A → x_A = T_gt^-1 x_B.
        from rgbd_pose_estimation_tpu.core.lie import se3_inverse

        T_true = np.asarray(se3_inverse(T_gt))

        T_geo, _ = icp_track(cam, geo_cfg, jnp.eye(4), fB, fA)
        T_ph, _ = icp_track(cam, ph_cfg, jnp.eye(4), fB, fA)

        err_geo = np.abs(np.asarray(T_geo) - T_true).max()
        err_ph = np.abs(np.asarray(T_ph) - T_true).max()
        # Depth-only is blind to the in-plane motion (stays ~at identity).
        assert err_geo > 0.01, f"expected depth-only failure, err={err_geo}"
        # The combined cost recovers it.
        assert err_ph < 0.003, f"photometric err={err_ph}"

    def test_photometric_keeps_easy_scene_accuracy(self):
        """On a well-conditioned scene the photo term must not hurt."""
        import jax

        from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
        from rgbd_pose_estimation_tpu.core.lie import se3_log, se3_inverse
        from rgbd_pose_estimation_tpu.data.synthetic import synthetic_sequence
        from rgbd_pose_estimation_tpu.icp.dense import icp_track, make_icp_frame
        from rgbd_pose_estimation_tpu.utils.config import IcpConfig

        cam = CameraIntrinsics(80.0, 80.0, 39.5, 29.5, 80, 60)
        poses, depths, intens = synthetic_sequence(cam, jax.random.key(4), 2, 0.01)
        cfg = IcpConfig(levels=2, iters_per_level=(4, 6), photometric_weight=0.5)
        f0 = make_icp_frame(cam, depths[0], cfg, intens[0])
        f1 = make_icp_frame(cam, depths[1], cfg, intens[1])
        T, _ = icp_track(cam, cfg, jnp.eye(4), f1, f0)
        T_true = poses[0] @ np.asarray(se3_inverse(poses[1]))
        err = np.abs(
            np.asarray(se3_log(jnp.asarray(np.asarray(T) @ np.linalg.inv(np.asarray(T_true)), jnp.float32)))
        ).max()
        assert err < 2e-3, err


class TestSourceStride:
    """Gather-index thinning (IcpConfig.source_stride): accuracy parity.

    Production configs thin the SOURCE residual sample to cut the
    association gather and the reduction per GN step. Point-to-plane ICP
    is overdetermined enough that stride-2 sampling must not move the pose.
    """

    def test_stride_matches_dense_pose(self):
        xi = [0.012, -0.006, 0.009, 0.005, -0.004, 0.006]
        f0, f1, T_gt = _frames(xi)
        cfg_s = IcpConfig(
            levels=3, iters_per_level=(4, 5, 8), source_stride=(2, 2, 1)
        )
        T_dense, _ = icp_track(CAM, CFG, jnp.eye(4), f0, f1)
        T_strided, stats = icp_track(CAM, cfg_s, jnp.eye(4), f0, f1)
        err_gt = np.abs(np.asarray(T_strided) - np.asarray(T_gt)).max()
        err_pair = np.abs(np.asarray(T_strided) - np.asarray(T_dense)).max()
        assert err_gt < 2e-3, err_gt
        assert err_pair < 1e-3, err_pair
        # The weight-sum drops roughly stride^2-fold at the finest level.
        assert float(stats[1]) > 100


class TestReassocEvery:
    def test_fixed_correspondence_inner_steps_track(self):
        """reassoc_every=2 (fixed-correspondence inner GN steps) must track
        the synthetic warped scene to the same tolerance as the default
        every-iteration association."""
        import dataclasses

        cam = CameraIntrinsics(
            fx=80.0, fy=80.0, cx=39.5, cy=29.5, width=80, height=60
        )
        T_true = se3_exp(jnp.asarray([0.01, -0.005, 0.008, 0.004, -0.006, 0.005]))
        d0, _ = synthetic_depth_scene(cam, jnp.eye(4))
        d1, _ = synthetic_depth_scene(cam, T_true)
        for k in (1, 2):
            cfg = IcpConfig(reassoc_every=k)
            src = make_icp_frame(cam, d1, cfg)
            tgt = make_icp_frame(cam, d0, cfg)
            T, _ = icp_track(cam, cfg, jnp.eye(4), src, tgt)
            err = float(jnp.max(jnp.abs(T - jnp.linalg.inv(T_true))))
            assert err < 5e-3, (k, err)
