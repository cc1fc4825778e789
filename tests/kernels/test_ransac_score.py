"""Scorer parity tests (SURVEY.md §4.4): the plain scorers against their
HIGHEST-precision einsum references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_pose_estimation_tpu.core.lie import se3_apply, se3_exp
from rgbd_pose_estimation_tpu.ops.ransac_score import (
    best_pose_3d3d,
    score_poses_2d3d,
    score_poses_2d3d_reference,
    score_poses_3d3d,
    score_poses_3d3d_reference,
)


def _poses(seed, k):
    rng = np.random.default_rng(seed)
    return se3_exp(jnp.asarray(rng.normal(size=(k, 6)) * 0.4, jnp.float32))


class TestScore3D3D:
    # Ragged K and N included: the plain form needs no padding.
    @pytest.mark.parametrize("k,n", [(256, 128), (512, 384), (77, 301)])
    def test_plain_matches_reference(self, k, n):
        rng = np.random.default_rng(0)
        T = _poses(1, k)
        p = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
        q = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
        m_ref, c_ref = score_poses_3d3d_reference(T, p, q, 0.1)
        m, c = score_poses_3d3d(T, p, q, 0.1)
        np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(c_ref))

    def test_true_pose_wins(self):
        rng = np.random.default_rng(2)
        T = _poses(3, 256)
        p = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        q = se3_apply(T[17][None], p[None])[0]
        msac, count = score_poses_3d3d_reference(T, p, q, 0.05)
        assert int(jnp.argmin(msac)) == 17
        assert float(count[17]) == 256.0

    def test_all_outlier_frame(self):
        # Edge tile from the survey test plan: every correspondence bogus.
        T = _poses(4, 256)
        p = jnp.zeros((128, 3))
        q = jnp.full((128, 3), 1e6)
        msac, count = score_poses_3d3d_reference(T, p, q, 0.05)
        assert float(count.max()) == 0.0
        np.testing.assert_allclose(np.asarray(msac), 128 * 0.05**2, rtol=1e-5)

    def test_padding_sentinel_preserves_order(self):
        rng = np.random.default_rng(5)
        T = _poses(6, 256)
        p = jnp.asarray(rng.normal(size=(100, 3)), jnp.float32)
        q = se3_apply(T[3][None], p[None])[0]
        p_pad = jnp.pad(p, ((0, 28), (0, 0)))
        q_pad = jnp.pad(q, ((0, 28), (0, 0)), constant_values=1e6)
        m0, _ = score_poses_3d3d_reference(T, p, q, 0.05)
        m1, c1 = score_poses_3d3d_reference(T, p_pad, q_pad, 0.05)
        assert int(jnp.argmin(m0)) == int(jnp.argmin(m1)) == 3
        np.testing.assert_array_equal(
            np.argsort(np.asarray(m0)), np.argsort(np.asarray(m1))
        )


class TestBestPose:
    def test_best_pose_finds_true_winner(self):
        rng = np.random.default_rng(2)
        T = _poses(3, 512)
        p = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        q = se3_apply(T[41][None], p[None])[0]
        best, score = best_pose_3d3d(T, p, q, 0.05)
        assert int(best) == 41
        assert float(score) < 1e-6

    def test_best_pose_nan_guard(self):
        # A NaN pose must never win.
        rng = np.random.default_rng(3)
        T = np.array(_poses(4, 256))  # writable copy
        p = jnp.asarray(rng.normal(size=(128, 3)), jnp.float32)
        q = se3_apply(jnp.asarray(T[7])[None], p[None])[0]
        T[9] = np.nan
        best, score = best_pose_3d3d(jnp.asarray(T), p, q, 0.05)
        assert int(best) == 7
        assert np.isfinite(float(score))


class TestScore2D3D:
    def test_plain_matches_reference(self):
        rng = np.random.default_rng(0)
        T = _poses(1, 256)
        pts = jnp.asarray(rng.normal(size=(128, 3)), jnp.float32) + jnp.asarray(
            [0, 0, 4.0]
        )
        obs = jnp.asarray(rng.normal(size=(128, 2)) * 0.3, jnp.float32)
        m_ref, c_ref = score_poses_2d3d_reference(T, pts, obs, 0.02)
        m, c = score_poses_2d3d(T, pts, obs, 0.02)
        np.testing.assert_allclose(
            np.asarray(m), np.asarray(m_ref), rtol=1e-4, atol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(c), np.asarray(c_ref))

    def test_behind_camera_is_outlier(self):
        T = jnp.eye(4)[None].repeat(256, axis=0)
        pts = jnp.asarray([[0.0, 0.0, -1.0]] * 128)
        obs = jnp.zeros((128, 2))
        for score in (score_poses_2d3d, score_poses_2d3d_reference):
            msac, count = score(T, pts, obs, 0.1)
            assert float(count.max()) == 0.0


class TestPackedPoses:
    """Packed (K, 12) pose rows: the 2d3d engine scores them and gathers
    its winner from them."""

    def test_pack_unpack_roundtrip(self):
        from rgbd_pose_estimation_tpu.ops.ransac_score import (
            pack_poses,
            unpack_pose,
        )

        T = _poses(11, 64)
        P = pack_poses(T)
        assert P.shape == (64, 12)
        for k in (0, 17, 63):
            np.testing.assert_array_equal(
                np.asarray(unpack_pose(P[k])), np.asarray(T[k])
            )

    def test_score_2d3d_accepts_packed_rows(self):
        from rgbd_pose_estimation_tpu.ops.ransac_score import pack_poses

        rng = np.random.default_rng(4)
        T = _poses(5, 256)
        pts = jnp.asarray(rng.normal(size=(128, 3)) + [0, 0, 4], jnp.float32)
        obs3 = se3_apply(T[9][None], pts[None])[0]
        obs = obs3[:, :2] / obs3[:, 2:3]
        m_mat, c_mat = score_poses_2d3d(T, pts, obs, 0.02)
        m_pak, c_pak = score_poses_2d3d(pack_poses(T), pts, obs, 0.02)
        np.testing.assert_allclose(np.asarray(m_pak), np.asarray(m_mat))
        np.testing.assert_array_equal(np.asarray(c_pak), np.asarray(c_mat))

    def test_best_pose_return_pose_is_exact(self):
        """return_pose hands back BITWISE the winning row of T."""
        rng = np.random.default_rng(6)
        T = _poses(7, 512)
        p = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        q = se3_apply(T[123][None], p[None])[0]
        b, s, Tw = best_pose_3d3d(T, p, q, 0.05, return_pose=True)
        assert int(b) == 123
        np.testing.assert_array_equal(np.asarray(Tw), np.asarray(T[123]))
