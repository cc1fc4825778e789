"""Distributed-parity tests on the virtual 8-device CPU mesh (SURVEY.md §4.3):
the shard_map'd paths must reproduce single-device numbers to ~1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_pose_estimation_tpu.ba.schur import (
    BAProblem,
    ba_step,
    make_synthetic_ba_problem,
)
from rgbd_pose_estimation_tpu.core.lie import se3_exp
from rgbd_pose_estimation_tpu.ops.icp_jtj import icp_jtj_jtr
from rgbd_pose_estimation_tpu.ops.ransac_score import score_poses_3d3d
from rgbd_pose_estimation_tpu.parallel.mesh import (
    check_config_consistency,
    make_mesh,
)
from rgbd_pose_estimation_tpu.parallel.sharded import (
    ba_step_sharded,
    icp_jtj_sharded,
    ring_similarity,
    score_poses_3d3d_sharded,
)
from rgbd_pose_estimation_tpu.utils.config import BAConfig, MeshConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


@pytest.fixture(scope="module", params=[(1, 8), (2, 4), (8, 1)])
def mesh(request):
    h, c = request.param
    return make_mesh(MeshConfig(hosts=h, chips_per_host=c))


class TestShardedParity:
    def test_ransac_scoring_matches(self, mesh):
        rng = np.random.default_rng(0)
        T = se3_exp(jnp.asarray(rng.normal(size=(512, 6)) * 0.3, jnp.float32))
        p = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        q = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        m0, c0 = score_poses_3d3d(T, p, q, 0.05)
        m1, c1 = score_poses_3d3d_sharded(mesh, T, p, q, 0.05)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c0))

    def test_icp_jtj_matches(self, mesh):
        rng = np.random.default_rng(1)
        m = 8 * 128 * 8
        p = jnp.asarray(rng.normal(size=(m, 3)), jnp.float32)
        q = p + 0.01
        n = jnp.asarray(rng.normal(size=(m, 3)), jnp.float32)
        n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
        w = jnp.ones(m)
        ref = icp_jtj_jtr(p, q, n, w)
        shd = icp_jtj_sharded(mesh, p, q, n, w)
        for a, b in zip(shd, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-3)

    def test_ba_step_matches(self, mesh):
        prob, _, _ = make_synthetic_ba_problem(jax.random.key(0), num_points=200, obs_per_point=4)
        cfg = BAConfig(cg_iters=15)
        out0, cost0 = ba_step(prob, cfg)
        out1, cost1 = ba_step_sharded(mesh, prob, cfg)
        np.testing.assert_allclose(float(cost1), float(cost0), rtol=1e-5)
        # f32 reduction order differs across shards; CG amplifies it a bit.
        np.testing.assert_allclose(
            np.asarray(out1.poses), np.asarray(out0.poses), atol=2e-4
        )
        np.testing.assert_allclose(
            np.asarray(out1.points), np.asarray(out0.points), atol=1e-3
        )

    def test_ring_similarity_matches_dense(self, mesh):
        rng = np.random.default_rng(2)
        desc = jnp.asarray(rng.normal(size=(64, 32)), jnp.float32)
        dense = np.asarray(desc @ desc.T)
        ring = np.asarray(ring_similarity(mesh, desc))
        np.testing.assert_allclose(ring, dense, rtol=1e-5, atol=1e-5)

    def test_config_consistency_check(self, mesh):
        assert check_config_consistency(mesh, BAConfig())
