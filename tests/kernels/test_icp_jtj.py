"""Parity tests for the JtJ/Jtr reduction (ops/icp_jtj.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_pose_estimation_tpu.ops.icp_jtj import (
    icp_jtj_jtr,
    icp_jtj_jtr_reference,
)


def _data(seed, m):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(m, 3))
    q = p + rng.normal(size=(m, 3)) * 0.01
    n = rng.normal(size=(m, 3))
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    w = (rng.uniform(0, 1, size=(m,)) > 0.3).astype(np.float64)
    return p, q, n, w


def _float64(p, q, n, w):
    r = np.sum(n * (p - q), axis=-1)
    J = np.concatenate([n, np.cross(p, n), r[:, None], np.ones((len(r), 1))], -1)
    A = (J * w[:, None]).T @ J
    return A[:6, :6], A[:6, 6], A[6, 6], A[7, 7]


def _f32(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


class TestIcpJtJ:
    @pytest.mark.parametrize("fn", [icp_jtj_jtr, icp_jtj_jtr_reference],
                             ids=["plain", "reference"])
    def test_matches_float64(self, fn):
        data = _data(1, 8 * 128 * 3 + 5)
        out = fn(*_f32(*data))
        for a, b in zip(out, _float64(*data)):
            np.testing.assert_allclose(np.asarray(a), b, rtol=2e-4, atol=1e-3)

    def test_jtj_is_spd_and_consistent(self):
        JtJ, Jtr, err, wsum = icp_jtj_jtr(*_f32(*_data(2, 4096)))
        # Symmetric positive semi-definite by construction.
        np.testing.assert_allclose(np.asarray(JtJ), np.asarray(JtJ.T), rtol=1e-5)
        ev = np.linalg.eigvalsh(np.asarray(JtJ))
        assert ev.min() > -1e-4
        assert float(wsum) > 0

    def test_zero_weights_zero_output(self):
        p, q, n, w = _data(3, 2048)
        JtJ, Jtr, err, wsum = icp_jtj_jtr(*_f32(p, q, n, np.zeros_like(w)))
        np.testing.assert_allclose(np.asarray(JtJ), 0.0)
        assert float(wsum) == 0.0
