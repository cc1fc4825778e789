"""Chip smoke test: drive the engine's main path once on one GPU and check it.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # config-5 SLAM on 4 GPUs against 1 GPU only

Everything runs in this one process (a JAX process reserves most of the
card's memory, so a second one could not start). Phases, each of which
raises on failure so that the script exits non-zero:

1. device: the backend must be a GPU. There is no CPU fallback.
2. kernels at real widths, each against its HIGHEST-precision reference
   (float64 NumPy for JtJ): 3d3d scoring and ranking at K=32768 poses x
   N=2048 correspondences with 40% outliers, 2d3d scoring at 8192 x 1024,
   JtJ at 307,200 px (dense 640x480) and 19,200 px (config-3's finest
   level at stride 4), and both RANSAC estimators against ground truth.
3. the main path through the CLI (``cli.main.main``): ``synth`` 60 frames
   at 640x480, ``odom`` with config 3 and the pose graph, ``pair`` in 3d3d
   and 2d3d mode with the on-device detector, and ``slam`` on one device.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_pose_estimation_tpu.cli.main import main as cli_main  # noqa: E402
from rgbd_pose_estimation_tpu.utils.runtime import enable_compile_cache  # noqa: E402

DATA = os.path.join(ROOT, ".smoke_data")

# Tolerances, each with its reason.
# f32 sums over N terms in another order than the reference, with fused
# multiply-adds: per-pose MSAC agrees to ~1e-6 relative; 1e-4 leaves margin.
MSAC_RTOL = 1e-4
# A residual within rounding of the threshold may count on one side in one
# form and on the other side in the other.
COUNT_ATOL = 2
# JtJ is a sum of ~3e5 f32 products; against float64 the error of a tree
# reduction is ~1e-6 of the largest entry, a serial one up to ~1e-4.
JTJ_RTOL = 1e-4
# The benchmark's accuracy gate for both RANSAC estimators (max abs error of
# the 4x4 pose against ground truth).
POSE_ATOL = 0.05
# Config-3 odometry with the pose graph over the 60 synthetic frames tracks
# to ~2e-5 m ATE on the CPU backend; 1 mm leaves room for other rounding
# and still flags a track that slips (the frames move ~1 cm apart).
ODOM_ATE_M = 1e-3
# Config-5 SLAM (odometry, loops, pose graph, BA) over the same sequence:
# ~8e-5 m on the CPU backend.
SLAM_ATE_M = 2e-3
# Sharded BA on 4 devices against 1: reductions split four ways change the
# summation order, so the trajectories agree to rounding, not bitwise.
FOUR_VS_ONE_ATOL = 1e-3


# Real widths: the benchmark's 3d3d shape, config 2's 2d3d shape (2048
# minimal samples x 4 P3P roots against 1024 matches), and the ICP pixel
# counts of a dense 640x480 frame and of config 3's finest level.
SHAPE_3D3D = (32768, 2048)
SHAPE_2D3D = (2048, 1024)
JTJ_PIXELS = (307200, 19200)
FRAMES = ("640", "480", "60")  # synth width, height, frame count


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {jax.default_backend()!r}"
        )
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    log(smi)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _check_scores(name, got, ref):
    (m, c), (mr, cr) = got, ref
    rel = float(jnp.max(jnp.abs(m - mr) / jnp.maximum(jnp.abs(mr), 1e-12)))
    dc = int(jnp.max(jnp.abs(c - cr)))
    log(f"{name}: max rel MSAC err {rel:.3e}, max count diff {dc}")
    assert rel <= MSAC_RTOL, (name, rel)
    assert dc <= COUNT_ATOL, (name, dc)


def _jtj_float64(p, q, n, w):
    """Point-to-plane normal equations in float64 NumPy (the JtJ oracle)."""
    p, q, n, w = (np.asarray(x, np.float64) for x in (p, q, n, w))
    r = np.sum(n * (p - q), axis=-1)
    J = np.concatenate([n, np.cross(p, n), r[:, None], np.ones_like(r)[:, None]], -1)
    A = (J * w[:, None]).T @ J
    return A[:6, :6], A[:6, 6], A[6, 6], A[7, 7]


def phase_kernels() -> None:
    from rgbd_pose_estimation_tpu.core.lie import se3_apply, se3_exp
    from rgbd_pose_estimation_tpu.data.synthetic import synthetic_correspondences
    from rgbd_pose_estimation_tpu.ops.icp_jtj import icp_jtj_jtr
    from rgbd_pose_estimation_tpu.ops.ransac_score import (
        best_pose_3d3d,
        score_poses_2d3d,
        score_poses_2d3d_reference,
        score_poses_3d3d,
        score_poses_3d3d_reference,
    )
    from rgbd_pose_estimation_tpu.ransac.engine import (
        estimate_pose_2d3d,
        estimate_pose_3d3d,
    )
    from rgbd_pose_estimation_tpu.utils.config import RansacConfig

    (K, N), thr = SHAPE_3D3D, 0.05
    p, q, T_gt, _ = synthetic_correspondences(
        jax.random.key(0), n=N, outlier_frac=0.4, noise=0.003
    )
    T = se3_exp(jax.random.normal(jax.random.key(1), (K, 6)) * 0.05)
    T = T.at[K // 3].set(T_gt)
    ref = jax.jit(score_poses_3d3d_reference, static_argnums=3)(T, p, q, thr)
    _check_scores(f"score_3d3d {K}x{N}", score_poses_3d3d(T, p, q, thr), ref)
    best, score = best_pose_3d3d(T, p, q, thr)
    m_ref = np.asarray(ref[0])
    log(f"best_pose_3d3d: index {int(best)}, ref argmin {int(m_ref.argmin())}")
    assert abs(float(score) - m_ref.min()) <= MSAC_RTOL * m_ref.min()

    cfg = RansacConfig(num_hypotheses=K, threshold=thr, refit_rounds=2)
    res = estimate_pose_3d3d(jax.random.key(1), p, q, cfg)
    err = float(jnp.abs(res.pose - T_gt).max())
    log(f"estimate_pose_3d3d K={K} N={N}: pose err {err:.3e}")
    assert err < POSE_ATOL, err

    K2, N2 = SHAPE_2D3D
    pts = p[:N2] + jnp.asarray([0.0, 0.0, 4.0])
    obs3 = se3_apply(T_gt[None], pts[None])[0]
    obs = obs3[:, :2] / obs3[:, 2:3]
    T4 = se3_exp(jax.random.normal(jax.random.key(3), (4 * K2, 6)) * 0.05)
    ref2 = jax.jit(score_poses_2d3d_reference, static_argnums=3)(T4, pts, obs, 0.01)
    _check_scores(f"score_2d3d {4 * K2}x{N2}",
                  score_poses_2d3d(T4, pts, obs, 0.01), ref2)
    res2 = estimate_pose_2d3d(
        jax.random.key(3), pts, obs, RansacConfig(num_hypotheses=K2, threshold=0.01)
    )
    err2 = float(jnp.abs(res2.pose - T_gt).max())
    log(f"estimate_pose_2d3d K={K2}x4 N={N2}: pose err {err2:.3e}")
    assert err2 < POSE_ATOL, err2

    rng = np.random.default_rng(0)
    for M in JTJ_PIXELS:
        pp = rng.normal(size=(M, 3)).astype(np.float32)
        qq = (pp + rng.normal(size=(M, 3)) * 0.01).astype(np.float32)
        nn = rng.normal(size=(M, 3))
        nn = (nn / np.linalg.norm(nn, axis=-1, keepdims=True)).astype(np.float32)
        ww = (rng.uniform(size=M) > 0.3).astype(np.float32)
        ref64 = _jtj_float64(pp, qq, nn, ww)
        out = icp_jtj_jtr(*map(jnp.asarray, (pp, qq, nn, ww)))
        rel = max(
            float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))
            for a, b in zip(out, ref64)
        )
        log(f"icp_jtj_jtr M={M}: max rel err vs float64 {rel:.3e}")
        assert rel <= JTJ_RTOL, (M, rel)


def _cli(argv) -> str:
    """Run one CLI command in this process; returns its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue()
    log(f"$ {' '.join(argv)}\n{out.strip()[-800:]}")
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return out


def _ate(traj_path: str, gt_path: str) -> float:
    from rgbd_pose_estimation_tpu.eval.ate import ate_rmse
    from rgbd_pose_estimation_tpu.eval.traj_io import (
        associate_timestamps,
        read_tum_trajectory,
    )

    ts_e, est = read_tum_trajectory(traj_path)
    ts_g, gt = read_tum_trajectory(gt_path)
    ia, ib = associate_timestamps(ts_e, ts_g)

    def centers(T):
        return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])

    return float(ate_rmse(centers(est[ia]), centers(gt[ib])))


def _synth() -> str:
    shutil.rmtree(DATA, ignore_errors=True)
    data = os.path.join(DATA, "seq")
    w, h, n = FRAMES
    _cli(["synth", "--out", data, "--width", w, "--height", h, "--frames", n])
    return data


def _slam(data: str, devices: int) -> str:
    out = os.path.join(DATA, f"slam{devices}.txt")
    metrics = os.path.join(DATA, f"slam{devices}.jsonl")
    _cli(["slam", "--dataset", data, "--out", out, "--intrinsics",
          "from_dataset", "--mesh-devices", str(devices), "--detector", "tpu",
          "--metrics", metrics])
    with open(metrics) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    dropped = [r["reshard_dropped"] for r in recs if "reshard_dropped" in r]
    log(f"slam on {devices} device(s): reshard_obs_to_blocks dropped {dropped}")
    assert all(d == 0 for d in dropped), dropped
    return out


def phase_main_path() -> None:
    from rgbd_pose_estimation_tpu.core.lie import se3_inverse
    from rgbd_pose_estimation_tpu.eval.traj_io import read_tum_trajectory

    data = _synth()
    gt_path = os.path.join(data, "groundtruth.txt")
    odom = os.path.join(DATA, "odom.txt")
    _cli(["odom", "--dataset", data, "--out", odom, "--config",
          os.path.join(ROOT, "configs", "config3_dense_icp_odometry.yaml"),
          "--intrinsics", "from_dataset", "--pose-graph"])
    ate = _ate(odom, gt_path)
    log(f"odom config 3 + pose graph: ATE {ate:.4e} m (bound {ODOM_ATE_M})")
    assert ate < ODOM_ATE_M, ate

    _, gt = read_tum_trajectory(gt_path)
    a, b = 0, 4
    T_rel = np.asarray(gt[b] @ np.asarray(se3_inverse(jnp.asarray(gt[a]))))
    for mode in ("3d3d", "2d3d"):
        stdout = _cli(["pair", "--dataset", data, "--a", str(a), "--b", str(b),
                       "--mode", mode, "--detector", "tpu",
                       "--intrinsics", "from_dataset"])
        out = json.loads(stdout.strip().splitlines()[-1])
        err = float(np.abs(np.asarray(out["pose"]) - T_rel).max())
        log(f"pair {mode}: pose err {err:.3e} ({out['num_inliers']} inliers)")
        assert err < POSE_ATOL, (mode, err)

    slam = _slam(data, 1)
    ate = _ate(slam, gt_path)
    log(f"slam on 1 device: ATE {ate:.4e} m (bound {SLAM_ATE_M})")
    assert ate < SLAM_ATE_M, ate


def phase_four() -> None:
    from rgbd_pose_estimation_tpu.eval.traj_io import read_tum_trajectory

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    data = _synth()
    _, t4 = read_tum_trajectory(_slam(data, 4))
    _, t1 = read_tum_trajectory(_slam(data, 1))
    diff = float(np.abs(t4 - t1).max())
    log(f"slam 4 devices vs 1: max pose diff {diff:.3e} (bound {FOUR_VS_ONE_ATOL})")
    assert diff <= FOUR_VS_ONE_ATOL, diff


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only config-5 SLAM on 4 GPUs against 1 GPU")
    args = ap.parse_args(argv)
    device = phase_device()
    enable_compile_cache()
    try:
        if args.four:
            phase_four()
        else:
            phase_kernels()
            phase_main_path()
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
