"""Headline benchmark: RANSAC hypothesize+score throughput on one device.

Runs the full batched estimator (PROSAC sample → Horn hypotheses → MSAC
scoring → argmin → weighted refit) as one jit region and reports hypotheses
scored per second.

Baseline (BASELINE.json:5): the north-star demands ">1000 RANSAC
hypotheses/frame scored in real time" — at TUM's 30 Hz that is 30,000
hypotheses/s, which we use as the baseline denominator.

Timing protocol: the headline is **scan-chained in-program** — one compiled
program runs the estimator n times under ``lax.scan`` with a data
dependence through the carry, and the slope between two n cancels the
per-dispatch cost. Dispatch-pipelined and fully-synchronous numbers are
reported in ``detail`` for context.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "hypotheses/s", "vs_baseline": N/30000}
"""

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from rgbd_pose_estimation_tpu.data.synthetic import synthetic_correspondences
from rgbd_pose_estimation_tpu.ransac.engine import estimate_pose_3d3d
from rgbd_pose_estimation_tpu.utils.config import RansacConfig
from rgbd_pose_estimation_tpu.utils.runtime import enable_compile_cache
from tools.roofline import SubResolutionError, timeit_scan

BASELINE_HYP_PER_S = 30_000.0  # 1000 hyp/frame x 30 fps (north-star)


def main():
    enable_compile_cache()
    # K=32768 hypotheses per estimate: throughput scales with batch size.
    cfg = RansacConfig(
        num_hypotheses=32768, threshold=0.05, refit_rounds=2, solver="horn"
    )
    n_corr = 2048

    p, q, T_gt, _ = synthetic_correspondences(
        jax.random.key(0), n=n_corr, outlier_frac=0.4, noise=0.003
    )
    p = jax.device_put(p)
    q = jax.device_put(q)

    # Warm up / compile (excluded from timing).
    key = jax.random.key(1)
    res = estimate_pose_3d3d(key, p, q, cfg)
    jax.block_until_ready(res.pose)

    # Sanity: the estimate must actually be right, or the speed is
    # meaningless.
    err = float(jnp.abs(res.pose - T_gt).max())
    assert err < 0.05, f"benchmark estimator inaccurate: err={err}"

    # Headline: in-program per-estimate time. The chain feeds the previous
    # estimate's score back into the correspondences (tiny elementwise op)
    # so iterations serialize and nothing is elided.
    def est_step(pc):
        r = estimate_pose_3d3d(key, pc, q, cfg)
        return pc + 1e-30 * r.score

    # Best of 3 slopes. All samples are published in ``detail`` so
    # run-to-run variance stays visible next to the min; a sample the
    # resolution guard rejects (tools/roofline.py::timeit_scan) is dropped
    # rather than published.
    def best_of(step_fn, x, n: int = 3):
        samples = []
        for _ in range(n):
            try:
                samples.append(
                    timeit_scan(step_fn, x, n1=2, n2=12, min_delta_s=8e-3)
                )
            except SubResolutionError:
                # ONLY the resolution guard is dropped — a device
                # RuntimeError (XlaRuntimeError) must propagate, not be
                # misreported as a timing-resolution problem.
                continue
        if not samples:
            raise RuntimeError("every timing sample fell below resolution")
        return min(samples), [round(s * 1e3, 3) for s in samples]

    dt_prog, prog_samples = best_of(est_step, p)
    hyp_per_s = cfg.num_hypotheses / dt_prog

    # Context: pipelined dispatch (one sync at the end) and full-sync modes.
    iters = 30
    keys = jax.random.split(jax.random.key(2), iters)
    for i in range(iters):
        res = estimate_pose_3d3d(keys[i], p, q, cfg)
    jax.block_until_ready(res.pose)
    t0 = time.perf_counter()
    for i in range(iters):
        res = estimate_pose_3d3d(keys[i], p, q, cfg)
    jax.block_until_ready(res.pose)
    dt_pipe = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for i in range(5):
        r2 = estimate_pose_3d3d(keys[i], p, q, cfg)
        jax.block_until_ready(r2.pose)
    dt_sync = (time.perf_counter() - t0) / 5

    # 2d3d (P3P) estimator at the config-2 class shape.
    from rgbd_pose_estimation_tpu.core.lie import se3_apply
    from rgbd_pose_estimation_tpu.ransac.engine import estimate_pose_2d3d

    cfg2 = RansacConfig(num_hypotheses=2048, threshold=0.01)
    pts = p + jnp.asarray([0.0, 0.0, 4.0])
    obs_full = se3_apply(T_gt[None], pts[None])[0]
    obs = obs_full[:, :2] / obs_full[:, 2:3]
    r2 = estimate_pose_2d3d(jax.random.key(3), pts[:1024], obs[:1024], cfg2)
    jax.block_until_ready(r2.pose)
    err2 = float(jnp.abs(r2.pose - T_gt).max())
    assert err2 < 0.05, f"2d3d benchmark estimator inaccurate: err={err2}"

    def est2_step(pc):
        r = estimate_pose_2d3d(jax.random.key(3), pc, obs[:1024], cfg2)
        return pc + 1e-30 * r.score

    dt_2d3d, samples_2d3d = best_of(est2_step, pts[:1024])

    # Second north-star kernel: dense-ICP track at full 640x480, in-program
    # (3-level pyramid, packed nearest association), at the dense setting
    # ((5,7,10) iterations) and the config-3 production setting (stride +
    # reassoc k=2 + the (3,4,6) iteration schedule).
    from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
    from rgbd_pose_estimation_tpu.core.lie import se3_exp
    from rgbd_pose_estimation_tpu.data.synthetic import synthetic_depth_scene
    from rgbd_pose_estimation_tpu.icp.dense import icp_track, make_icp_frame
    from rgbd_pose_estimation_tpu.utils.config import IcpConfig

    cam = CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480)
    T_gt = se3_exp(jnp.asarray([0.01, -0.008, 0.005, 0.01, -0.012, 0.008]))
    da, _ = synthetic_depth_scene(cam, jnp.eye(4))
    db, _ = synthetic_depth_scene(cam, T_gt)

    icp_ms = {}
    for name, stride, reassoc, iters in (
        ("dense", (1, 1, 1), 1, (5, 7, 10)),
        # matches configs/config3 (stride, reassoc k=2, (3,4,6) iterations)
        ("config3", (4, 4, 2), 2, (3, 4, 6)),
    ):
        icfg = IcpConfig(downscale=1, source_stride=stride,
                         reassoc_every=reassoc, iters_per_level=iters)
        mk = jax.jit(lambda d: make_icp_frame(cam, d, icfg))
        fa, fb = mk(da), mk(db)
        out = icp_track(cam, icfg, jnp.eye(4), fb, fa)
        icp_err = float(jnp.abs(out[0] @ T_gt - jnp.eye(4)).max())
        assert icp_err < 0.05, f"icp benchmark inaccurate ({name}): {icp_err}"
        body = icp_track.__wrapped__

        def track_step(T, _icfg=icfg, _fa=fa, _fb=fb):
            T2, _ = body(cam, _icfg, T, _fb, _fa)
            return T2

        s, icp_samples = best_of(track_step, jnp.eye(4), n=2)
        icp_ms[name] = s * 1000.0
        icp_ms[name + "_samples"] = icp_samples

    # Belt-and-braces on top of the timeit_scan resolution guard: nothing
    # non-positive can ever reach the published record (round-4 Weak #1).
    for label, val in [("in_program", dt_prog), ("2d3d", dt_2d3d),
                       *((k, v) for k, v in icp_ms.items()
                         if not k.endswith("_samples"))]:
        assert val > 0, f"non-positive time for {label}: {val}"

    print(
        json.dumps(
            {
                "metric": "ransac_hypotheses_per_s",
                "value": round(hyp_per_s, 1),
                "unit": "hypotheses/s",
                "vs_baseline": round(hyp_per_s / BASELINE_HYP_PER_S, 3),
                "detail": {
                    "num_hypotheses": cfg.num_hypotheses,
                    "num_correspondences": n_corr,
                    "ms_per_estimate_in_program": round(dt_prog * 1000.0, 3),
                    "ms_in_program_samples": prog_samples,
                    "ms_2d3d_samples": samples_2d3d,
                    "ms_per_estimate_pipelined": round(dt_pipe * 1000.0, 3),
                    "ms_per_estimate_sync": round(dt_sync * 1000.0, 3),
                    "pose_max_err": round(err, 5),
                    "ms_estimate_2d3d_p3p_8192poses": round(dt_2d3d * 1e3, 3),
                    "pose_max_err_2d3d": round(err2, 5),
                    "icp_track_640x480_ms_dense": round(icp_ms["dense"], 2),
                    "icp_track_640x480_fps_dense": round(
                        1000.0 / icp_ms["dense"], 1
                    ),
                    "icp_track_640x480_ms_config3": round(icp_ms["config3"], 2),
                    "icp_track_640x480_fps_config3": round(
                        1000.0 / icp_ms["config3"], 1
                    ),
                    "icp_ms_samples_dense": icp_ms["dense_samples"],
                    "icp_ms_samples_config3": icp_ms["config3_samples"],
                    "backend": jax.default_backend(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
