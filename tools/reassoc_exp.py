"""Association-reuse experiment for the ICP gather (VERDICT r2 item 10).

Classic ICP alternation permits several fixed-correspondence minimize
steps per association (``IcpConfig.reassoc_every``), so the gather runs
less often.

This script measures, on the 10-frame 640x480 hard-mode (Kinect-degraded
handheld) sequence at the config-3 stride:  ATE RMSE + in-program track
time for reassoc_every in {1, 2, 3}. Record the table in PERF.md with the
card's name and power limit.

Run: python tools/reassoc_exp.py   (on the GPU, nothing else running)
"""

from __future__ import annotations

import dataclasses
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from tools.roofline import timeit_scan

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu.data.synthetic import synthetic_sequence_hard
from rgbd_pose_estimation_tpu.eval.ate import ate_rmse
from rgbd_pose_estimation_tpu.icp.dense import icp_track, make_icp_frame
from rgbd_pose_estimation_tpu.utils.config import IcpConfig


def run(H=480, W=640, n_frames=10, stride=(4, 4, 2)):
    cam = CameraIntrinsics(
        fx=525.0, fy=525.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H
    )
    poses, depths, _, _ = synthetic_sequence_hard(
        cam, jax.random.key(5), n_frames
    )
    print(f"hard sequence: {n_frames} frames {W}x{H}, stride={stride}")
    print("| reassoc_every | ATE RMSE | track ms | tracks/s |")
    print("|---|---|---|---|")
    for k in (1, 2, 3):
        cfg = IcpConfig(source_stride=stride, reassoc_every=k)
        frames = [make_icp_frame(cam, depths[i], cfg) for i in range(n_frames)]
        # odometry: frame-to-frame accumulate
        T_acc = [np.eye(4)]
        for i in range(1, n_frames):
            T, _ = icp_track(cam, cfg, jnp.eye(4), frames[i], frames[i - 1])
            T_acc.append(T_acc[-1] @ np.asarray(T))
        est_pos = np.stack(T_acc)[:, :3, 3]
        # GT is world->camera; camera position = inv(gt)[:3, 3].
        gt_pos = np.stack([np.linalg.inv(g)[:3, 3] for g in np.asarray(poses)])
        ate = ate_rmse(est_pos, gt_pos)

        def step(T):
            T2, _ = icp_track.__wrapped__(cam, cfg, T, frames[1], frames[0])
            return T2

        s = timeit_scan(step, jnp.eye(4), n1=2, n2=12)
        print(f"| {k} | {float(ate)*1e3:.2f} mm | {s*1e3:.2f} | {1/s:.0f} |")


if __name__ == "__main__":
    run()
