"""Photometric-term cost/accuracy experiment (round-4 verdict Weak #3).

The DVO-style intensity residual rides the JtJ reduction
(icp/dense.py) and provably fixes the flat-wall geometric degeneracy
(tests/unit/test_icp.py::test_photometric_*), but no driver config ships a
nonzero ``photometric_weight`` — this script closes the decision with
data, the same discipline as the reassoc experiment (tools/reassoc_exp.py).

Measures, on the 10-frame 640x480 hard-mode (Kinect-degraded handheld)
sequence at the config-3 stride + reassoc settings: ATE RMSE + in-program
track time for photometric_weight in {0, 0.1, 0.5}. Record the table in
PERF.md with the card's name and power limit.

Run: python tools/photometric_exp.py   (on the GPU, nothing else running)
"""

from __future__ import annotations

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


def run(H=480, W=640, n_frames=10, stride=(4, 4, 2), reassoc=2,
        weights=(0.0, 0.1, 0.5), seeds=(5, 6, 7)):
    cam = CameraIntrinsics(
        fx=525.0, fy=525.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H
    )
    print(f"hard sequence: {n_frames} frames {W}x{H}, stride={stride}, "
          f"reassoc_every={reassoc}, seeds={list(seeds)}")
    print("| photometric_weight | ATE RMSE (per seed, mm) | track ms | tracks/s |")
    print("|---|---|---|---|")
    for wph in weights:
        cfg = IcpConfig(source_stride=stride, reassoc_every=reassoc,
                        photometric_weight=wph)
        ates = []
        t_track = None
        for seed in seeds:
            poses, depths, intens, _ = synthetic_sequence_hard(
                cam, jax.random.key(seed), n_frames
            )
            frames = [
                make_icp_frame(
                    cam, depths[i], cfg,
                    intensity=intens[i] if wph > 0 else None,
                )
                for i in range(n_frames)
            ]
            T_acc = [np.eye(4)]
            for i in range(1, n_frames):
                T, _ = icp_track(cam, cfg, jnp.eye(4), frames[i], frames[i - 1])
                T_acc.append(T_acc[-1] @ np.asarray(T))
            est_pos = np.stack(T_acc)[:, :3, 3]
            gt_pos = np.stack(
                [np.linalg.inv(g)[:3, 3] for g in np.asarray(poses)]
            )
            ates.append(float(ate_rmse(est_pos, gt_pos)) * 1e3)
            if t_track is None:
                def step(T):
                    T2, _ = icp_track.__wrapped__(
                        cam, cfg, T, frames[1], frames[0]
                    )
                    return T2

                t_track = timeit_scan(step, jnp.eye(4), n1=2, n2=12)
        ate_s = " / ".join(f"{a:.2f}" for a in ates)
        print(f"| {wph} | {ate_s} | {t_track*1e3:.2f} | {1/t_track:.0f} |")


if __name__ == "__main__":
    run()
