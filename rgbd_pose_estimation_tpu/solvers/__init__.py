from rgbd_pose_estimation_tpu.solvers.absolute_orientation import (
    kabsch,
    umeyama,
    horn_quaternion,
)
from rgbd_pose_estimation_tpu.solvers.p3p import p3p, p3p_best
from rgbd_pose_estimation_tpu.solvers.pnp import pnp_dlt, pnp_refine

__all__ = [
    "kabsch",
    "umeyama",
    "horn_quaternion",
    "p3p",
    "p3p_best",
    "pnp_dlt",
    "pnp_refine",
]
