from rgbd_pose_estimation_tpu.ops.ransac_score import (
    best_pose_3d3d,
    score_poses_3d3d,
    score_poses_3d3d_reference,
    score_poses_2d3d,
    score_poses_2d3d_reference,
)
from rgbd_pose_estimation_tpu.ops.icp_jtj import (
    icp_jtj_jtr,
    icp_jtj_jtr_reference,
)

__all__ = [
    "best_pose_3d3d",
    "score_poses_3d3d",
    "score_poses_3d3d_reference",
    "score_poses_2d3d",
    "score_poses_2d3d_reference",
    "icp_jtj_jtr",
    "icp_jtj_jtr_reference",
]
