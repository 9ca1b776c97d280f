from .kabsch import weighted_kabsch
from .quaternion import (calc_vo, compose_pose, hemisphere, invert_pose,
                         matrix_to_quat, qexp, qinv, qlog, qmult, qnormalize,
                         quat_to_matrix, rotate_vec_by_q, safe_norm, slerp,
                         transform_points)
from .tq_map import decode_tq_map, generate_tq_map, grid_cell_coords
from .transforms import (RT_to_tq, tq_to_RT, cam_pose_to_lidar,
                         odom_to_abs_pose, np_compose_pose, np_invert_pose,
                         np_calc_vo, expand_rigid, matrix_to_quat_np,
                         quat_to_matrix_np, umeyama_alignment, ate_rmse)

__all__ = ["calc_vo", "compose_pose", "hemisphere", "invert_pose",
           "matrix_to_quat", "qexp", "qinv", "qlog", "qmult", "qnormalize",
           "quat_to_matrix", "rotate_vec_by_q", "safe_norm", "slerp",
           "transform_points",
           "weighted_kabsch", "decode_tq_map", "generate_tq_map",
           "grid_cell_coords",
           "RT_to_tq", "tq_to_RT", "cam_pose_to_lidar", "odom_to_abs_pose",
           "np_compose_pose", "np_invert_pose", "np_calc_vo", "expand_rigid",
           "matrix_to_quat_np", "quat_to_matrix_np", "umeyama_alignment",
           "ate_rmse"]
