from .kabsch import weighted_kabsch
from .quaternion import (hemisphere, matrix_to_quat, qinv, qnormalize,
                         quat_to_matrix, rotate_vec_by_q, safe_norm)
from .tq_map import decode_tq_map, generate_tq_map, grid_cell_coords
from .transforms import np_compose_pose

__all__ = ["hemisphere", "matrix_to_quat", "qinv", "qnormalize",
           "quat_to_matrix", "rotate_vec_by_q", "safe_norm",
           "weighted_kabsch", "decode_tq_map", "generate_tq_map",
           "grid_cell_coords", "np_compose_pose"]
