from .quaternion import qinv, qnormalize, rotate_vec_by_q, safe_norm
from .tq_map import decode_tq_map, grid_cell_coords
from .transforms import np_compose_pose

__all__ = ["qinv", "qnormalize", "rotate_vec_by_q", "safe_norm",
           "decode_tq_map", "grid_cell_coords", "np_compose_pose"]
