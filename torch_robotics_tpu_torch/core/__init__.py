from .device import resolve_device
from .pytrees import safe_norm
from .quaternion import (
    q_exp_map, q_log_map, q_mul, q_inverse, q_div, q_norm_squared,
    q_to_rotation_matrix, q_to_quaternion_matrix, rotation_matrix_to_q,
    q_to_axis_angles, axis_angles_to_q, q_to_euler, euler_to_q,
    q_convert_xyzw, q_convert_wxyz, q_parallel_transport,
)
from .se3 import (
    x_rot, y_rot, z_rot, rpy_to_rotation_matrix, axis_angle_rotation,
    multiply_transform, multiply_inv_transform, invert_transform,
    transform_point, rotate_point, pack_homogeneous, unpack_homogeneous,
    vector3_to_skew_symm_matrix, skew_symm_matrix_to_vec,
    SE3_distance, so3_relative_angle, so3_rotation_angle,
    acos_linear_extrapolation, log_SO3, exp_map_so3, minus_SO3,
    link_pos_from_link_tensor, link_rot_from_link_tensor,
    link_quat_from_link_tensor,
)
from .frame import Frame, MotionVec
from .random import fix_random_seed
from .timer import TimerCUDA
from .utils import to_numpy, to_torch

__all__ = [
    "resolve_device", "safe_norm",
    "q_exp_map", "q_log_map", "q_mul", "q_inverse", "q_div", "q_norm_squared",
    "q_to_rotation_matrix", "q_to_quaternion_matrix", "rotation_matrix_to_q",
    "q_to_axis_angles", "axis_angles_to_q", "q_to_euler", "euler_to_q",
    "q_convert_xyzw", "q_convert_wxyz", "q_parallel_transport",
    "x_rot", "y_rot", "z_rot", "rpy_to_rotation_matrix",
    "axis_angle_rotation", "multiply_transform", "multiply_inv_transform",
    "invert_transform", "transform_point", "rotate_point",
    "pack_homogeneous", "unpack_homogeneous", "vector3_to_skew_symm_matrix",
    "skew_symm_matrix_to_vec", "SE3_distance", "so3_relative_angle",
    "so3_rotation_angle", "acos_linear_extrapolation", "log_SO3",
    "exp_map_so3", "minus_SO3", "link_pos_from_link_tensor",
    "link_rot_from_link_tensor", "link_quat_from_link_tensor",
    "Frame", "MotionVec", "TimerCUDA", "fix_random_seed", "to_numpy",
    "to_torch",
]
