from .containers import Tensors
from .metrics import euclidean_dist, interpol_mse, quaternion_state_mse, separate_variables
from .reference import get_reference_chunk, reference_gather_indices
from .rotations import (decompose_quaternion, euler_to_quaternion, q_dot_q, q_to_rot_mat,
                        quaternion_derivative, quaternion_inverse, quaternion_to_euler,
                        rotation_matrix_to_euler, rotation_matrix_to_quat, skew_symmetric4,
                        undo_quaternion_flip, unit_quat, v_dot_q)

__all__ = ["Tensors", "euclidean_dist", "interpol_mse", "quaternion_state_mse",
           "separate_variables", "get_reference_chunk", "reference_gather_indices",
           "decompose_quaternion", "euler_to_quaternion", "q_dot_q", "q_to_rot_mat",
           "quaternion_derivative", "quaternion_inverse", "quaternion_to_euler",
           "rotation_matrix_to_euler", "rotation_matrix_to_quat", "skew_symmetric4",
           "undo_quaternion_flip", "unit_quat", "v_dot_q"]
