from .containers import Tensors
from .reference import get_reference_chunk, reference_gather_indices
from .rotations import q_to_rot_mat, quaternion_derivative, quaternion_inverse, unit_quat, v_dot_q

__all__ = ["Tensors", "get_reference_chunk", "reference_gather_indices", "q_to_rot_mat",
           "quaternion_derivative", "quaternion_inverse", "unit_quat", "v_dot_q"]
