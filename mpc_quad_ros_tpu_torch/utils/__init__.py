from .containers import Tensors
from .rotations import q_to_rot_mat, quaternion_derivative, quaternion_inverse, v_dot_q

__all__ = ["Tensors", "q_to_rot_mat", "quaternion_derivative", "quaternion_inverse", "v_dot_q"]
