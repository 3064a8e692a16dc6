from .circle import circle_trajectory_accelerating
from .io import states_from_flat_outputs

__all__ = ["circle_trajectory_accelerating", "states_from_flat_outputs"]
