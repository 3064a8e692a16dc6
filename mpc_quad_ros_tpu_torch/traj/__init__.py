from .circle import (circle_trajectory_acc_dec, circle_trajectory_accelerating,
                     circle_trajectory_constant, square_trajectory)
from .io import load_sampled_csv, save_sampled_csv, states_from_flat_outputs
from .minsnap import min_snap_trajectory
from .polynomial import PiecewisePolynomial4D, sample_polynomial_trajectory
from .waypoints import line_waypoints, random_waypoints

__all__ = ["circle_trajectory_accelerating", "circle_trajectory_constant",
           "circle_trajectory_acc_dec", "square_trajectory", "random_waypoints",
           "line_waypoints", "PiecewisePolynomial4D", "sample_polynomial_trajectory",
           "min_snap_trajectory", "save_sampled_csv", "load_sampled_csv",
           "states_from_flat_outputs"]
