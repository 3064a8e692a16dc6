from .augmented import FoldedDrag, MPCDynamics, fold_drag, gp_mean_world, make_mpc_dynamics
from .dynamics import (compute_a_drag_target, f_disturbed, f_nominal, f_with_drag, plant_step,
                       plant_substeps, rk4_step)
from .params import (QuadParams, crazyflie_params, default_params, default_v1_params,
                     hummingbird_params, randomize_params)
from .rgp import RGPState, rbf, rgp_init, rgp_regress

__all__ = [
    "FoldedDrag", "MPCDynamics", "fold_drag", "gp_mean_world", "make_mpc_dynamics",
    "compute_a_drag_target", "f_disturbed", "f_nominal", "f_with_drag", "plant_step",
    "plant_substeps", "rk4_step",
    "QuadParams", "crazyflie_params", "default_params", "default_v1_params",
    "hummingbird_params", "randomize_params",
    "RGPState", "rbf", "rgp_init", "rgp_regress",
]
