from .augmented import FoldedDrag, MPCDynamics, fold_drag, gp_mean_world, make_mpc_dynamics
from .dynamics import (a_drag_body, compute_a_drag_target, f_disturbed, f_nominal, f_with_drag,
                       plant_step, plant_substeps, rk4_step)
from .ensemble import GPEnsemble
from .gp import GPState, gp_fit, gp_init, gp_nll, gp_predict
from .params import (QuadParams, crazyflie_params, default_params, default_v1_params,
                     hummingbird_params, params_from_xacro, randomize_params)
from .rgp import (RGPLearnState, RGPState, rbf, rgp_init, rgp_kernel_matrix, rgp_learn,
                  rgp_learn_init, rgp_predict, rgp_predict_using_y, rgp_regress)
from .selection import distance_maximizing_points, prune_dataset, sample_random_points

__all__ = [
    "FoldedDrag", "MPCDynamics", "fold_drag", "gp_mean_world", "make_mpc_dynamics",
    "a_drag_body", "compute_a_drag_target", "f_disturbed", "f_nominal", "f_with_drag",
    "plant_step", "plant_substeps", "rk4_step",
    "GPEnsemble",
    "GPState", "gp_fit", "gp_init", "gp_nll", "gp_predict",
    "QuadParams", "crazyflie_params", "default_params", "default_v1_params",
    "hummingbird_params", "params_from_xacro", "randomize_params",
    "RGPLearnState", "RGPState", "rbf", "rgp_init", "rgp_kernel_matrix", "rgp_learn",
    "rgp_learn_init", "rgp_predict", "rgp_predict_using_y", "rgp_regress",
    "distance_maximizing_points", "prune_dataset", "sample_random_points",
]
