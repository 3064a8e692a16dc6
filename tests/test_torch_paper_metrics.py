"""The reference paper's headline learning metric on the port's own runs:
cov(v_axis, error_axis) shrinks when the RGP learns the drag online.

tests/test_paper_metrics.py's scenarios (the 12 s accelerating circle at
v_peak 3 and 6 m/s, one hummingbird with the preset's drag, float64), each
drag mode's two speeds in one ``run_episode`` call, and the JAX package's
bound: |cov| of gp2 below gp0's / 1.5 on x and y, read per episode with the
port's ``Visualiser.velocity_error_covariance``.  JAX-free: the bound is the
JAX test's, and ``test_torch_traj.py`` holds the metric to the JAX one."""

import numpy as np
import torch

from mpc_quad_ros_tpu_torch.io import Logger
from mpc_quad_ros_tpu_torch.io.viz import Visualiser
from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode
from mpc_quad_ros_tpu_torch.models import GPEnsemble, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
from mpc_quad_ros_tpu_torch.utils.containers import stack_records

from test_torch_cuda_common import circle, port_params

V_PEAK = (3.0, 6.0)


def covariances(gpe_mode: int) -> list:
    """Per speed, the episode's (3,) cov(v, e)."""
    p = port_params()
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p.hover_input)))
    traj = torch.as_tensor(np.stack([circle(v, dt=cfg.mpc.dt, t_max=12.0) for v in V_PEAK]))
    x0 = torch.zeros(len(V_PEAK), 13, dtype=torch.float64)
    x0[:, 3], x0[:, 2] = 1.0, 3.0
    rgp0 = None
    if gpe_mode == 2:
        rgp0 = stack_records([GPEnsemble.fromrange([(-v, v)] * 3, 10, theta=(3.0, 0.1, 0.01),
                                                   dtype=torch.float64, device="cpu").state
                              for v in V_PEAK])
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p))
    pb = p.map(lambda a: a.expand((len(V_PEAK),) + a.shape))
    _, outs = run_episode(cfg, solver, pb, x0, traj, traj.shape[1], rgp0)
    return [Visualiser.from_logger(Logger.from_episode(outs.map(lambda a: a[b])))
            .velocity_error_covariance() for b in range(len(V_PEAK))]


def test_rgp_reduces_velocity_error_covariance():
    """gp2 cuts |cov(v_x, e_x)| and |cov(v_y, e_y)| below gp0's / 1.5 (the
    reference measured ~2.5x)."""
    cov0, cov2 = covariances(0), covariances(2)
    for b, v_peak in enumerate(V_PEAK):
        # x and y carry the drag signature on the planar circle
        for ax in range(2):
            assert abs(cov2[b][ax]) < abs(cov0[b][ax]) / 1.5, (
                f"v_peak={v_peak} axis={ax}: gp0 {cov0[b][ax]:.4f} gp2 {cov2[b][ax]:.4f}")
