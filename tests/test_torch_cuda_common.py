"""Shared inputs of the port's tests that need no JAX (no tests of its own).

The CUDA-gated tests (``test_torch_cuda_*.py``) import only this module,
torch and the port, so that they collect where JAX is absent.  Parameters
and RGP states come from the port's own ``hummingbird_params`` and
``rgp_init``; the CPU tests hold those to the JAX package's.  The input
makers take the RGP-batch maker as an argument: the CPU tests pass the one
built by the JAX package's ``rgp_init``, whose ``K_x_inv`` differs from the
port's by 2e-11 (the inverse of an ill-conditioned kernel matrix), so that
their f64 tolerances hold on the inputs they were set on."""

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import hummingbird_params, rgp_init
from mpc_quad_ros_tpu_torch.traj import circle_trajectory_accelerating, states_from_flat_outputs

# the tier runs several pytest workers: one intra-op thread each
torch.set_num_threads(1)

N, NB = 10, 10
# the Riccati OCPs of tests/test_riccati_kernel.py's style
NX, NU = 13, 4
Q = (10.0, 10.0, 10.0, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05)
RD = (0.1,) * NU
PT = tuple(2.0 * v for v in Q)
LB, UB = -0.16, 0.3
RICCATI_ARGS = ("c", "dx0", "qlin", "rlin", "plin", "lb", "ub")


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)


def port_params():
    """The hummingbird preset in float64 on the CPU."""
    return hummingbird_params(dtype=torch.float64)


def hover_input() -> float:
    return float(port_params().hover_input)


def params_numpy() -> dict:
    return interop.to_numpy(port_params())


def rgp_batch(B: int, rng, mu_scale: float = 0.3, nb: int = NB) -> dict:
    """(B, 3) RGP states from rgp_init (basis linspace(-10, 10, nb), theta
    (3, 0.1, 0.01)) with a random posterior mean, as numpy."""
    r1 = rgp_init(torch.linspace(-10.0, 10.0, nb, dtype=torch.float64), theta=(3.0, 0.1, 0.01))
    out = {k: np.broadcast_to(v.numpy(), (B, 3) + tuple(v.shape)).copy()
           for k, v in r1.fields().items()}
    out["mu_g"] = mu_scale * rng.standard_normal((B, 3, nb))
    return out


def solve_inputs(B: int, seed: int = 0, N: int = N, rgp_batch=rgp_batch) -> dict:
    """The benchmark's operating point: hover at 3 m with velocities
    U(-3, 3), the reference stepped 1-5 m along x over the N-node horizon."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7:10] += rng.uniform(-3.0, 3.0, (B, 3))
    y_ref = np.repeat(x0[:, None, :], N, axis=1)
    y_ref[:, :, 0] += np.linspace(0.0, 1.0, N)[None, :] * rng.uniform(1.0, 5.0, (B, 1))
    return {"x0": x0, "y_ref": y_ref, "rgp": rgp_batch(B, rng)}


def trajectory_inputs(B: int, seed: int = 0, N: int = N, rgp_batch=rgp_batch):
    """A perturbed (B, N+1, 13) state trajectory (non-unit quaternions
    included) and (B, N, 4) controls inside the box."""
    rng = np.random.default_rng(seed)
    X = np.zeros((B, N + 1, 13))
    X[..., 3] = 1.0
    X[..., 2] = 3.0
    X += 0.2 * rng.standard_normal(X.shape)
    X[..., 7:10] += rng.uniform(-4.0, 4.0, (B, 1, 3))
    U = rng.uniform(0.2, 0.7, (B, N, 4))
    return X, U, rgp_batch(B, rng)


def gn_step_inputs(B: int, seed: int = 0, N: int = N, rgp_batch=rgp_batch) -> dict:
    """One Gauss-Newton step's inputs, f64, through the port's plain
    linearisation of a perturbed trajectory: the solver, (X, U), the folded
    drag and the RGP arrays, x0 and the references, and kernel B's inputs
    J, r, dx0, ex0, gu, lb, ub."""
    from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics
    from mpc_quad_ros_tpu_torch.ops.cuda.lin_kernel import linearize_plain
    from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver

    X, U, rgp = trajectory_inputs(B, seed, N, rgp_batch)
    rng = np.random.default_rng(seed + 1)
    x0 = X[:, 0] + 0.05 * rng.standard_normal((B, 13))
    y_ref = X[:, 1:] + 0.3 * rng.standard_normal((B, N, 13))
    p = port_params()
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(p.hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    aug = fold_drag(interop.rgp_state_from_numpy(rgp)).map(lambda a: a.contiguous())
    X, U, x0, y_ref = map(t, (X, U, x0, y_ref))
    xp, J = linearize_plain(solver.f, X, U, aug, cfg.dt)
    keys = ("r", "dx0", "ex0", "gu", "lb", "ub")
    out = dict(zip(keys, solver.qp_inputs(X, U, x0, y_ref, y_ref[:, -1], xp)))
    out = {k: v.contiguous() for k, v in out.items()}
    return dict(solver=solver, X=X, U=U, aug=aug, rgp=rgp, x0=x0, y_ref=y_ref,
                J=J.contiguous(), **out)


def random_ocp(B: int, N: int, seed: int = 0) -> dict:
    """A, B near the identity / small, the bounds [-0.16, 0.3] on du: most
    bounds end active (as in tests/test_riccati_kernel.py)."""
    rng = np.random.default_rng(seed)
    return dict(A=rng.normal(0, 0.08, (B, N, NX, NX)) + np.eye(NX),
                Bm=rng.normal(0, 0.15, (B, N, NX, NU)),
                c=rng.normal(0, 0.02, (B, N, NX)), dx0=rng.normal(0, 0.05, (B, NX)),
                qlin=rng.normal(0, 0.5, (B, N, NX)), rlin=rng.normal(0, 0.1, (B, N, NU)),
                plin=rng.normal(0, 0.5, (B, NX)),
                lb=np.full((B, N, NU), LB), ub=np.full((B, N, NU), UB))


def riccati_kernel_inputs(o: dict) -> list:
    """[J, c, dx0, qlin, rlin, plin, lb, ub] of kernel C as contiguous
    tensors; J (B, N, 17, 13) holds the columns of [A | B]."""
    J = np.concatenate([o["A"], o["Bm"]], axis=3).transpose(0, 1, 3, 2)
    return [t(J).contiguous()] + [t(o[k]).contiguous() for k in RICCATI_ARGS]


def box_qp(nz: int, seed: int, B: int = 6) -> dict:
    """Random positive definite box QPs shaped like the condensed MPC QP:
    the box [-0.16, 0.84] of du at hover, a gradient that leaves many bounds
    active, and random positive duals."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, nz, nz))
    H = G @ G.transpose(0, 2, 1) / nz + 0.1 * np.eye(nz)
    return dict(H=H, g=3.0 * rng.standard_normal((B, nz)), lb=np.full((B, nz), -0.16),
                ub=np.full((B, nz), 0.84), zl0=rng.uniform(0.0, 2.0, (B, nz)),
                zu0=rng.uniform(0.0, 2.0, (B, nz)))


def circle(v: float, dt: float = 0.1, t_max: float = 10.0) -> np.ndarray:
    """The accelerating 10 m circle at v as (T, 13) reference states."""
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, v, t_max=t_max, dt=dt)
    return states_from_flat_outputs(pos, vel)


def fleet_params(n: int, rng, params: dict) -> dict:
    """`params` (numpy) tiled to n episodes with the aero and rotor drag
    scaled by U(0.5, 2) draws."""
    pb = {k: np.broadcast_to(v, (n,) + v.shape).copy() for k, v in params.items()}
    pb["aero_drag"] = pb["aero_drag"] * rng.uniform(0.5, 2.0, n)
    pb["rotor_drag"] = pb["rotor_drag"] * rng.uniform(0.5, 2.0, (n, 1))
    return pb
