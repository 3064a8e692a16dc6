"""Control-sequence parity against recorded closed-loop runs.

Counterpart of ``mpc_quad_ros_tpu/bench/parity.py``: replay a log (the
reference's Logger pickles, or either package's ``Logger.from_episode``)
through the solver — the same measured states, the same reference chunks
rebuilt from the logged ``x_ref`` sequence, the same warm-start chaining —
and compare the commanded controls with the logged ``w_odom``.

- The ROS path ticks at 100 Hz odometry and strides its chunks by
  control_freq_factor, so the chunk at tick k is x_ref[k + j * skip],
  clipped at the log's end; the Gazebo launches use n_nodes=5, t_lookahead
  1 s, so skip=20.  Python-sim logs tick at the MPC rate: n_nodes=10,
  skip=1.
- Stage costs are scaled by the shooting interval (acados' LINEAR_LS).

The JAX ``lax.scan`` over the ticks is a Python loop of ``SQPSolver.solve``
on one scenario: kernels A and J and the unscaled IPM in tensor code on the
card; their plain versions on the CPU.  The replay runs on the card unless
given ``device="cpu"``; its dtype defaults to float32 on the card (the
kernels' type) and float64 on the CPU.

The reference's logs are found under a checkout of the reference project,
given by ``--reference`` or ``$MPCQUAD_REFERENCE``, at the JAX package's
paths inside it (``GAZEBO_GP0_LOGS``); ``--logs`` names logs directly.
With no log (no checkout) ``main`` prints that it skipped and exits 0.

    python -m mpc_quad_ros_tpu_torch.bench.parity [--reference DIR] [--logs LOG.pkl ...] [--cpu]
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch

from ..utils.device import resolve_device

REFERENCE_ENV = "MPCQUAD_REFERENCE"
# the Gazebo gp0 logs, relative to the reference checkout
GAZEBO_GP0_LOGS = "outputs/gazebo_simulation/data/traj*gp0.pkl"


def reference_path(relative: str, reference: str | None = None) -> str | None:
    """`relative` inside the reference checkout (`reference`, else
    ``$MPCQUAD_REFERENCE``); None without a checkout."""
    root = reference or os.environ.get(REFERENCE_ENV)
    return os.path.join(root, relative) if root else None


def preset_params(name: str, dtype, device):
    """The parameter preset a log was flown with, by name."""
    from ..models import default_params, default_v1_params, hummingbird_params

    return {"hummingbird": hummingbird_params, "default": default_params,
            "default_v1": default_v1_params}[name](dtype=dtype, device=device)


def replay_reference_log(log_path: str, n_nodes: int = 5, t_horizon: float = 1.0,
                         skip: int = 20, sqp_iters: int = 2, drop_tail: int = 150,
                         dtype=None, gp_path: str | None = None,
                         rgp_from_log: bool = False, rgp_theta=None,
                         rgp_basis=None, params: str = "hummingbird", device="cuda") -> dict:
    """Replay and compare.  Returns the per-tick |du| stats and the arrays.

    gp_path: directory of ``mdl_{x,y,z}.gp`` files for gp1-mode logs.

    rgp_from_log: gp2-mode logs.  The logged per-tick RGP posterior
    (``rgp_mu_g_t`` in python-sim logs, the flat ``rgp_params`` vector in
    ROS logs) is fed to the solver, the solve at tick k taking the posterior
    logged at tick k-1 (the reference regresses after its solve; tick 0
    takes tick 0's).  ROS logs need ``rgp_basis`` (3, nb) and take
    ``rgp_theta`` (default the RGP's (1, 0.1, 0.1)); python-sim logs carry
    their basis vectors and, where logged, their theta.

    params: "hummingbird" (Gazebo logs), "default" or "default_v1"
    (python-sim logs of the two ``Quadrotor3D`` default vintages).
    """
    from ..models import GPEnsemble, make_mpc_dynamics, rgp_init
    from ..ops.sqp import MPCConfig, SQPSolver, init_carry

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if dev.type == "cuda" else torch.float64
    kw = dict(dtype=dtype, device=dev)

    aug = None
    if gp_path is not None:
        aug = GPEnsemble.fromdir(gp_path, "GP", device=dev).state.map(lambda a: a.to(dtype))

    with open(log_path, "rb") as f:
        d = pickle.load(f)
    X = torch.as_tensor(np.array(d["x_odom"]), **kw)
    W = np.clip(np.array(d["w_odom"]), 0.0, 1.0)
    XR = torch.as_tensor(np.array(d["x_ref"]), **kw)
    T = X.shape[0]
    n_replay = T - drop_tail
    if n_replay <= 10:
        raise ValueError(f"log too short for drop_tail={drop_tail}: {T} ticks")

    rgp_state0 = MU_prev = None
    if rgp_from_log:
        if "rgp_mu_g_t" in d:
            MU = np.array(d["rgp_mu_g_t"])             # (T, 3, nb)
            Xb = np.array(d["rgp_basis_vectors"])[0]   # (3, nb), constant
            if rgp_theta is not None:
                theta = np.tile(np.asarray(rgp_theta, np.float64), (3, 1))
            else:
                # the run's own logged theta (per axis [L, sigma_f, sigma_n]),
                # else the reference CLI's default
                th_log = next((t for t in d.get("rgp_theta", []) or [] if t is not None), None)
                if th_log is not None:
                    theta = np.array([[float(np.ravel(v)[0]) for v in ax] for ax in th_log])
                else:
                    theta = np.tile([3.0, 0.1, 0.01], (3, 1))
        else:
            P = np.array(d["rgp_params"])              # (T, 3 nb), mu concatenated
            nb = P.shape[1] // 3
            MU = P.reshape(T, 3, nb)
            if rgp_basis is None:
                raise ValueError("ROS gp2 logs need rgp_basis")
            Xb = np.asarray(rgp_basis)
            theta = np.tile(np.asarray(rgp_theta if rgp_theta is not None else (1.0, 0.1, 0.1),
                                       np.float64), (3, 1))
        MU_prev = torch.as_tensor(np.concatenate([MU[:1], MU[:-1]], axis=0), **kw)
        rgp_state0 = rgp_init(torch.as_tensor(Xb, **kw), theta=torch.as_tensor(theta, **kw))

    p = preset_params(params, dtype, dev)
    cfg = MPCConfig(n_nodes=n_nodes, t_horizon=t_horizon, u_ref=0.16, sqp_iters=sqp_iters)
    solver = SQPSolver(cfg, make_mpc_dynamics(p))

    offsets = skip * torch.arange(n_nodes, device=dev)
    carry = init_carry(cfg, X[0])
    U = []
    for k in range(n_replay):
        xr = XR[(k + offsets).clamp(0, T - 1)]
        a = rgp_state0.replace(mu_g=MU_prev[k]) if rgp_from_log else aug
        carry, sol = solver.solve(carry, X[k], xr, xr[-1], a)
        U.append(sol.U[0])
    U = torch.stack(U).double().cpu().numpy()
    du = np.abs(U - W[:n_replay])
    return {"u_ours": U, "u_ref": W[:n_replay], "du_mean": float(du.mean()),
            "du_median": float(np.median(du)), "du_p95": float(np.percentile(du, 95)),
            "du_max": float(du.max())}


def control_parity_report(log_paths: list, **kw) -> list:
    out = []
    for path in log_paths:
        r = replay_reference_log(path, **kw)
        out.append({"log": path, **{k: v for k, v in r.items() if k.startswith("du_")}})
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", default=None,
                    help=f"the reference project's checkout (default ${REFERENCE_ENV})")
    ap.add_argument("--logs", nargs="*", default=None,
                    help=f"logs to replay (default: the checkout's {GAZEBO_GP0_LOGS})")
    ap.add_argument("--cpu", action="store_true", help="replay on the CPU in float64")
    a = ap.parse_args(argv)
    pattern = reference_path(GAZEBO_GP0_LOGS, a.reference)
    logs = a.logs if a.logs is not None else sorted(glob.glob(pattern)) if pattern else []
    if not logs:
        print("parity: no logs to replay (no reference checkout); skipped", flush=True)
        return 0
    for row in control_parity_report(logs, device="cpu" if a.cpu else "cuda"):
        print(row, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
