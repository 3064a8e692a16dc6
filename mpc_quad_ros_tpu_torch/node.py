"""The controller and trajectory-generator "nodes": the ROS seam without ROS.

Counterpart of ``mpc_quad_ros_tpu/node.py``:

- the message dataclasses (``TrajectoryRequest``, ``Trajectory``,
  ``MotorPower``, ``ControlCommand``, ``LiveFrame``, ``PositionCommand``)
  hold numpy fields, so they pickle across a transport with no card on the
  other side; tensors are converted at the node's edge;
- ``TrajectoryServer`` answers requests with sampled 13-state trajectories
  (line, static, random, circle) from the port's ``traj/``;
- ``ControllerNode`` runs the 100 Hz odometry-callback control loop: the
  bootstrap line to hover, the reference chunk downsampled by the control
  frequency factor, the online RGP regression with the previous prediction,
  the finished check with the 1 m ball, the training-run count and the
  per-tick log under the reference's keys;
- ``position_controller_motors`` (the onboard cascade behind Crazyswarm's
  ``cmdPosition``), ``SimpleZController`` and ``SimLoop`` (the node wired to
  the plant at odometry rate).

Each tick's compute (``ControllerNode._compute_step``: ``SQPSolver.solve`` at
one scenario, the nominal prediction over one odometry period and the RGP
update) is a plain method.  The JAX node's per-scenario solve reaches no
Pallas kernel (``jax.jacfwd`` for the sensitivities and a scan for the
condensing, in XLA); the port routes that B=1 solve through its kernels A
(``lin_kernel``) and J (``condense_ab_kernel``) on the card, as the
small-batch step does.  The JAX node traces
it with ``jax.jit`` and feeds the trace a placeholder RGP state
(``_EMPTY_RGP``) when none is attached; neither exists here, because nothing
is traced.  The solver carry, the RGP state and the last prediction stay on
the node's device across ticks: only the measured state comes in from the
host, and only the command and the log go out.  On the card the tick's
clock stops after a ``torch.cuda.synchronize`` (the JAX node reads it after
an asynchronous dispatch), so ``t_cpu`` and ``elapsed_during_mpc`` are the
compute's wall time.

The node and ``SimLoop`` run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .io.logger import Logger
from .models.augmented import fold_drag, make_mpc_dynamics
from .models.dynamics import compute_a_drag_target, plant_substeps
from .models.ensemble import GPEnsemble
from .models.rgp import rgp_regress
from .ops.sqp import MPCConfig, SQPSolver, init_carry
from .utils.device import resolve_device
from .utils.rotations import q_to_rot_mat


# --------------------------------------------------------------------------- #
# messages
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class TrajectoryRequest:
    """A trajectory request: type, start and end points, limits."""

    type: str                      # 'line' | 'static' | 'random' | 'circle'
    start_point: np.ndarray | None = None
    end_point: np.ndarray | None = None
    v_max: float = 10.0
    a_max: float = 10.0


@dataclasses.dataclass
class Trajectory:
    """Timestamped 13-state samples."""

    x: np.ndarray                  # (T, 13)
    t: np.ndarray                  # (T,)


@dataclasses.dataclass
class MotorPower:
    """Per-motor commands."""

    m: np.ndarray                  # (4,) in [0, 1]
    stamp: float = 0.0


@dataclasses.dataclass
class ControlCommand:
    """Body rates and collective thrust, with the raw motor activations."""

    bodyrates: np.ndarray          # (3,)
    collective_thrust: float       # [m/s^2]
    motors: np.ndarray             # (4,) raw [0,1] activations
    stamp: float = 0.0


@dataclasses.dataclass
class LiveFrame:
    """One tick's live-view payload: the reference chunk, the MPC-optimal
    path and the target marker.  Delivered through
    ``ControllerNode(live_callback=...)``; ``io.viz.LiveFlightView`` renders
    it."""

    t: float
    x: np.ndarray                  # (13,) measured state
    x_ref_chunk: np.ndarray        # (N, 13) current reference chunk
    x_horizon: np.ndarray          # (N+1, 13) MPC-optimal state trajectory
    target: np.ndarray             # (3,) trajectory endpoint marker


@dataclasses.dataclass
class PositionCommand:
    """The ``cmdPosition`` actuation: the vehicle's onboard position
    controller tracks the MPC's predicted next position and yaw."""

    pos: np.ndarray                # (3,) world position setpoint
    yaw: float                     # [rad]
    motors: np.ndarray             # (4,) the MPC's motor plan (logged, unused)
    stamp: float = 0.0


# --------------------------------------------------------------------------- #
class TrajectoryServer:
    """Answers a TrajectoryRequest with a sampled Trajectory; `seed` steps on
    each random request."""

    def __init__(self, sample_dt: float = 0.01, seed: int = 0):
        self.sample_dt = sample_dt
        self.seed = seed

    def handle(self, req: TrajectoryRequest) -> Trajectory:
        from .traj import (circle_trajectory_accelerating, line_waypoints, min_snap_trajectory,
                           random_waypoints, sample_polynomial_trajectory,
                           states_from_flat_outputs)

        if req.type == "circle":
            ts, pos, vel, _ = circle_trajectory_accelerating(
                10.0, req.v_max, t_max=30.0, dt=self.sample_dt,
                start_point=tuple(req.start_point) if req.start_point is not None else (0, 0, 0),
            )
            return Trajectory(states_from_flat_outputs(np.asarray(pos), np.asarray(vel)),
                              np.asarray(ts))

        if req.type == "line":
            wp = line_waypoints(req.start_point, req.end_point)
        elif req.type == "random":
            wp = random_waypoints(hsize=10.0, num_waypoints=6,
                                  start_point=req.start_point, seed=self.seed)
            self.seed += 1
        elif req.type == "static":
            if req.end_point is None:
                raise ValueError("static request needs waypoints")
            wp = np.asarray([req.start_point, req.end_point])
        else:
            raise ValueError(f"unknown trajectory type {req.type}")

        poly = min_snap_trajectory(wp, req.v_max, req.a_max)
        ts, pos, vel, _ = sample_polynomial_trajectory(poly, self.sample_dt)
        return Trajectory(states_from_flat_outputs(pos, vel), ts)


# --------------------------------------------------------------------------- #
class ControllerNode:
    """The odometry-driven MPC controller."""

    HOVER_POS = np.array([0.0, 0.0, 3.0])
    EPSILON_TRAJECTORY_FINISHED = 1.0              # [m]

    def __init__(
        self,
        quad_params,
        trajectory_server: TrajectoryServer,
        publish_control: Optional[Callable] = None,
        use_gp: int = 0,
        gpe: Optional[GPEnsemble] = None,
        v_max: float = 10.0,
        a_max: float = 10.0,
        trajectory_type: str = "circle",
        t_lookahead: float = 1.0,
        n_nodes: int = 5,
        n_basis_vectors: int = 20,
        odometry_dt: float = 0.01,
        training: bool = False,
        training_trajectories_count: int = 1,
        logger: Optional[Logger] = None,
        dtype=torch.float32,
        actuation: str = "motors",
        live_callback: Optional[Callable] = None,
        device="cuda",
    ):
        """quad_params: the MPC model's parameters (the port's QuadParams),
        moved to `device` and cast to `dtype`; a given `gpe` is moved alike."""
        if actuation not in ("motors", "position"):
            raise ValueError(f"unknown actuation mode {actuation!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        to = lambda a: a.to(self.device, dtype)
        self.actuation = actuation
        self.live_callback = live_callback
        self.p = quad_params.map(to)
        self.server = trajectory_server
        self.publish_control = publish_control or (lambda cmd: None)
        self.v_max, self.a_max = v_max, a_max
        self.trajectory_type = trajectory_type
        self.odometry_dt = odometry_dt
        self.training = training
        self.trajectories_count_desired = training_trajectories_count if training else 1
        self.logger = logger or Logger()

        cfg = MPCConfig(n_nodes=n_nodes, t_horizon=t_lookahead, u_ref=0.16)
        self.cfg = cfg
        self.solver = SQPSolver(cfg, make_mpc_dynamics(self.p))
        self.control_freq_factor = int(round(cfg.dt / odometry_dt))

        self.use_gp = use_gp
        if use_gp == 2 and gpe is None:
            gpe = GPEnsemble.fromrange([(-v_max, v_max)] * 3, n_basis_vectors, dtype=dtype,
                                       device=self.device)
        self.gpe = gpe
        self.rgp_state = gpe.state.map(to) if (gpe is not None and gpe.type == "RGP") else None
        # the static GP is folded once, in its own dtype, then cast
        self.gp_aug = (fold_drag(gpe.state.map(lambda a: a.to(self.device))).map(to)
                       if (gpe is not None and gpe.type == "GP") else None)

        # state machine flags
        self.need_trajectory_to_hover = True
        self.trajectory_ready = False
        self.doing_a_line = False
        self.number_of_trajectories_finished = 0
        self.idx_traj = 0
        self.x_trajectory: Optional[np.ndarray] = None
        self.t_trajectory: Optional[np.ndarray] = None
        self.x_pred_prev: Optional[torch.Tensor] = None   # on the device
        self.solver_carry = None
        self.finished = False

    # ------------------------------------------------------------------ #
    def _compute_step(self, carry, x, x_ref, rgp_state, x_pred_prev):
        """One tick's compute on the device: the solve, the nominal prediction
        over one odometry period and, with the online RGP, its update from
        the previous prediction's error."""
        aug = rgp_state if self.use_gp == 2 else (self.gp_aug if self.use_gp == 1 else None)
        carry, sol = self.solver.solve(carry, x, x_ref, x_ref[-1], aug)
        u = sol.U[0]
        x_pred = self.solver.discrete_dynamics(x, u, self.odometry_dt, None)
        v_body = a_drag = None
        if self.use_gp == 2:
            v_body, a_drag = compute_a_drag_target(x, x_pred_prev, self.odometry_dt)
            rgp_state = rgp_regress(rgp_state, v_body[:, None], a_drag[:, None])
        return carry, u, sol.X, sol.cost, x_pred, rgp_state, v_body, a_drag

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------ #
    def request_trajectory(self, x: np.ndarray, traj_type: str, start=None, end=None):
        req = TrajectoryRequest(
            type=traj_type,
            start_point=np.asarray(start if start is not None else x[:3], dtype=float),
            end_point=np.asarray(end, dtype=float) if end is not None else None,
            v_max=self.v_max, a_max=self.a_max,
        )
        self.trajectory_received_cb(self.server.handle(req))

    def trajectory_received_cb(self, traj: Trajectory):
        if self.trajectory_ready:
            return  # a new trajectory is ignored while one is active
        self.x_trajectory = np.asarray(traj.x)
        self.t_trajectory = np.asarray(traj.t)
        self.idx_traj = 0
        self.trajectory_ready = True

    # ------------------------------------------------------------------ #
    def pose_received_cb(self, x: np.ndarray, timestamp: float = 0.0):
        """The 100 Hz odometry callback.  Returns the command applied, or
        None while idle."""
        x = np.asarray(x, dtype=float)

        if self.need_trajectory_to_hover:
            self.need_trajectory_to_hover = False
            self.trajectory_ready = False
            if np.linalg.norm(x[0:3] - self.HOVER_POS) > self.EPSILON_TRAJECTORY_FINISHED:
                self.doing_a_line = True
                self.request_trajectory(x, "line", start=x[:3], end=self.HOVER_POS)
            else:
                self.request_trajectory(x, self.trajectory_type)

        if not self.trajectory_ready or self.finished:
            return None

        xt = self._tensor(x)
        if self.solver_carry is None:
            self.solver_carry = init_carry(self.cfg, xt)
        if self.x_pred_prev is None:
            self.x_pred_prev = xt

        # the reference chunk, downsampled to the MPC's node spacing
        idx = np.clip(self.idx_traj + self.control_freq_factor * np.arange(self.cfg.n_nodes),
                      0, len(self.x_trajectory) - 1)
        x_ref = self._tensor(self.x_trajectory[idx])

        t0 = time.perf_counter()
        (self.solver_carry, u, x_opt, cost, x_pred, rgp_state, v_body, a_drag) = \
            self._compute_step(self.solver_carry, xt, x_ref, self.rgp_state, self.x_pred_prev)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        if self.use_gp == 2:
            self.rgp_state = rgp_state

        u_np = u.cpu().numpy()
        x_opt_np = x_opt.cpu().numpy()
        if self.actuation == "position":
            # cmdPosition: the MPC's predicted next position and yaw, for the
            # onboard position controller to track
            q1 = x_opt_np[1, 3:7]
            yaw = float(np.arctan2(2 * (q1[0] * q1[3] + q1[1] * q1[2]),
                                   1 - 2 * (q1[2] ** 2 + q1[3] ** 2)))
            cmd = PositionCommand(pos=x_opt_np[1, :3], yaw=yaw,
                                  motors=np.clip(u_np, 0.0, 1.0), stamp=timestamp)
        else:
            cmd = ControlCommand(
                bodyrates=x_opt_np[1, 10:13],
                collective_thrust=float(u_np.sum() * float(self.p.max_thrust) / float(self.p.mass)),
                motors=np.clip(u_np, 0.0, 1.0),
                stamp=timestamp,
            )
        self.publish_control(cmd)

        if self.live_callback is not None:
            self.live_callback(LiveFrame(
                t=timestamp, x=x, x_ref_chunk=x_ref.cpu().numpy(), x_horizon=x_opt_np,
                target=self.x_trajectory[-1, :3].copy(),
            ))

        self.idx_traj += 1
        x_pred_np = x_pred.cpu().numpy()

        if not self.doing_a_line:
            rgp = self.rgp_state if self.use_gp == 2 else None
            host = lambda a: None if a is None else a.cpu().numpy()
            self.logger.log({
                "x_odom": x, "x_pred_odom": x_pred_np, "x_ref": self.x_trajectory[idx[0]],
                "t_odom": timestamp, "w_odom": u_np, "t_cpu": elapsed,
                "elapsed_during_mpc": elapsed, "cost_solution": float(cost),
                "rgp_mu_g_t": host(rgp.mu_g) if rgp is not None else None,
                "v_body": host(v_body), "a_drag": host(a_drag),
                "rgp_basis_vectors": host(rgp.X) if rgp is not None else None,
                "rgp_C_g_t": host(rgp.C_g) if rgp is not None else None,
                "rgp_theta": host(rgp.theta) if rgp is not None else None,
            })
        self.x_pred_prev = x_pred

        # the trajectory-finished check
        if (self.idx_traj + 1 >= len(self.x_trajectory)
                and np.linalg.norm(x[0:3] - self.x_trajectory[-1, 0:3])
                < self.EPSILON_TRAJECTORY_FINISHED):
            self.trajectory_ready = False
            if self.doing_a_line:
                self.logger.clear_memory()
                self.doing_a_line = False
                self.request_trajectory(x, self.trajectory_type)
            else:
                self.number_of_trajectories_finished += 1
                if self.logger.filepath:
                    self.logger.save_log()
                if self.number_of_trajectories_finished >= self.trajectories_count_desired:
                    self.finished = True
                else:
                    self.request_trajectory(x, self.trajectory_type)
        return cmd


# --------------------------------------------------------------------------- #
class SimpleZController:
    """Minimal altitude P-controller publishing motor powers, with the
    Crazyflie test node's odometry hygiene: stale messages are dropped and
    the odometry is undersampled to the control rate."""

    def __init__(self, target_z: float = 1.0, kp: float = 0.4, hover: float = 0.3,
                 publish: Optional[Callable] = None, min_dt: float = 0.02,
                 max_age: float = 0.5):
        self.target_z = target_z
        self.kp = kp
        self.hover = hover
        self.publish = publish or (lambda mp: None)
        self.min_dt = min_dt        # undersample threshold
        self.max_age = max_age      # stale-message threshold
        self.last_t = -np.inf

    def odometry_cb(self, x: np.ndarray, timestamp: float, now: Optional[float] = None):
        now = timestamp if now is None else now
        if now - timestamp > self.max_age:      # stale
            return None
        if timestamp - self.last_t < self.min_dt:  # undersampled
            return None
        self.last_t = timestamp
        u = float(np.clip(self.hover + self.kp * (self.target_z - x[2]), 0.0, 1.0))
        mp = MotorPower(m=np.full(4, u), stamp=timestamp)
        self.publish(mp)
        return mp


def position_controller_motors(x: torch.Tensor, pos_cmd: torch.Tensor, yaw_cmd, p,
                               kp=(6.0, 6.0, 8.0), kd=(4.5, 4.5, 5.5),
                               k_rot=150.0, k_rate=24.0) -> torch.Tensor:
    """Geometric position controller: (state (..., 13), position setpoint
    (..., 3), yaw (...)) -> motor activations (..., 4) in [0, 1]; p holds one
    vehicle's parameters.  The stand-in for the Crazyflie's onboard
    controller behind ``cmdPosition``.

    A Lee-style cascade: PD position -> desired world force -> collective
    thrust along body z and the desired attitude from the yaw -> a P law on
    the rotation error and the body rates -> torques through the diagonal
    inertia -> per-rotor thrusts through the inverse of the plant's rotor
    mixing (T = sum f, tx = f.y_f, ty = -f.x_f, tz = f.z_l_tau; the 4 x 4
    solve is plain tensor code).  The attitude loop (wn = sqrt(k_rot) ~ 12
    rad/s, zeta ~ 1) sits well above the position loop (wn ~ 2.5 rad/s): a
    slower one limit-cycles the cascade."""
    kw = dict(dtype=x.dtype, device=x.device)
    pos, q, vel, w = x[..., 0:3], x[..., 3:7], x[..., 7:10], x[..., 10:13]
    yaw_cmd = torch.as_tensor(yaw_cmd, **kw)

    a_des = torch.tensor(kp, **kw) * (pos_cmd - pos) - torch.tensor(kd, **kw) * vel
    f_des = p.mass * (a_des + p.g)                  # desired world force (N)

    R = q_to_rot_mat(q)
    thrust = (f_des * R[..., :, 2]).sum(-1)         # collective along body z

    unit = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-6)
    z_des = unit(f_des)
    x_c = torch.stack([torch.cos(yaw_cmd), torch.sin(yaw_cmd), torch.zeros_like(yaw_cmd)], -1)
    y_des = unit(torch.linalg.cross(z_des, x_c))
    x_des = torch.linalg.cross(y_des, z_des)
    R_des = torch.stack([x_des, y_des, z_des], dim=-1)

    # the vee of the rotation error's skew part -> body-rate P law -> torques
    E = R_des.mT @ R - R.mT @ R_des
    e_R = 0.5 * torch.stack([E[..., 2, 1], E[..., 0, 2], E[..., 1, 0]], -1)
    tau = p.J * (-k_rot * e_R - k_rate * w)

    A = torch.stack([torch.ones_like(p.x_f), p.y_f, -p.x_f, p.z_l_tau], dim=0)    # (4, 4)
    wrench = torch.cat([thrust[..., None], tau], dim=-1)
    f_rotors = torch.linalg.solve(A, wrench[..., None])[..., 0]
    return (f_rotors / p.max_thrust).clamp(0.0, 1.0)


class SimLoop:
    """A ControllerNode wired to the plant at odometry rate, on the node's
    device.  In the node's `position` actuation the loop runs the onboard
    controller's stand-in (``position_controller_motors``) between the
    PositionCommand and the plant, or a kinematic tracker."""

    def __init__(self, node: ControllerNode, plant_params, x0: np.ndarray,
                 sim_substeps: int = 2, position_tracking: str = "kinematic"):
        """position_tracking (PositionCommand actuation only):
        'kinematic': a first-order tracker with the MPC's node spacing as its
        time constant, the double of Crazyswarm's simulated ``cmdPosition``;
        'dynamic': ``position_controller_motors`` against the full
        rigid-body plant.  plant_params are moved to the node's device and
        cast to its dtype."""
        if position_tracking not in ("kinematic", "dynamic"):
            raise ValueError(f"unknown position tracking {position_tracking!r}")
        self.node = node
        self.p = plant_params.map(lambda a: a.to(node.device, node.dtype))
        self.x = np.asarray(x0, dtype=float)
        self.sim_substeps = sim_substeps
        self.position_tracking = position_tracking
        self.dt_sub = node.odometry_dt / sim_substeps
        # the host wall time of each tick flown: the node's callback and the
        # plant step; a tick on the card ends with the state copied to the
        # host, so each reading covers its finished work
        self.tick_s: list[float] = []

    def _plant(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return plant_substeps(x, u, self.p, self.dt_sub, self.sim_substeps)

    def _track_kinematic(self, cmd: PositionCommand) -> np.ndarray:
        """Close a fraction dt / dt_node of the gap to the commanded position
        a tick, so the vehicle paces the MPC's horizon; level attitude at the
        commanded yaw, velocity the gap-closing rate."""
        x = self.x.copy()
        gap = np.asarray(cmd.pos) - x[:3]
        dt_node = self.node.cfg.dt
        frac = min(1.0, self.node.odometry_dt / dt_node)
        x[:3] = x[:3] + frac * gap
        x[3:7] = [np.cos(cmd.yaw / 2), 0.0, 0.0, np.sin(cmd.yaw / 2)]
        x[7:10] = gap / dt_node
        x[10:13] = 0.0
        return x

    def run(self, max_ticks: int = 10000) -> np.ndarray:
        t = 0.0
        ten = self.node._tensor
        for _ in range(max_ticks):
            t0 = time.perf_counter()
            cmd = self.node.pose_received_cb(self.x, timestamp=t)
            if self.node.finished:
                break
            if isinstance(cmd, PositionCommand):
                if self.position_tracking == "kinematic":
                    self.x = self._track_kinematic(cmd)
                else:
                    x = ten(self.x)
                    u = position_controller_motors(x, ten(cmd.pos), ten(cmd.yaw), self.p)
                    self.x = self._plant(x, u).cpu().numpy()
            elif cmd is not None:
                self.x = self._plant(ten(self.x), ten(cmd.motors)).cpu().numpy()
            self.tick_s.append(time.perf_counter() - t0)
            t += self.node.odometry_dt
        return self.x
