"""The port's ROS-shaped node (``node.py``) on the CPU, in float64, against
the JAX package's ``node.py`` on the same inputs:

- ``TrajectoryServer``: line, static, random (two requests in a row, so the
  seed steps) and circle within 1e-12; an unknown type raises;
- ``position_controller_motors`` on 16 random states, setpoints and yaws,
  both presets, within 1e-12; the hover case gives the hover input;
- one gp2 ``ControllerNode`` flight in each package through ``SimLoop``
  (hummingbird, N=5, 20 basis vectors): off hover, so the bootstrap line
  runs, then a short line; the per-tick logs within 1e-8 (measured ~1e-12:
  no amplification over the flight), the same tick count and flags;
- the same comparison in ``actuation="position"`` on the crazyflie, once
  with the kinematic tracker and once with the onboard controller's
  stand-in against the plant;
- the port's state machine alone: bootstrap, the start at hover, a new
  trajectory ignored while one is active, the finish and its count, the
  training count, the simple-Z hygiene, and no run without a card unless
  the CPU is asked for.

The flights are short lines and each JAX flight compiles once a module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_quad_ros_tpu.node as jnode
import mpc_quad_ros_tpu_torch.node as tnode
from mpc_quad_ros_tpu.models import params as jparams
from mpc_quad_ros_tpu_torch.models import params as tparams

# the tier runs several pytest workers: one intra-op thread each
torch.set_num_threads(1)

PACKAGES = {"jax": (jnode, jparams, dict(dtype=jnp.float64)),
            "port": (tnode, tparams, dict(dtype=torch.float64, device="cpu"))}
HOVER = np.array([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)
# per-tick log keys against the JAX node's (f64, the same algorithm)
LOG_TOL = 1e-8
LOG_KEYS = ("x_odom", "w_odom", "x_pred_odom", "cost_solution")
RGP_KEYS = ("rgp_mu_g_t", "v_body", "a_drag")
FLAGS = ("finished", "number_of_trajectories_finished", "doing_a_line", "trajectory_ready",
         "need_trajectory_to_hover", "idx_traj")
# the gp2 flight: from 1.05 m below hover (the bootstrap line runs: it needs
# more than the 1 m ball), then 0.1 m along x, at 10 m/s and 10 m/s^2
GP2_START_Z, GP2_V, GP2_END = 1.95, 10.0, (0.1, 0.0, 3.0)


def short_server(mod, end, v, start=(0.0, 0.0, 3.0), keep_lines=False):
    """A `mod` TrajectoryServer that answers with the line from `start` to
    `end` at v, a; with keep_lines, a line request (the bootstrap) is
    answered as asked."""
    base = mod.TrajectoryServer(sample_dt=0.01)

    class Short(mod.TrajectoryServer):
        def handle(self, req):
            if keep_lines and req.type == "line":
                return base.handle(req)
            return base.handle(mod.TrajectoryRequest("line", np.array(start), np.array(end),
                                                     v_max=v, a_max=v))

    return Short()


def fly(pkg: str, quad: str, server_kw: dict, x0, node_kw: dict, loop_kw=None):
    """One flight of `pkg`'s node through its SimLoop: (node, final state,
    published commands)."""
    mod, params, dtype_kw = PACKAGES[pkg]
    f64 = jnp.float64 if pkg == "jax" else torch.float64
    p = getattr(params, f"{quad}_params")(dtype=f64)
    published = []
    node = mod.ControllerNode(p, short_server(mod, **server_kw), publish_control=published.append,
                              **dtype_kw, **node_kw)
    x_final = mod.SimLoop(node, p, x0, **(loop_kw or {})).run(max_ticks=3000)
    return node, x_final, published


def check_logs(a: dict, b: dict, keys):
    assert len(a["x_odom"]) == len(b["x_odom"])
    for k in keys:
        np.testing.assert_allclose(np.asarray(b[k], dtype=float), np.asarray(a[k], dtype=float),
                                   rtol=0, atol=LOG_TOL, err_msg=k)


def check_flags(a, b):
    for k in FLAGS:
        assert getattr(a, k) == getattr(b, k), k


# ---------------------------------------------------------------- messages

@pytest.mark.parametrize("kind", ["line", "static", "random", "circle"])
def test_trajectory_server_matches_jax(kind):
    start, end = np.array([0.0, 0.0, 1.0]), np.array([1.5, -0.5, 2.0])
    servers = {pkg: PACKAGES[pkg][0].TrajectoryServer(sample_dt=0.01, seed=3) for pkg in PACKAGES}
    reqs = 2 if kind == "random" else 1
    for _ in range(reqs):
        out = {}
        for pkg, server in servers.items():
            mod = PACKAGES[pkg][0]
            out[pkg] = server.handle(mod.TrajectoryRequest(
                kind, start, None if kind in ("random", "circle") else end, v_max=3.0, a_max=3.0))
        assert out["port"].x.shape == out["jax"].x.shape and out["port"].x.shape[1] == 13
        np.testing.assert_allclose(out["port"].x, np.asarray(out["jax"].x), rtol=0, atol=1e-12)
        np.testing.assert_allclose(out["port"].t, np.asarray(out["jax"].t), rtol=0, atol=1e-12)
    assert servers["port"].seed == servers["jax"].seed == 3 + (reqs if kind == "random" else 0)


def test_trajectory_server_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown trajectory"):
        tnode.TrajectoryServer().handle(tnode.TrajectoryRequest("bogus"))
    with pytest.raises(ValueError, match="static request"):
        tnode.TrajectoryServer().handle(tnode.TrajectoryRequest("static", np.zeros(3)))


# ---------------------------------------------------------------- the cmdPosition cascade

@pytest.mark.parametrize("quad", ["hummingbird", "crazyflie"])
def test_position_controller_motors_matches_jax(quad):
    rng = np.random.default_rng(4)
    n = 16
    x = np.zeros((n, 13))
    x[:, :3] = rng.uniform(-1.0, 1.0, (n, 3)) + [0.0, 0.0, 2.0]
    q = rng.standard_normal((n, 4)) * [1.0, 0.2, 0.2, 0.5] + [2.0, 0.0, 0.0, 0.0]
    x[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 7:10] = rng.uniform(-2.0, 2.0, (n, 3))
    x[:, 10:13] = rng.uniform(-1.0, 1.0, (n, 3))
    pos = x[:, :3] + rng.uniform(-0.5, 0.5, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, n)

    pj = getattr(jparams, f"{quad}_params")(dtype=jnp.float64)
    ref = jax.vmap(lambda a, b, c: jnode.position_controller_motors(a, b, c, pj))(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(yaw))
    pt = getattr(tparams, f"{quad}_params")(dtype=torch.float64)
    got = tnode.position_controller_motors(torch.tensor(x), torch.tensor(pos), torch.tensor(yaw), pt)
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)
    # one state at a time gives the same rows
    one = tnode.position_controller_motors(torch.tensor(x[3]), torch.tensor(pos[3]), yaw[3], pt)
    np.testing.assert_allclose(one.numpy(), got[3].numpy(), rtol=0, atol=1e-15)


def test_position_controller_motors_hovers():
    """Holding a hover setpoint: every rotor at the hover input."""
    p = tparams.crazyflie_params(dtype=torch.float64)
    x = torch.tensor([0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=torch.float64)
    u = tnode.position_controller_motors(x, torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                                         0.0, p)
    np.testing.assert_allclose(u.numpy(), float(p.hover_input), atol=1e-6)


# ---------------------------------------------------------------- the flights

@pytest.fixture(scope="module")
def gp2_flights():
    x0 = HOVER.copy()
    x0[2] = GP2_START_Z
    return {pkg: fly(pkg, "hummingbird", dict(end=GP2_END, v=GP2_V, keep_lines=True), x0,
                     dict(use_gp=2, v_max=GP2_V, a_max=GP2_V, trajectory_type="circle"))
            for pkg in PACKAGES}


def test_gp2_flight_matches_jax(gp2_flights):
    (jn, jx, _), (tn, tx, _) = gp2_flights["jax"], gp2_flights["port"]
    assert tn.cfg.n_nodes == 5 and tn.rgp_state.X.shape == (3, 20)
    assert tn.control_freq_factor == jn.control_freq_factor == 20
    check_flags(jn, tn)
    check_logs(jn.logger.dictionary, tn.logger.dictionary, LOG_KEYS + RGP_KEYS)
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=0, atol=LOG_TOL)
    # the logged reference is the trajectory's, and the posterior is logged
    d = tn.logger.dictionary
    np.testing.assert_array_equal(np.asarray(d["x_ref"]), np.asarray(jn.logger.dictionary["x_ref"]))
    assert np.asarray(d["rgp_C_g_t"]).shape == (len(d["x_odom"]), 3, 20, 20)


def test_closed_loop_flight_finishes_and_counts(gp2_flights):
    """The bootstrap line is flown and not logged; the main line finishes,
    counts one run and logs the reference's keys with per-tick times."""
    node, x_final, published = gp2_flights["port"]
    assert node.finished and node.number_of_trajectories_finished == 1
    assert not node.doing_a_line
    assert len(published) > len(node.logger.dictionary["x_odom"]) > 20
    np.testing.assert_allclose(x_final[:3], GP2_END, atol=0.5)
    d = node.logger.dictionary
    for key in ("x_odom", "x_pred_odom", "x_ref", "w_odom", "t_cpu", "elapsed_during_mpc",
                "cost_solution", "rgp_mu_g_t", "v_body", "a_drag", "rgp_basis_vectors",
                "rgp_C_g_t", "rgp_theta", "t_odom"):
        assert key in d, key
    assert all(t > 0 for t in d["t_cpu"])
    assert isinstance(published[0], tnode.ControlCommand) and published[0].motors.shape == (4,)


@pytest.mark.parametrize("tracking, end", [("kinematic", (0.1, 0.0, 3.0)),
                                           ("dynamic", (0.0, 0.0, 3.1))])
def test_cmdposition_flight_matches_jax(tracking, end):
    """The crazyflie in actuation="position": the published setpoints and
    the per-tick logs against the JAX node's."""
    out = {pkg: fly(pkg, "crazyflie", dict(end=end, v=4.0), HOVER,
                    dict(v_max=4.0, a_max=4.0, actuation="position"),
                    dict(position_tracking=tracking)) for pkg in PACKAGES}
    (jn, jx, jpub), (tn, tx, tpub) = out["jax"], out["port"]
    check_flags(jn, tn)
    check_logs(jn.logger.dictionary, tn.logger.dictionary, LOG_KEYS)
    assert len(tpub) == len(jpub) and all(isinstance(c, tnode.PositionCommand) for c in tpub)
    np.testing.assert_allclose([c.pos for c in tpub], [np.asarray(c.pos) for c in jpub],
                               rtol=0, atol=LOG_TOL)
    np.testing.assert_allclose([c.yaw for c in tpub], [c.yaw for c in jpub], rtol=0, atol=LOG_TOL)
    assert tn.finished
    np.testing.assert_allclose(tx[:3], end, atol=0.3)
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=0, atol=LOG_TOL)


# ---------------------------------------------------------------- the state machine

def make_node(**kw):
    p = tparams.hummingbird_params(dtype=torch.float64)
    kw.setdefault("v_max", 4.0)
    kw.setdefault("a_max", 4.0)
    return p, tnode.ControllerNode(p, tnode.TrajectoryServer(sample_dt=0.01), dtype=torch.float64,
                                   device="cpu", **kw)


def test_bootstrap_line_to_hover():
    """Away from hover the line to hover is requested first, and its ticks
    are not logged."""
    _, node = make_node(trajectory_type="line")
    x_ground = np.array([0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)
    cmd = node.pose_received_cb(x_ground, 0.0)
    assert node.doing_a_line and node.trajectory_ready
    np.testing.assert_allclose(node.x_trajectory[-1, :3], node.HOVER_POS, atol=0.05)
    assert cmd is not None and cmd.motors.shape == (4,)
    assert node.logger.dictionary == {}
    # the carry and the prediction stay on the node's device as tensors
    assert isinstance(node.x_pred_prev, torch.Tensor) and node.solver_carry.X.shape == (6, 13)


def test_starts_directly_when_at_hover():
    _, node = make_node(trajectory_type="circle")
    node.pose_received_cb(HOVER, 0.0)
    assert not node.doing_a_line and node.trajectory_ready
    assert len(node.x_trajectory) == 3000
    assert len(node.logger.dictionary["x_odom"]) == 1


def test_ignores_new_trajectory_while_active():
    _, node = make_node(trajectory_type="circle")
    node.pose_received_cb(HOVER, 0.0)
    first = node.x_trajectory
    node.trajectory_received_cb(tnode.Trajectory(np.zeros((5, 13)), np.arange(5.0)))
    assert node.x_trajectory is first


def test_training_counts_multiple_runs():
    """Two training runs, out and back, then the node is finished."""
    p, node = make_node(trajectory_type="line", training=True, training_trajectories_count=2)
    base = node.server

    class OutAndBack(tnode.TrajectoryServer):
        def __init__(self):
            self.n = 0

        def handle(self, req):
            self.n += 1
            a, b = ([0, 0, 3.0], [0.1, 0, 3.0]) if self.n % 2 else ([0.1, 0, 3.0], [0, 0, 3.0])
            return base.handle(tnode.TrajectoryRequest("line", np.array(a), np.array(b),
                                                       v_max=4.0, a_max=4.0))

    node.server = OutAndBack()
    tnode.SimLoop(node, p, HOVER).run(max_ticks=3000)
    assert node.number_of_trajectories_finished == 2 and node.finished
    assert node.server.n == 2


def test_simple_z_controller_hygiene():
    """Stale and undersampled odometry is dropped; the P law pushes toward
    the target altitude."""
    ctrl = tnode.SimpleZController(target_z=1.0, kp=0.4, hover=0.3)
    x_low = np.zeros(13)
    x_low[2] = 0.5
    mp = ctrl.odometry_cb(x_low, timestamp=1.0)
    assert mp is not None and mp.m[0] > 0.3
    assert ctrl.odometry_cb(x_low, timestamp=1.005) is None
    assert ctrl.odometry_cb(x_low, timestamp=1.05, now=2.0) is None
    x_high = np.zeros(13)
    x_high[2] = 2.0
    assert ctrl.odometry_cb(x_high, timestamp=1.2).m[0] < 0.3


def test_node_needs_the_card_unless_asked_for_the_cpu():
    p = tparams.hummingbird_params(dtype=torch.float64)
    with pytest.raises(ValueError, match="actuation"):
        tnode.ControllerNode(p, tnode.TrajectoryServer(), actuation="bodyrates", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tnode.ControllerNode(p, tnode.TrajectoryServer())
    _, node = make_node()
    with pytest.raises(ValueError, match="position tracking"):
        tnode.SimLoop(node, p, HOVER, position_tracking="teleport")
