"""The numpy leaves under the simulation entry point, on the CPU, against the JAX
package: the rotations (float64, 1e-12), the metrics (1e-12), the
trajectory generators (circles, square, waypoints, the piecewise polynomial,
min-snap: bitwise or 1e-12; the port's native min-snap against its numpy
one at tests/test_native_minsnap.py's tolerances), the CSV files read both
ways, ``SimConfig``, the metric half of ``Visualiser`` (1e-12), the
``Explorer`` curriculum and ``profile_solver_phases``' keys."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_quad_ros_tpu.io.profiling as jprof
import mpc_quad_ros_tpu.traj as jtraj
import mpc_quad_ros_tpu.traj.minsnap as jminsnap
import mpc_quad_ros_tpu.traj.plot as jplot
import mpc_quad_ros_tpu.utils.metrics as jmetrics
import mpc_quad_ros_tpu.utils.rotations as jrot
from mpc_quad_ros_tpu.explorer import Explorer as JaxExplorer
from mpc_quad_ros_tpu.io.config import SimConfig as JaxSimConfig
from mpc_quad_ros_tpu.io.logger import Logger as JaxLogger
from mpc_quad_ros_tpu.io.viz import Visualiser as JaxVisualiser
import mpc_quad_ros_tpu_torch.traj as ttraj
import mpc_quad_ros_tpu_torch.traj.minsnap as tminsnap
import mpc_quad_ros_tpu_torch.traj.plot as tplot
import mpc_quad_ros_tpu_torch.utils.metrics as tmetrics
import mpc_quad_ros_tpu_torch.utils.rotations as trot
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.explorer import Explorer
from mpc_quad_ros_tpu_torch.io import Logger, SimConfig, save_dict
from mpc_quad_ros_tpu_torch.io import profiling
from mpc_quad_ros_tpu_torch.io.viz import Visualiser
from mpc_quad_ros_tpu_torch.models import GPEnsemble, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry
from mpc_quad_ros_tpu_torch.traj.native_minsnap import native_available, native_min_snap_trajectory

from test_torch_common import port_params, t
from test_torch_cuda_common import solve_inputs

TOL = 1e-12


def close(ours, theirs, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=tol)


# ---------------------------------------------------------------- rotations

def quats(n: int = 64, seed: int = 0) -> np.ndarray:
    """Unit quaternions, some of them scaled off the unit sphere."""
    q = np.random.default_rng(seed).standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[: n // 4] *= 1.3
    return q


def test_quaternion_products_and_rates_match_jax():
    q, r = quats(seed=1), quats(seed=2)
    w = np.random.default_rng(3).standard_normal((64, 3))
    close(trot.q_dot_q(t(q), t(r)), jrot.q_dot_q(jnp.asarray(q), jnp.asarray(r)))
    close(trot.skew_symmetric4(t(w)), jrot.skew_symmetric4(jnp.asarray(w)))
    flips = np.where(np.random.default_rng(4).random((64, 1)) < 0.5, -1.0, 1.0)
    close(trot.undo_quaternion_flip(t(q), t(q * flips + 0.1 * r)),
          jrot.undo_quaternion_flip(jnp.asarray(q), jnp.asarray(q * flips + 0.1 * r)))
    for ours, theirs in zip(trot.decompose_quaternion(t(q)), jrot.decompose_quaternion(jnp.asarray(q))):
        close(ours, theirs)


def test_euler_conversions_match_jax():
    rpy = np.random.default_rng(5).uniform(-1.5, 1.5, (3, 64))
    close(trot.euler_to_quaternion(*map(t, rpy)), jrot.euler_to_quaternion(*map(jnp.asarray, rpy)))
    q = quats(seed=6)
    close(trot.quaternion_to_euler(t(q)), jrot.quaternion_to_euler(jnp.asarray(q)))


@pytest.mark.parametrize("pivot", range(4))
def test_rotation_matrix_to_quat_matches_jax_on_each_branch(pivot):
    """Rotations whose quaternions are dominated by component `pivot`: the
    branch that takes that pivot's square."""
    rng = np.random.default_rng(10 + pivot)
    q = 0.15 * rng.standard_normal((32, 4))
    q[:, pivot] += np.where(rng.random(32) < 0.5, -1.0, 1.0)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jrot.q_to_rot_mat(jnp.asarray(q)))
    tr = np.trace(R, axis1=1, axis2=2)
    d = np.diagonal(R, axis1=1, axis2=2)
    squares = np.stack([1 + tr, 1 + d[:, 0] - d[:, 1] - d[:, 2], 1 - d[:, 0] + d[:, 1] - d[:, 2],
                        1 - d[:, 0] - d[:, 1] + d[:, 2]], axis=1)
    assert (squares.argmax(1) == pivot).all()
    close(trot.rotation_matrix_to_quat(t(R)), jrot.rotation_matrix_to_quat(jnp.asarray(R)))
    close(trot.rotation_matrix_to_euler(t(R)), jrot.rotation_matrix_to_euler(jnp.asarray(R)))
    # the quaternion back, up to its sign
    back = trot.rotation_matrix_to_quat(t(R)).numpy()
    np.testing.assert_allclose(np.abs((back * q).sum(1)), 1.0, rtol=0, atol=TOL)


# ---------------------------------------------------------------- metrics

def test_metrics_match_jax():
    rng = np.random.default_rng(20)
    x1, x2 = rng.standard_normal((50, 3)), rng.standard_normal((50, 3))
    t1 = np.linspace(0.0, 5.0, 50)
    t2 = np.linspace(0.3, 5.5, 50)
    for a, b in ((t1, t1), (t1, t2)):
        assert abs(tmetrics.interpol_mse(a, x1, b, x2, 200)
                   - jmetrics.interpol_mse(a, x1, b, x2, 200)) <= TOL
    x, xr = rng.standard_normal(13), rng.standard_normal(13)
    mask = rng.uniform(0.0, 2.0, 12)
    assert abs(tmetrics.quaternion_state_mse(x, xr, mask)
               - jmetrics.quaternion_state_mse(x, xr, mask)) <= TOL
    for thresh in (None, 0.5, 10.0):
        assert tmetrics.euclidean_dist(x[:3], xr[:3], thresh) == jmetrics.euclidean_dist(
            x[:3], xr[:3], thresh)
    traj = rng.standard_normal((7, 13))
    for ours, theirs in zip(tmetrics.separate_variables(traj), jmetrics.separate_variables(traj)):
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError):
        tmetrics.interpol_mse(t1, x1, t2, x2[:, :2])


# ---------------------------------------------------------------- trajectories

@pytest.mark.parametrize("name, kw", [
    ("circle_trajectory_accelerating", dict(radius=10.0, v_max=8.0, t_max=30.0, dt=0.1)),
    ("circle_trajectory_accelerating", dict(radius=5.0, v_max=3.0, dt=0.01, start_point=(1, 2, 3))),
    ("circle_trajectory_constant", dict(radius=10.0, v_max=6.0, dt=0.1)),
    ("circle_trajectory_acc_dec", dict(radius=4.0, v_max=5.0, dt=0.05, start_point=(0, 0, 2)))])
def test_circles_match_jax(name, kw):
    ours, theirs = getattr(ttraj, name)(**kw), getattr(jtraj, name)(**kw)
    for a, b in zip(ours, theirs):
        assert a.shape == np.shape(b)
        close(a, b)


def test_square_and_waypoints_match_jax():
    np.testing.assert_array_equal(ttraj.square_trajectory(60, 0.1, 2.0),
                                  jtraj.square_trajectory(60, 0.1, 2.0))
    for kw in (dict(hsize=30.0, num_waypoints=10, start_point=(0, 0, 3), seed=0),
               dict(hsize=[5.0, 8.0, 2.0], num_waypoints=4, hover_first=True, seed=7)):
        np.testing.assert_array_equal(ttraj.random_waypoints(**kw), jtraj.random_waypoints(**kw))
    np.testing.assert_array_equal(ttraj.line_waypoints((0, 0, 1), (3, 4, 5)),
                                  jtraj.line_waypoints((0, 0, 1), (3, 4, 5)))


@pytest.fixture(scope="module")
def waypoints():
    return ttraj.random_waypoints(hsize=10.0, num_waypoints=6, start_point=(0, 0, 3), seed=3)


def test_min_snap_and_polynomial_match_jax(waypoints):
    ours = tminsnap.min_snap_trajectory(waypoints, 8.0, 6.0, backend="python")
    theirs = jminsnap.min_snap_trajectory(waypoints, 8.0, 6.0, backend="python")
    # the same numpy operations in the same order
    np.testing.assert_array_equal(ours.durations, theirs.durations)
    np.testing.assert_array_equal(ours.coeffs, theirs.coeffs)
    ts = np.linspace(0.0, theirs.duration, 301)
    a, b = ours.eval(ts), theirs.eval(ts)
    assert a.keys() == b.keys()
    for k in a:
        close(a[k], b[k])
    same = ours
    stretched, jstretched = same.stretchtime(1.7), theirs.stretchtime(1.7)
    close(stretched.coeffs, jstretched.coeffs)
    close(stretched.durations, jstretched.durations)
    for x, y in zip(ttraj.sample_polynomial_trajectory(same, 0.1),
                    jtraj.sample_polynomial_trajectory(theirs, 0.1)):
        close(x, y)
    s_ours, s_theirs = tplot.trajectory_stats(same), jplot.trajectory_stats(theirs)
    for k in s_theirs:
        close(s_ours[k], s_theirs[k])
    with pytest.raises(ValueError):
        tminsnap.min_snap_trajectory(waypoints[:1], 8.0, 6.0)
    with pytest.raises(ValueError):
        tminsnap.min_snap_trajectory(waypoints, 8.0, 6.0, backend="other")


def test_native_min_snap_matches_numpy():
    if not native_available():
        pytest.skip("g++ is not available to build the native min-snap")
    for seed in (0, 3, 11):
        wp = ttraj.random_waypoints(hsize=10.0, num_waypoints=6, start_point=(0, 0, 3), seed=seed)
        py = tminsnap.min_snap_trajectory(wp, 8.0, 6.0, backend="python")
        nat = native_min_snap_trajectory(wp, 8.0, 6.0)
        np.testing.assert_allclose(nat.durations, py.durations, rtol=1e-8)
        ts = np.linspace(0, py.duration * 0.999, 200)
        np.testing.assert_allclose(nat.eval_flat(ts)["pos"], py.eval_flat(ts)["pos"], atol=1e-6)
    auto = tminsnap.min_snap_trajectory(wp, 8.0, 6.0)
    np.testing.assert_array_equal(auto.durations, nat.durations)


def test_csv_files_read_both_ways(waypoints, tmp_path):
    poly = tminsnap.min_snap_trajectory(waypoints, 8.0, 6.0, backend="python")
    poly.savecsv(str(tmp_path / "ours.csv"))
    jtraj.PiecewisePolynomial4D(poly.durations, poly.coeffs).savecsv(str(tmp_path / "theirs.csv"))
    for name in ("ours.csv", "theirs.csv"):
        a = ttraj.PiecewisePolynomial4D.loadcsv(str(tmp_path / name))
        b = jtraj.PiecewisePolynomial4D.loadcsv(str(tmp_path / name))
        np.testing.assert_array_equal(a.durations, b.durations)
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "theirs.csv").read_text()

    sampled = ttraj.sample_polynomial_trajectory(poly, 0.1)
    ttraj.save_sampled_csv(str(tmp_path / "s_ours.csv"), *sampled)
    jtraj.save_sampled_csv(str(tmp_path / "s_theirs.csv"), *sampled)
    assert (tmp_path / "s_ours.csv").read_text() == (tmp_path / "s_theirs.csv").read_text()
    for x, y in zip(ttraj.load_sampled_csv(str(tmp_path / "s_theirs.csv")),
                    jtraj.load_sampled_csv(str(tmp_path / "s_ours.csv"))):
        np.testing.assert_array_equal(x, y)

    wp_csv = tmp_path / "wp.csv"
    np.savetxt(wp_csv, waypoints, fmt="%.6f", delimiter=",")
    tminsnap.generate_trajectory_csv(str(wp_csv), str(tmp_path / "gen.csv"), 8.0, 6.0)
    gen = jtraj.PiecewisePolynomial4D.loadcsv(str(tmp_path / "gen.csv"))
    assert len(gen.durations) == len(waypoints) - 1


def test_plot_cli_prints_and_plots(waypoints, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "poly.csv")
    tminsnap.min_snap_trajectory(waypoints, 8.0, 6.0, backend="python").savecsv(path)
    assert tplot.main([path, "--stretchtime", "1.5", "-o", str(tmp_path / "poly.png")]) == 0
    assert "max speed" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / "poly.png") > 1000


# ---------------------------------------------------------------- configuration

def test_sim_config_parses_and_clamps_as_jax(tmp_path):
    spec = {"runs": [{"gpe": 1, "trajectory": 2, "v_max": 10, "a_max": 10},
                     {"gpe": 0, "trajectory": 1, "v_max": 45, "a_max": 31.5}]}
    path = tmp_path / "matrix.json"
    path.write_text(json.dumps(spec))
    ours, theirs = SimConfig.from_json(str(path)), JaxSimConfig.from_json(str(path))
    assert [dataclasses.asdict(c) for c in ours] == [dataclasses.asdict(c) for c in theirs]
    assert ([dataclasses.asdict(c.clamp_limits()) for c in ours]
            == [dataclasses.asdict(c.clamp_limits()) for c in theirs])
    assert ours[1].clamp_limits().v_max == 30.0 and ours[1].clamp_limits().a_max == 30.0
    assert dataclasses.asdict(SimConfig()) == dataclasses.asdict(JaxSimConfig())


# ---------------------------------------------------------------- the learning metric

def episode_log(T: int = 80, seed: int = 30) -> dict:
    """A log dict under the reference's keys, with a ragged entry."""
    rng = np.random.default_rng(seed)
    x_ref = rng.standard_normal((T, 13))
    x_odom = x_ref + 0.1 * rng.standard_normal((T, 13))
    x_odom[:, 7:10] += 3.0 * rng.standard_normal((T, 3))
    return {"x_odom": list(x_odom), "x_ref": list(x_ref), "t_odom": list(0.1 * np.arange(T)),
            "w_odom": list(rng.uniform(0, 1, (T, 4))), "ragged": [[1.0], [1.0, 2.0]],
            "t_cpu_kind": "amortized_episode_wall"}


def test_visualiser_metrics_match_jax(tmp_path):
    d = episode_log()
    path = str(tmp_path / "log.pkl")
    save_dict(d, path)
    lg, jlg = Logger(), JaxLogger()
    lg.dictionary, jlg.dictionary = d, d
    ref = JaxVisualiser(d)
    for viz in (Visualiser(d), Visualiser.from_logger(lg), Visualiser.from_file(path)):
        assert viz.d.keys() == ref.d.keys() and viz.d["ragged"] == d["ragged"]
        ours, theirs = viz.rms_errors(), ref.rms_errors()
        assert ours.keys() == theirs.keys()
        for k in theirs:
            assert abs(ours[k] - theirs[k]) <= TOL
        close(viz.velocity_error_covariance(), ref.velocity_error_covariance())
    jviz = JaxVisualiser.from_logger(jlg)
    close(Visualiser.from_file(path).velocity_error_covariance(), jviz.velocity_error_covariance())


# ---------------------------------------------------------------- the curriculum

def test_explorer_curriculum_matches_jax():
    assert Explorer(None).velocity_to_explore == JaxExplorer(None).velocity_to_explore == 10.0

    class FakeState:
        X = np.stack([np.linspace(-12, 12, 5)] * 3)

    class FakeGpe:
        state = FakeState()

    assert Explorer(FakeGpe()).velocity_to_explore == JaxExplorer(FakeGpe()).velocity_to_explore == 20.0
    # a port ensemble (tensors): explored 4 m/s on its narrowest axis
    gpe = GPEnsemble.fromrange([(-6.0, 6.0), (-4.0, 4.0), (-5.0, 5.0)], 5, device="cpu")
    ex = Explorer(gpe, desired_explored_vmax=30.0, exploration_step=7.0)
    ref = JaxExplorer(FakeGpe(), desired_explored_vmax=30.0, exploration_step=7.0)
    assert ex.calculate_explored_vmax(ex.explored_velocities) == 4.0
    assert ex.velocity_to_explore == 11.0
    assert ex.calculate_velocity_to_explore(25.0) == ref.calculate_velocity_to_explore(25.0) == 30.0


# ---------------------------------------------------------------- profiling

def test_profile_solver_phases_keys_on_the_cpu(tmp_path):
    inp = solve_inputs(4, seed=90)
    p = port_params()
    cfg = MPCConfig(u_ref=float(p.hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    rgp = interop.rgp_state_from_numpy(inp["rgp"])
    res = profiling.profile_solver_phases(solver, init_carry(cfg, x0), x0, y_ref, rgp, iters=1)
    keys = {"linearize_s", "assemble_s", "qp_s", "full_solve_s", "batch", "solves_per_s"}
    assert set(res) == keys
    assert res["batch"] == 4 and all(res[k] > 0 for k in keys)
    # the JAX function's keys (read from its source: it needs the TPU kernels)
    src = open(jprof.__file__).read()
    assert all(f'"{k}"' in src for k in keys)

    sw = profiling.Stopwatch()
    with sw.phase("a", block_on=x0):
        x0.sum()
    assert "a" in sw.phases and "total" in sw.report()
    assert profiling.timed(torch.mul, x0, 2.0, iters=2) > 0
    with profiling.trace(str(tmp_path / "trace")):
        torch.mul(x0, 2.0)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
