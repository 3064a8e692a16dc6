"""The port's offline learned-drag workflow against the JAX package's, CPU,
float64: a logged flight (``io/logger.py``) -> the drag labels and training
points (``models/dataloader.py``, ``models/selection.py``) -> the fits
(``models/train.py``) -> the model files (``models/ensemble.py``), plus the
checkpoint of the closed loop's carry (``io/checkpoint.py``) and
``params_from_xacro``.

- Selection and ``DataLoaderGP``: bitwise (the same numpy code, the same
  float64 rotation).
- Logs and model files cross between the packages both ways: a log the
  port writes reads in the JAX ``DataLoaderGP``; ``mdl_{x,y,z}.gp/.rgp``
  saved by either load in the other (GP, and RGP with a learn state).
- ``train_gp``: the fitted thetas to 1e-6 relative (``gp_fit``'s rule);
  ``train_rgp``: the streamed posterior to 1e-9 relative.
- The checkpoint: ten plus ten ticks across a save and a load bitwise
  twenty."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.io.logger import Logger as JaxLogger
from mpc_quad_ros_tpu.loop.episode import EpisodeOutput as JaxOutput
from mpc_quad_ros_tpu.models import dataloader as jdl
from mpc_quad_ros_tpu.models import selection as jsel
from mpc_quad_ros_tpu.models import train as jtrain
from mpc_quad_ros_tpu.models.ensemble import GPEnsemble as JaxEnsemble
from mpc_quad_ros_tpu.models.gp import gp_init as jax_gp_init
from mpc_quad_ros_tpu.models.params import params_from_xacro as jax_from_xacro
from mpc_quad_ros_tpu.models.rgp import RGPLearnState as JaxLearnState
from mpc_quad_ros_tpu.models.rgp import rgp_learn_init as jax_learn_init
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.io import Logger, load_checkpoint, load_dict, save_checkpoint, save_dict
from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode
from mpc_quad_ros_tpu_torch.models import GPEnsemble, make_mpc_dynamics, params_from_xacro
from mpc_quad_ros_tpu_torch.models import dataloader as tdl
from mpc_quad_ros_tpu_torch.models import selection as tsel
from mpc_quad_ros_tpu_torch.models import train as ttrain
from mpc_quad_ros_tpu_torch.models.gp import gp_init
from mpc_quad_ros_tpu_torch.models.rgp import rgp_learn, rgp_learn_init
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
from mpc_quad_ros_tpu_torch.traj import circle_trajectory_accelerating, states_from_flat_outputs

from test_torch_common import as_numpy, jax_params, port_params, rgp_batch, t

TICKS = 20
N_TRAIN = 8


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny))


def circle() -> torch.Tensor:
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, 8.0, t_max=10.0, dt=0.1)
    return t(states_from_flat_outputs(pos, vel))


def port_solver() -> SQPSolver:
    return SQPSolver(MPCConfig(u_ref=float(jax_params().hover_input)),
                     make_mpc_dynamics(port_params()))


def flight_inputs():
    """One hummingbird from hover at 3 m on the 8 m/s circle, the RGP on
    (gp2) from its prior: (cfg, solver, params, x0, trajectory, RGP)."""
    solver = port_solver()
    x0 = torch.zeros(13, dtype=torch.float64)
    x0[3], x0[2] = 1.0, 3.0
    rgp = interop.rgp_state_from_numpy(rgp_batch(1, np.random.default_rng(0), mu_scale=0.0))
    return (EpisodeConfig(mpc=solver.cfg), solver, port_params(), x0, circle(),
            rgp.map(lambda a: a[0]))


@functools.lru_cache(maxsize=None)
def flight():
    """TICKS ticks of ``run_episode`` on `flight_inputs()`, the posterior
    logged: the outputs and their times."""
    cfg, solver, p, x0, traj, rgp = flight_inputs()
    _, outs = run_episode(cfg, solver, p, x0, traj, TICKS, rgp)
    return outs, torch.arange(TICKS, dtype=torch.float64) * cfg.mpc.dt


@pytest.fixture
def log_path(tmp_path):
    outs, t_odom = flight()
    path = str(tmp_path / "flight.pkl")
    save_dict(Logger.from_episode(outs, t_odom=t_odom).dictionary, path)
    return path


def test_selection_is_bitwise_the_jax_packages():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 3)) * np.array([1.0, 2.0, 0.5])
    y = rng.standard_normal((200, 3)) ** 3
    np.testing.assert_array_equal(tsel.prune_dataset(x, y, 2.5, 20, 0.01),
                                  jsel.prune_dataset(x, y, 2.5, 20, 0.01))
    for pts in (x[:, 0], x[:, :1], x):
        for n in (7, 40):
            a = tsel.distance_maximizing_points(pts, n, np.random.default_rng(3))
            b = jsel.distance_maximizing_points(pts, n, np.random.default_rng(3))
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsel.distance_maximizing_points_1d(x[:, 1], 12),
                                  jsel.distance_maximizing_points_1d(x[:, 1], 12))
    np.testing.assert_array_equal(tsel.distance_maximizing_points_2d(x, 12),
                                  jsel.distance_maximizing_points_2d(x, 12))
    used = np.arange(0, 200, 10)
    np.testing.assert_array_equal(
        tsel.sample_random_points(x, used, 15, np.random.default_rng(4)),
        jsel.sample_random_points(x, used, 15, np.random.default_rng(4)))


def test_log_from_episode_matches_the_jax_logger():
    """The same outputs, as tensors through the port's logger and as arrays
    through the JAX package's: the same keys and values."""
    outs, t_odom = flight()
    ours = Logger.from_episode(outs, t_odom=t_odom, solve_time_s=1.5).dictionary
    ref = JaxLogger.from_episode(JaxOutput(**{k: None if v is None else v.numpy()
                                              for k, v in outs.fields().items()}),
                                 t_odom=t_odom.numpy(), solve_time_s=1.5).dictionary
    assert ours.keys() == ref.keys()
    assert {"rgp_C_g_t", "rgp_theta", "v_body", "t_cpu_kind"} <= ours.keys()
    for k in ref:
        if k in ("t_cpu_kind", "rgp_theta", "t_cpu"):
            assert ours[k] == ref[k], k
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("method", ["kmeans", "gmm"])
def test_dataloader_is_bitwise_the_jax_packages_on_a_port_log(log_path, method):
    if method == "gmm":
        pytest.importorskip("sklearn")
    ours = tdl.DataLoaderGP(log_path, N_TRAIN, method=method)
    ref = jdl.DataLoaderGP(log_path, N_TRAIN, method=method)
    for k in ("X", "y", "X_train", "y_train"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)
    assert ours.X.shape == (TICKS - 1, 3) and ours.X_train.shape == (N_TRAIN, 3)
    assert load_dict(log_path).keys() == Logger.from_episode(flight()[0], flight()[1]).dictionary.keys()


def _jax_learn(jgpe):
    return jax.vmap(jax_learn_init)(jgpe.state)._replace(
        mu_eta=jnp.asarray([[2.0, 0.3, 0.1]] * 3), C_eta=jnp.asarray(np.eye(3) * 0.5)[None].repeat(3, 0))


@pytest.mark.parametrize("kind", ["GP", "RGP"])
def test_model_files_cross_between_the_packages(tmp_path, kind):
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(-8.0, 8.0, (3, 6)), axis=1)
    y = rng.standard_normal((3, 6))
    if kind == "GP":
        jgpe = JaxEnsemble.fromlist([jax_gp_init(jnp.asarray(X[d]), jnp.asarray(y[d]),
                                                 (2.0, 1.5, 0.05)) for d in range(3)])
    else:
        A = rng.standard_normal((3, 6, 6))
        jgpe = JaxEnsemble.frombasisvectors(X, y, A @ np.swapaxes(A, 1, 2), [(2.0, 0.3, 0.1)] * 3)
        jgpe.learn = _jax_learn(jgpe)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jgpe.save(jax_dir)
    ours = GPEnsemble.fromdir(jax_dir, kind, device="cpu")
    names = ("X", "y", "theta") if kind == "GP" else ("X", "mu_g", "C_g", "theta")
    for k in names:
        np.testing.assert_array_equal(getattr(ours.state, k).numpy(), np.asarray(getattr(jgpe.state, k)))
    derived = ("alpha", "K_inv") if kind == "GP" else ("K_x_inv",)
    for k in derived:
        assert rel(getattr(ours.state, k), getattr(jgpe.state, k)) <= 1e-10, k
    if kind == "RGP":
        for k in ("mu_eta", "C_eta", "C_g_eta"):
            np.testing.assert_array_equal(getattr(ours.learn, k).numpy(), np.asarray(getattr(jgpe.learn, k)))
    # and back: the port's files in the JAX package, and in the port bitwise
    ours.save(port_dir)
    back = JaxEnsemble.fromdir(port_dir, kind)
    for k in names:
        np.testing.assert_array_equal(np.asarray(getattr(back.state, k)), getattr(ours.state, k).numpy())
    if kind == "RGP":
        assert isinstance(back.learn, JaxLearnState)
        np.testing.assert_array_equal(np.asarray(back.learn.C_eta), ours.learn.C_eta.numpy())
    again = GPEnsemble.fromdir(port_dir, kind, device="cpu")
    for k, v in ours.state.fields().items():
        assert torch.equal(getattr(again.state, k), v), k
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))


def test_ensemble_methods_match_jax():
    rng = np.random.default_rng(6)
    gpe = GPEnsemble.fromrange([(-5.0, 5.0)] * 3, 6, theta=(2.0, 0.3, 0.1), dtype=torch.float64,
                               device="cpu")
    jgpe = JaxEnsemble.fromrange([(-5.0, 5.0)] * 3, 6, theta=(2.0, 0.3, 0.1), dtype=jnp.float64)
    xs, ys = rng.uniform(-5.0, 5.0, (3, 4)), rng.standard_normal((3, 4))
    mu, C = gpe.regress(xs, ys)
    jmu, jC = jgpe.regress(jnp.asarray(xs), jnp.asarray(ys))
    assert rel(mu, jmu) <= 1e-9 and rel(C, jC) <= 1e-9
    assert rel(gpe.predict(xs[:, 0]), jgpe.predict(jnp.asarray(xs[:, 0]))) <= 1e-9
    y = rng.standard_normal((3, 6))
    assert rel(gpe.predict_using_y(xs, t(y)), jgpe.predict_using_y(jnp.asarray(xs), jnp.asarray(y))) <= 1e-9
    assert np.allclose(gpe.get_theta(), jgpe.get_theta(), rtol=0, atol=0)
    assert gpe.basis_vectors.shape == (3, 6)
    with pytest.raises(NotImplementedError):
        gpe.fit()
    gp = GPEnsemble.fromlist([gp_init(t(xs[d]), t(ys[d])) for d in range(3)])
    with pytest.raises(ValueError):
        gp.regress(xs, ys)


def test_train_gp_and_train_rgp_match_jax(log_path, tmp_path):
    ours = ttrain.train_gp(log_path, str(tmp_path / "gp"), N_TRAIN, plot=False, device="cpu")
    ref = jtrain.train_gp(log_path, str(tmp_path / "jgp"), N_TRAIN, plot=False)
    assert rel(ours.state.theta, ref.state.theta) <= 1e-6
    np.testing.assert_array_equal(ours.state.X.numpy(), np.asarray(ref.state.X))
    loaded = GPEnsemble.fromdir(str(tmp_path / "gp"), "GP", device="cpu")
    for k, v in ours.state.fields().items():
        assert torch.equal(getattr(loaded.state, k), v), k
    ours = ttrain.train_rgp(log_path, str(tmp_path / "rgp"), 12, plot=False, device="cpu")
    ref = jtrain.train_rgp(log_path, str(tmp_path / "jrgp"), 12, plot=False)
    for k in ("X", "mu_g", "C_g"):
        assert rel(getattr(ours.state, k), getattr(ref.state, k)) <= 1e-9, k
    assert np.isfinite(ours.state.mu_g.numpy()).all()


def test_training_cli_and_plots(log_path, tmp_path):
    assert ttrain.main(["gp", "--data", log_path, "--save_dir", str(tmp_path / "a"), "-n", "6",
                        "--cpu", "--no_plot"]) == 0
    assert sorted(os.listdir(tmp_path / "a")) == ["mdl_x.gp", "mdl_y.gp", "mdl_z.gp"]
    pytest.importorskip("matplotlib")
    ttrain.train_rgp(log_path, str(tmp_path / "b"), 6, device="cpu")
    assert {"training_data.pdf", "rgp_fit.pdf"} <= set(os.listdir(tmp_path / "b"))


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Ten ticks, the carry (with its RGP posterior and C_g) through a save
    and a load, ten more: bitwise the twenty-tick run."""
    cfg, solver, p, x0, traj, rgp = flight_inputs()
    first, a = run_episode(cfg, solver, p, x0, traj, 10, rgp)
    path = save_checkpoint(str(tmp_path / "carry"), first)
    carry = load_checkpoint(path)
    assert torch.equal(carry.rgp.C_g, first.rgp.C_g) and carry.solver.zl is None
    _, b = run_episode(cfg, solver, p, x0, traj, 10, carry0=carry, start_tick=10)
    whole, _ = flight()
    assert TICKS == 20
    for k, v in whole.fields().items():
        if v is not None:
            assert torch.equal(torch.cat([getattr(a, k), getattr(b, k)]), v), k


def test_checkpoint_round_trips_the_records(tmp_path):
    ls = rgp_learn(rgp_learn_init(interop.rgp_state_from_numpy(rgp_batch(2, np.random.default_rng(2)))),
                   t(np.full((2, 3, 1), 0.5)), t(np.ones((2, 3, 1))))
    for rec in (ls, port_params(), gp_init(t(np.linspace(-1, 1, 4)), t(np.ones(4)))):
        back = load_checkpoint(save_checkpoint(str(tmp_path / type(rec).__name__), rec))
        assert type(back) is type(rec)
        np.testing.assert_equal(interop.to_numpy(back), interop.to_numpy(rec))
    f32 = load_checkpoint(str(tmp_path / "GPState"), dtype=torch.float32)
    assert f32.alpha.dtype == torch.float32
    # the JAX package's checkpoint (a pickled treedef) is refused by name
    from mpc_quad_ros_tpu.io.checkpoint import save_checkpoint as jax_save

    with pytest.raises(ValueError, match="JAX"):
        load_checkpoint(jax_save(str(tmp_path / "jax"), {"a": jnp.ones(2)}))


XACRO = """<?xml version="1.0"?>
<robot name="quad" xmlns:xacro="http://ros.org/wiki/xacro">
  <xacro:property name="mass" value="0.68" />
  <xacro:property name="mass_rotor" value="0.009" />
  <xacro:property name="arm_length" value="0.17" />
  <xacro:property name="moment_constant" value="0.016" />
  <xacro:property name="motor_constant" value="8.54858e-06" />
  <xacro:property name="max_rot_velocity" value="838" />
  <xacro:property name="body_inertia">
    <inertia ixx="0.007" ixy="0.0" ixz="0.0" iyy="0.007" iyz="0.0" izz="0.012" />
  </xacro:property>
</robot>
"""


@pytest.mark.parametrize("quad_name", ["hummingbird", "crazy_x"])
def test_params_from_xacro_matches_jax(tmp_path, quad_name):
    path = tmp_path / "quad.xacro"
    path.write_text(XACRO)
    ours = params_from_xacro(str(path), quad_name, dtype=torch.float64, payload=True)
    ref = jax_from_xacro(str(path), quad_name, payload=True, dtype=jnp.float64)
    for k, v in as_numpy(ref).items():
        np.testing.assert_array_equal(getattr(ours, k).numpy(), v, err_msg=k)


def test_params_from_the_reference_xacro():
    from conftest import REFERENCE_DATA

    path = str(REFERENCE_DATA.parent / "config" / "hummingbird.xacro")
    if not os.path.exists(path):
        pytest.skip("the reference's hummingbird.xacro is not on this host")
    ours = params_from_xacro(path, dtype=torch.float64)
    for k, v in as_numpy(jax_from_xacro(path, dtype=jnp.float64)).items():
        np.testing.assert_array_equal(getattr(ours, k).numpy(), v, err_msg=k)


def test_gp1_workflow_bench_runs_on_cpu(tmp_path):
    """``bench/gp1_workflow.py`` end to end at a tiny size, as
    ``chip_smoke.py`` runs it on the card: a gp0 flight of 2 drones, episode
    0's log, the fit read back bitwise, the fitted GP flown, the offline RGP
    (its 'device' run is the CPU's here, so the two agree bitwise)."""
    from mpc_quad_ros_tpu_torch.bench import gp1_workflow
    from mpc_quad_ros_tpu_torch.bench.closed_loop import closed_loop

    gp0, path = gp1_workflow.training_flight(2, str(tmp_path), "cpu", t_max=3.2)
    assert gp0["drag"] == "gp0" and gp0["ticks"] == 32 and os.path.exists(path)
    gpe, fitted = gp1_workflow.fit(path, str(tmp_path / "gp1"), "cpu")
    assert fitted["reloaded_bitwise"] and fitted["samples"] == 31
    assert np.isfinite(fitted["theta"]).all() and np.min(fitted["theta"]) >= 0.01
    gp1 = closed_loop(B=2, t_max=3.2, device="cpu", drag=gpe.state, err_from=10)
    assert gp1["drag"] == "gp1" and np.isfinite(gp1["err_mean_m"])
    rgp = gp1_workflow.offline_rgp(path, str(tmp_path), "cpu", samples=10)
    assert rgp["finite"] and rgp["train_rgp_rel_vs_cpu"] == 0 and rgp["rgp_learn_rel_vs_cpu"] == 0
