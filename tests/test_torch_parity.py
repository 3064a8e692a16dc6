"""The port's parity harnesses (``bench/{parity,parity_matrix,
comparison_artifact}.py``) on the CPU, float64, against the JAX package's,
on logs written here (the reference's logs are not needed).

- One short JAX ``run_episode`` flight (one hummingbird on the accelerating
  circle at 6 m/s, N=10, 28 ticks, gp2) logged by the JAX ``Logger``; the
  same log without its learned-drag keys (those of a gp0 flight's log) is
  the gp0 log.  Both packages' ``replay_reference_log`` (N=10, skip=1, the
  python-sim operating point, 13 ticks) agree on U within 1e-9 (the
  per-scenario solve's rule, ``tests/test_torch_per_scenario.py``;
  measured 6.8e-12 gp0, 1.8e-11 gp2, 1.1e-11 gp1) in every branch: gp0; gp2
  from the python-sim log's posterior; gp2 from a ROS-shaped log
  (``rgp_params``, ``rgp_basis``, ``rgp_theta`` a numpy array, which the
  JAX package's ``rgp_theta or ...`` refuses), held to the same JAX replay
  as the python-sim branch, whose posterior, basis and theta it carries
  (the JAX ROS branch with a tuple gives that replay's U bitwise); gp1 from
  a model directory the port wrote.  One JAX replay a branch: each is a
  compile of several seconds.
- ``pred_parity`` and ``infer_python_params`` on a log whose predictions
  are the JAX package's RK4 under the ``default_v1`` preset: both packages
  pick that preset, at 1e-12, and agree on both presets' parity to 1e-12.
- ``run_matrix`` over a synthetic Gazebo / python-sim layout, and with no
  directory (a message, no rows, exit 0), and the three departures from the
  JAX matrix: a diverged log whose sane prefix is shorter than the replay
  floor plus a horizon is flagged, not replayed; a GP-flown log with no
  mode is flagged "mode unknown", not replayed as gp0; every pickle with the
  closed-loop keys gets a row, whatever its name.
- ``comparison_artifact``: the covariance table without the reference
  (a short circle), its skips and its files.
- ``bench/per_scenario.py::logged_flight`` (the log the card's replay
  reads) writes the python-sim keys with the posterior, and the log
  replays."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.bench import parity as jparity
from mpc_quad_ros_tpu.bench import parity_matrix as jmatrix
from mpc_quad_ros_tpu.io.logger import Logger as JaxLogger
from mpc_quad_ros_tpu.loop import EpisodeConfig as JaxEpisodeConfig
from mpc_quad_ros_tpu.loop import run_episode as jax_run_episode
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.models.params import default_v1_params as jax_default_v1
from mpc_quad_ros_tpu.models.params import hummingbird_params as jax_hummingbird
from mpc_quad_ros_tpu.models.rgp import rgp_init as jax_rgp_init
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu_torch.bench import comparison_artifact, parity, parity_matrix, per_scenario
from mpc_quad_ros_tpu_torch.models import GPEnsemble, gp_init

from test_torch_cuda_common import circle

TICKS, N, DROP = 28, 10, 15
REPLAY = dict(n_nodes=N, skip=1, drop_tail=DROP)
U_TOL = 1e-9
PRED_TOL = 1e-12
THETA = (3.0, 0.1, 0.01)
# the keys of a gp0 flight's log: the gp2 log without the learned drag's
GP0_KEYS = ("x_odom", "w_odom", "x_ref", "x_pred_odom", "cost_solution", "kkt_residual")


def jax_flight() -> dict:
    """One JAX gp2 episode's log dict (float64)."""
    p = jax_hummingbird(dtype=jnp.float64)
    cfg = JaxEpisodeConfig(mpc=JaxConfig(u_ref=float(p.hover_input)))
    solver = JaxSolver(cfg.mpc, jax_model(p))
    traj = jnp.asarray(circle(6.0, t_max=TICKS * 0.1))
    x0 = jnp.asarray([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], jnp.float64)
    r1 = jax_rgp_init(jnp.linspace(-6.0, 6.0, 10), theta=THETA)
    rgp0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape), r1)
    _, outs = jax.jit(lambda a, b, r: jax_run_episode(cfg, solver, p, a, b, TICKS, rgp0=r))(
        x0, traj, rgp0)
    return JaxLogger.from_episode(outs).dictionary


def save(path, d) -> str:
    with open(path, "wb") as f:
        pickle.dump(d, f)
    return str(path)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    gp2 = jax_flight()
    gp0 = {k: gp2[k] for k in GP0_KEYS}
    ros = {k: v for k, v in gp2.items() if not k.startswith("rgp_")}
    mu = np.array(gp2["rgp_mu_g_t"])
    ros["rgp_params"] = list(mu.reshape(mu.shape[0], -1))
    # a drag model both packages read: three 1-D GPs written by the port
    X = torch.linspace(-6.0, 6.0, 8, dtype=torch.float64).expand(3, 8)
    y = -0.3 * X * torch.tensor([[1.0], [0.8], [0.5]], dtype=torch.float64)
    GPEnsemble(gp_init(X, y, torch.tensor([3.0, 0.5, 0.05], dtype=torch.float64)), "GP").save(
        str(root / "gp_models"))
    return {"gp0": save(root / "traj0_v6_a6_gp0.pkl", gp0),
            "gp2": save(root / "traj0_v6_a6_gp2.pkl", gp2),
            "ros": save(root / "ros_gp2.pkl", ros), "models": str(root / "gp_models"),
            "root": root, "dicts": {"gp0": gp0, "gp2": gp2}}


def both(log, **kw):
    ours = parity.replay_reference_log(log, device="cpu", params="hummingbird", **REPLAY, **kw)
    ref = jparity.replay_reference_log(log, params="hummingbird", dtype=jnp.float64, **REPLAY,
                                       **kw)
    return ours, ref


def check_replay(ours, ref):
    assert ours["u_ours"].shape == (TICKS - DROP, 4)
    np.testing.assert_allclose(ours["u_ours"], ref["u_ours"], rtol=0, atol=U_TOL)
    np.testing.assert_array_equal(ours["u_ref"], ref["u_ref"])
    for k in ("du_mean", "du_median", "du_p95", "du_max"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=U_TOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_gp2(logs):
    """The JAX replay of the python-sim gp2 log, shared by both gp2 branches."""
    return jparity.replay_reference_log(logs["gp2"], params="hummingbird", dtype=jnp.float64,
                                        rgp_from_log=True, **REPLAY)


@pytest.mark.parametrize("mode", ["gp0", "gp2", "gp1"])
def test_replay_matches_jax(logs, mode, request):
    if mode == "gp0":
        check_replay(*both(logs["gp0"]))
    elif mode == "gp2":
        ours = parity.replay_reference_log(logs["gp2"], device="cpu", params="hummingbird",
                                           rgp_from_log=True, **REPLAY)
        check_replay(ours, request.getfixturevalue("jax_gp2"))
    else:
        check_replay(*both(logs["gp0"], gp_path=logs["models"]))


def test_replay_ros_gp2_log_matches_jax(logs, jax_gp2):
    basis = np.array(logs["dicts"]["gp2"]["rgp_basis_vectors"])[0]
    ours = parity.replay_reference_log(logs["ros"], device="cpu", params="hummingbird",
                                       rgp_from_log=True, rgp_basis=basis,
                                       rgp_theta=np.asarray(THETA), **REPLAY)
    check_replay(ours, jax_gp2)
    # the ROS branch fed the same posterior as the python-sim branch
    py = parity.replay_reference_log(logs["gp2"], device="cpu", rgp_from_log=True, **REPLAY)
    np.testing.assert_array_equal(ours["u_ours"], py["u_ours"])
    with pytest.raises(ValueError, match="ambiguous"):
        jparity.replay_reference_log(logs["ros"], rgp_from_log=True, rgp_basis=basis,
                                     rgp_theta=np.asarray(THETA), dtype=jnp.float64, **REPLAY)


def test_control_parity_report_and_main(logs, capsys, monkeypatch):
    monkeypatch.delenv("MPCQUAD_REFERENCE", raising=False)
    rows = parity.control_parity_report([logs["gp0"]], device="cpu", **REPLAY)
    assert rows[0]["log"] == logs["gp0"] and set(rows[0]) == {"log", "du_mean", "du_median",
                                                              "du_p95", "du_max"}
    assert parity.main(["--logs", "--cpu"]) == 0
    assert "skipped" in capsys.readouterr().out


@pytest.fixture(scope="module")
def v1_log(tmp_path_factory):
    """A log whose predictions are the JAX RK4 under default_v1 at 0.1 s."""
    rng = np.random.default_rng(7)
    T = 12
    x = np.zeros((T, 13))
    x[:, 3] = 1.0
    x[:, :3] = rng.uniform(-2, 2, (T, 3))
    x[:, 7:10] = rng.uniform(-3, 3, (T, 3))
    q = rng.normal(size=(T, 4)) * 0.1 + [1, 0, 0, 0]
    x[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.uniform(0, 1, (T, 4))
    s = JaxSolver(JaxConfig(), jax_model(jax_default_v1(dtype=jnp.float64)))
    xp = np.asarray(jax.vmap(lambda a, b: s.discrete_dynamics(a, b, 0.1, None))(
        jnp.asarray(x), jnp.asarray(w)))
    return save(tmp_path_factory.mktemp("v1") / "trajectory_v1.pkl",
                {"x_odom": list(x), "w_odom": list(w), "x_pred_odom": list(xp),
                 "x_ref": list(x)})


def test_pred_parity_and_preset_inference_match_jax(v1_log):
    preset, err = parity_matrix.infer_python_params(v1_log, device="cpu")
    jpreset, jerr = jmatrix.infer_python_params(v1_log)
    assert preset == jpreset == "default_v1"
    assert err <= PRED_TOL and jerr <= PRED_TOL
    for name in ("default", "default_v1"):
        np.testing.assert_allclose(parity_matrix.pred_parity(v1_log, 0.1, name, device="cpu"),
                                   jmatrix.pred_parity(v1_log, 0.1, name), rtol=0, atol=PRED_TOL)
    assert parity_matrix.pred_parity(v1_log, 0.1, "default", device="cpu") > 1e-3


@pytest.fixture(scope="module")
def layout(logs):
    """Gazebo and python-sim directories: gp0, gp2 and an untagged copy of
    a gp0 flight under names the JAX matrix globs and names it does not, a
    GP-flown log with no mode, and a diverged log."""
    root = logs["root"] / "layout"
    gz, py = root / "gazebo", root / "python"
    gz.mkdir(parents=True)
    py.mkdir()
    d0, d2 = logs["dicts"]["gp0"], logs["dicts"]["gp2"]
    save(py / "traj0_v6_a6_gp0.pkl", d0)
    save(py / "traj0_v6_a6_gp2.pkl", d2)
    save(py / "random_trajectory_nogp.pkl", d0)          # not globbed by the JAX matrix
    save(py / "trajectory_using_gp.pkl", {k: v for k, v in d0.items()})
    save(py / "notes.pkl", {"comment": "no closed-loop keys"})
    # a Gazebo run that left the arena at tick 40 of 200
    T = 200
    x = np.tile(np.array(d0["x_odom"])[:1], (T, 1))
    x[40:, 0] = 1e3
    diverged = {"x_odom": list(x), "w_odom": list(np.full((T, 4), 0.3)),
                "x_ref": list(x), "x_pred_odom": list(x)}
    save(gz / "traj1_v6_a6_gp0.pkl", diverged)
    save(gz / "static_trajectory.pkl", diverged)
    return gz, py


def test_run_matrix_rows_and_departures(layout, tmp_path, monkeypatch):
    monkeypatch.delenv("MPCQUAD_REFERENCE", raising=False)
    gz, py = layout
    out = parity_matrix.run_matrix(str(tmp_path / "out"), gazebo=str(gz), pysim=str(py),
                                   gp_models=None, pysim_gp_models=None, device="cpu")
    rows = {r["log"]: r for r in out["rows"]}
    # every pickle with the closed-loop keys, and nothing else
    assert set(rows) == {"traj0_v6_a6_gp0.pkl", "traj0_v6_a6_gp2.pkl",
                         "random_trajectory_nogp.pkl", "trajectory_using_gp.pkl",
                         "traj1_v6_a6_gp0.pkl", "static_trajectory.pkl"}
    for name in ("traj0_v6_a6_gp0.pkl", "random_trajectory_nogp.pkl"):
        assert rows[name]["mode"] == "gp0" and rows[name]["ticks"] == TICKS - DROP
        assert np.isfinite(rows[name]["du_mean"]) and "flag" not in rows[name]
    assert rows["traj0_v6_a6_gp2.pkl"]["mode"] == "gp2"
    assert rows["traj0_v6_a6_gp2.pkl"]["ticks"] == TICKS - DROP
    # no mode tag, no posterior: flagged, not replayed as gp0
    unknown = rows["trajectory_using_gp.pkl"]
    assert unknown["mode"] == "unknown" and unknown["flag"] == "mode unknown"
    assert "du_mean" not in unknown and "pred_parity_max" in unknown
    # the sane prefix (40 ticks) is shorter than the floor plus a horizon
    # (20 + 5 x 20 and 20 + 10 x 10): flagged, not replayed into its
    # diverged part (the JAX matrix would replay 20 ticks)
    short = rows["traj1_v6_a6_gp0.pkl"]
    assert short["flag"] == "prefix too short" and short["ref_run_diverged"]
    assert "du_mean" not in short
    assert rows["static_trajectory.pkl"]["flag"] == "mode unknown"

    saved = json.loads((tmp_path / "out" / "PARITY.json").read_text())
    assert len(saved["rows"]) == 6
    table = (tmp_path / "out" / "PARITY.md").read_text()
    assert "prefix too short" in table and "mode unknown" in table


def test_run_matrix_skips_cleanly_without_directories(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("MPCQUAD_REFERENCE", raising=False)
    out = parity_matrix.run_matrix(str(tmp_path / "out"), gazebo=str(tmp_path / "absent"),
                                   pysim=None, device="cpu")
    assert out["rows"] == [] and "skipped" in capsys.readouterr().out
    assert json.loads((tmp_path / "out" / "PARITY.json").read_text())["rows"] == []
    assert parity_matrix.main(["--gazebo", str(tmp_path / "a"), "--pysim", str(tmp_path / "b"),
                               "--out", str(tmp_path / "o2"), "--cpu"]) == 0


def test_comparison_artifact_without_the_reference(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("MPCQUAD_REFERENCE", raising=False)
    out = comparison_artifact.main(str(tmp_path), ref_config=str(tmp_path / "none.json"),
                                   ref_cov_csv=str(tmp_path / "none.csv"), gp_dir=None,
                                   device="cpu", v_peaks=(4.0,), t_max=1.5)
    said = capsys.readouterr().out
    assert "skipped" in said and "no reference column" in said
    assert out["rmse_matrix"] == [] and out["covariance_reference"] == []
    (row,) = out["covariance_ours"]
    assert row["v_peak"] == 4.0 and all(np.isfinite(row["gp0"] + row["gp2"]))
    for f in ("COMPARISON.json", "COVARIANCE.md", "NOTE.md"):
        assert (tmp_path / f).exists()
    csv = tmp_path / "cov.csv"
    csv.write_text("traj,v_peak,gp,cx,cy,cz\n0,4,0,0.5,0.1,0.0\n0,4,2,0.2,0.05,0.0\n")
    ref = comparison_artifact.read_reference_covariances(str(csv))
    md = "\n".join(comparison_artifact.covariance_markdown(out["covariance_ours"], ref))
    assert "0.5000" in md and "2.5x" in md


def test_logged_flight_writes_a_replayable_log(tmp_path):
    """``bench/per_scenario.py::logged_flight``, the card's parity log,
    writes the python-sim keys with the posterior, and the log replays."""
    path = str(tmp_path / "flight.pkl")
    flight = per_scenario.logged_flight(path, "cpu", torch.float64, t_max=1.5)
    assert flight == {"ticks": 15, "finite": True}
    with open(path, "rb") as f:
        d = pickle.load(f)
    assert {"x_odom", "w_odom", "x_ref", "rgp_mu_g_t", "rgp_basis_vectors", "rgp_theta"} <= set(d)
    r = parity.replay_reference_log(path, device="cpu", n_nodes=N, skip=1, drop_tail=3,
                                    rgp_from_log=True)
    assert r["u_ours"].shape == (12, 4) and np.isfinite(r["u_ours"]).all()
