"""The simulation entry point (``run.py``), the comparison matrix
(``compare.py``) and the exploration runner (``explore.py``) on the CPU.

- ``run_sim`` for one drone (``run_episode``) in float64 against the JAX
  package's ``run_sim`` on the 3 s circle (both packages' trajectory
  shortened, as tests/test_io.py does): gp2 through ``run_sim``, gp0
  through ``main --cpu -o`` and its log, at test_torch_episode.py's
  tolerances (x 1e-7, u 1e-8, the RGP mean 1e-6);
- ``main --cpu -p`` writing the tracking report, and ``main`` without
  ``--cpu`` refusing to run where there is no card;
- the batched route at B=32 bitwise the port's own
  ``run_episode_batch_fused`` on the same parameters (the fleet's drag is
  drawn from a ``torch.Generator``, not JAX's stream, so the batched route
  is compared through its parts);
- ``run_matrix`` on a 2-run JSON (gp0 and gp2) against the JAX package's
  ``run_matrix`` in float64: the rows to the episode tolerance on x, the
  log names equal;
- ``run_matrix_batched`` on a 2-run JSON with ``max_ticks`` (one
  heterogeneous batch of two trajectory lengths) against ``run_matrix``'s
  rows on the same cut trajectories;
- ``explore`` for one round against the JAX package's ``explore`` in
  float64: the history, the model files it writes, the fitted thetas
  (``gp_fit``'s 1e-6 relative rule) and the curriculum's next velocity;
  and the port's round alone, the model it trains and its next velocity."""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_quad_ros_tpu.compare as jcompare
import mpc_quad_ros_tpu.explore as jexplore
import mpc_quad_ros_tpu.run as jrun
import mpc_quad_ros_tpu_torch.run as trun
from mpc_quad_ros_tpu.explorer import Explorer as JaxExplorer
from mpc_quad_ros_tpu.io.config import SimConfig as JaxSimConfig
from mpc_quad_ros_tpu.models.ensemble import GPEnsemble as JaxGPEnsemble
from mpc_quad_ros_tpu_torch import compare, explore
from mpc_quad_ros_tpu_torch.explorer import Explorer
from mpc_quad_ros_tpu_torch.io import SimConfig, load_dict
from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode_batch_fused
from mpc_quad_ros_tpu_torch.models import (GPEnsemble, hummingbird_params, make_mpc_dynamics,
                                           randomize_params)
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver

from test_torch_cuda_common import circle

SHORT_S = 3.0
# test_torch_episode.py's tolerances (f64, the same per-scenario solve)
TOLS = {"x_odom": 1e-7, "w_odom": 1e-8, "x_pred_odom": 1e-7, "x_ref": 0.0, "rgp_mu_g_t": 1e-6}


def short_circle(t_max: float):
    """A ``build_trajectory`` on the circle cut to t_max seconds."""
    def build(cfg, x0_pos, mpc_dt):
        tr = circle(cfg.v_max, dt=mpc_dt, t_max=t_max)
        return tr, np.arange(len(tr)) * mpc_dt
    return build


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setattr(trun, "build_trajectory", short_circle(SHORT_S))
    monkeypatch.setattr(jrun, "build_trajectory", short_circle(SHORT_S))
    monkeypatch.setenv("MPCQUAD_X64", "1")


def jax_run(gpe: int):
    _, outs, _ = jrun.run_sim(JaxSimConfig(gpe=gpe, trajectory=2, v_max=6.0, a_max=6.0),
                              verbose=False)
    return outs


def check(ours: dict, ref, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(getattr(ref, k)), rtol=0,
                                   atol=TOLS[k], err_msg=k)


def test_run_sim_gp2_matches_jax(short):
    logger, outs, extras = trun.run_sim(SimConfig(gpe=2, trajectory=2, v_max=6.0, a_max=6.0),
                                        verbose=False, device="cpu")
    assert outs.x_odom.dtype == torch.float64 and outs.x_odom.shape == (30, 13)
    ref = jax_run(2)
    check({k: v.numpy() for k, v in outs.fields().items() if v is not None}, ref, TOLS)
    # the log carries the reference's keys and the full posterior (batch 1)
    for key in ("x_odom", "x_pred_odom", "x_ref", "w_odom", "cost_solution", "t_odom", "t_cpu",
                "rgp_mu_g_t", "v_body", "a_drag", "rgp_basis_vectors", "rgp_C_g_t", "rgp_theta"):
        assert key in logger.dictionary, key
    assert abs(extras["rmse"] - float(jnp.sqrt(jnp.mean(jnp.sum(
        (ref.x_odom[:, :3] - ref.x_ref[:, :3]) ** 2, -1))))) < 1e-7


def test_main_cpu_gp0_writes_the_jax_runs_log(short, tmp_path, capsys):
    path = str(tmp_path / "gp0.pkl")
    assert trun.main(["--gpe", "0", "--trajectory", "2", "--v_max", "6", "--a_max", "6",
                      "--cpu", "-o", path]) == 0
    assert "Saving trajectory to" in capsys.readouterr().out
    d = load_dict(path)
    assert "rgp_mu_g_t" not in d and len(d["t_odom"]) == 30
    check({k: np.stack(d[k]) for k in ("x_odom", "w_odom", "x_pred_odom", "x_ref")}, jax_run(0),
          ("x_odom", "w_odom", "x_pred_odom", "x_ref"))


def test_main_plots_the_report_and_needs_the_card(short, tmp_path, monkeypatch):
    monkeypatch.setattr(trun, "build_trajectory", short_circle(1.0))
    args = ["--gpe", "0", "--trajectory", "2", "--v_max", "6", "--a_max", "6"]
    out = tmp_path / "img" / "plot.png"
    assert trun.main(args + ["--cpu", "-p", str(out)]) == 0
    assert out.exists() and out.stat().st_size > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trun.main(args)


def test_batched_route_is_the_fused_loop(monkeypatch):
    """run_sim at B=32 (gp2, 1 s circle, float32) bitwise the port's fused
    loop on the fleet drawn from torch.Generator(seed)."""
    monkeypatch.setattr(trun, "build_trajectory", short_circle(1.0))
    monkeypatch.delenv("MPCQUAD_X64", raising=False)
    cfg = SimConfig(gpe=2, trajectory=2, v_max=6.0, a_max=6.0, batch=32, seed=3)
    logger, outs, extras = trun.run_sim(cfg, verbose=False, device="cpu")

    p = hummingbird_params()
    mpc = MPCConfig(u_ref=float(p.hover_input))
    solver = SQPSolver(mpc, make_mpc_dynamics(p))
    pb = randomize_params(p, 32, generator=torch.Generator().manual_seed(3))
    x0 = torch.zeros(32, 13)
    x0[:, 3], x0[:, 2] = 1.0, 3.0
    traj = torch.as_tensor(circle(6.0, t_max=1.0), dtype=torch.float32).expand(32, 10, 13)
    rgp = GPEnsemble.fromrange([(-6.0, 6.0)] * 3, 10, theta=(3.0, 0.1, 0.01), device="cpu").state
    _, ref = run_episode_batch_fused(EpisodeConfig(mpc=mpc, log_rgp_posterior=False), solver, pb,
                                     x0, traj, 10, rgp.map(lambda a: a.expand((32,) + a.shape)))
    for k, v in ref.fields().items():
        if v is not None:
            assert torch.equal(getattr(outs, k), v), k
    assert extras["rmse"].shape == (32,)
    np.testing.assert_array_equal(np.stack(logger.dictionary["x_odom"]), ref.x_odom[0].numpy())


def write_matrix(tmp_path, runs) -> str:
    path = tmp_path / "matrix.json"
    path.write_text(json.dumps({"runs": runs}))
    return str(path)


def test_run_matrix_matches_jax(short, tmp_path):
    """gp0 and gp2 at 6 m/s on the 3 s circle, float64: 30 ticks a run, the
    first 20 in the row (the last second dropped)."""
    path = write_matrix(tmp_path, [{"gpe": 0, "trajectory": 2, "v_max": 6, "a_max": 6},
                                   {"gpe": 2, "trajectory": 2, "v_max": 6, "a_max": 6}])
    ours = compare.run_matrix(path, str(tmp_path / "t"), verbose=False, device="cpu")
    ref = jcompare.run_matrix(path, str(tmp_path / "j"), verbose=False)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert {k: a[k] for k in ("gpe", "trajectory", "v_max", "a_max")} == {
            k: b[k] for k in ("gpe", "trajectory", "v_max", "a_max")}
        for k in ("mean_rmse_pos", "v_peak"):
            assert abs(a[k] - b[k]) <= TOLS["x_odom"], (k, a, b)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "sim_0_trajectory2_v_max6_a_max6.pkl", "sim_2_trajectory2_v_max6_a_max6.pkl"]
    for name in names:
        d, jd = load_dict(str(tmp_path / "t" / name)), load_dict(str(tmp_path / "j" / name))
        assert sorted(d) == sorted(jd), name
        for k in ("x_odom", "w_odom"):
            np.testing.assert_allclose(np.stack(d[k]), np.stack(jd[k]), rtol=0, atol=TOLS[k],
                                       err_msg=f"{name} {k}")


def test_explore_round_matches_jax(tmp_path, monkeypatch):
    """One round (gp0 at 4 m/s on the 5 s circle, float64, then the GP fit
    on its log) from each package.  Both packages fit the same model from
    one log (test_torch_gp_workflow.py); here each fits its own flight.  On
    a flight of 2 s the data loader's pick of ten samples from 20 ticks
    turns on the 1e-7 between the flights (one sample flips, and the thetas
    with it); from 5 s on the pick is the same."""
    monkeypatch.setattr(trun, "build_trajectory", short_circle(5.0))
    monkeypatch.setattr(jrun, "build_trajectory", short_circle(5.0))
    monkeypatch.setenv("MPCQUAD_X64", "1")
    kw = dict(rounds=1, v_start=4.0, trajectory=2, verbose=False)
    ours = explore.explore(out_dir=str(tmp_path / "t"), device="cpu", **kw)
    ref = jexplore.explore(out_dir=str(tmp_path / "j"), **kw)
    assert [(h["round"], h["v_max"]) for h in ours] == [(h["round"], h["v_max"]) for h in ref]
    assert abs(ours[0]["rmse"] - float(ref[0]["rmse"])) <= TOLS["x_odom"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    gpe = GPEnsemble.fromdir(str(tmp_path / "t" / "gp_models"), "GP", device="cpu")
    jgpe = JaxGPEnsemble.fromdir(str(tmp_path / "j" / "gp_models"), "GP")
    theta, jtheta = gpe.state.theta.numpy(), np.asarray(jgpe.state.theta)
    assert np.abs(theta - jtheta).max() <= 1e-6 * np.abs(jtheta).max()
    np.testing.assert_allclose(gpe.state.X.numpy(), np.asarray(jgpe.state.X), rtol=0,
                               atol=TOLS["x_odom"])
    assert abs(Explorer(gpe).velocity_to_explore
               - JaxExplorer(jgpe).velocity_to_explore) <= TOLS["x_odom"]


def test_run_matrix_batched_rows_match_run_matrix(tmp_path, monkeypatch):
    """Two gp2 runs (4 and 8 m/s on circles of 5 and 2.5 s) cut to 30 ticks
    by max_ticks: one batch of 30 and 25 ticks, against run_matrix on the
    same cut circles one run at a time, float32.  The batch solves through
    the small-batch step (the Jacobi-scaled IPM of kernel E) and run_matrix
    through the per-scenario solve (the unscaled IPM), both 12 iterations:
    the rows agree to 1 % (measured 0.09 % at most)."""
    spec = {"runs": [{"gpe": 2, "trajectory": 2, "v_max": 4, "a_max": 4},
                     {"gpe": 2, "trajectory": 2, "v_max": 8, "a_max": 8}]}
    path = tmp_path / "matrix.json"
    path.write_text(json.dumps(spec))
    monkeypatch.delenv("MPCQUAD_X64", raising=False)

    def by_speed(cut):
        def build(cfg, x0_pos, mpc_dt):
            tr = circle(cfg.v_max, dt=mpc_dt, t_max=20.0 / cfg.v_max)[:cut]
            return tr, np.arange(len(tr)) * mpc_dt
        return build

    monkeypatch.setattr(trun, "build_trajectory", by_speed(None))
    batched = compare.run_matrix_batched(str(path), str(tmp_path / "b"), verbose=False,
                                         max_ticks=30, device="cpu")
    monkeypatch.setattr(trun, "build_trajectory", by_speed(30))
    one_by_one = compare.run_matrix(str(path), str(tmp_path / "s"), verbose=False, device="cpu")
    assert len(batched) == len(one_by_one) == 2
    for a, b in zip(batched, one_by_one):
        assert {k: a[k] for k in ("gpe", "trajectory", "v_max", "a_max")} == {
            k: b[k] for k in ("gpe", "trajectory", "v_max", "a_max")}
        for k in ("mean_rmse_pos", "v_peak"):
            assert abs(a[k] - b[k]) <= 0.01 * abs(b[k]), (k, a, b)
    names = sorted(os.listdir(tmp_path / "b"))
    assert names == sorted(os.listdir(tmp_path / "s")) == [
        "sim_2_trajectory2_v_max4_a_max4.pkl", "sim_2_trajectory2_v_max8_a_max8.pkl"]
    with open(tmp_path / "b" / names[1], "rb") as f:
        assert len(pickle.load(f)["x_odom"]) == 25


def test_explore_round_trains_a_model(tmp_path, monkeypatch):
    monkeypatch.setattr(trun, "build_trajectory", short_circle(2.0))
    monkeypatch.setenv("MPCQUAD_X64", "1")
    history = explore.explore(rounds=1, out_dir=str(tmp_path), v_start=4.0, trajectory=2,
                              verbose=False, device="cpu")
    assert [h["round"] for h in history] == [0] and history[0]["v_max"] == 4.0
    assert sorted(os.listdir(tmp_path / "gp_models")) == ["mdl_x.gp", "mdl_y.gp", "mdl_z.gp"]
    gpe = GPEnsemble.fromdir(str(tmp_path / "gp_models"), "GP", device="cpu")
    X = gpe.state.X.numpy()
    explored = min(max(X[d].max(), -X[d].min()) for d in range(3))
    assert Explorer(gpe).velocity_to_explore == min(explored + 10.0, 20.0)
