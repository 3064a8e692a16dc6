"""The port's closed learning loop (``loop/batch.py::run_episode_batch_fused``,
CPU, float64) against the JAX package's ``loop.run_episode_batch`` (vmap of
scan, pure XLA): 2 episodes x 20 ticks on the accelerating circle at 8 m/s,
per-episode randomised drag and RGP state carried over by ``interop``.

The loop feeds every rounding difference back into the next tick, and the JAX
loop's per-scenario IPM is unscaled while the port's (like the JAX Pallas
kernel's) is Jacobi-scaled — a different cold start, so at 12 iterations the
two land on slightly different controls.  Hence:
- with both IPMs converged (40 iterations) the whole episode is compared
  tightly (measured |dx| <= 1e-7, |du| <= 2e-8 over 20 ticks), the first
  5 ticks tighter still;
- at the production 12 iterations, the trajectories agree to the JAX
  package's own bound between its two loops (0.1, tests/test_pallas_qp.py)
  and the tracking RMSE to 2%."""

import jax
import jax.numpy as jnp
import numpy as np

from mpc_quad_ros_tpu.loop import EpisodeConfig as JaxEpisodeConfig
from mpc_quad_ros_tpu.loop import run_episode_batch
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.traj import circle_trajectory_accelerating as jax_circle
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode_batch_fused
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
from mpc_quad_ros_tpu_torch.traj import circle_trajectory_accelerating, states_from_flat_outputs

from test_torch_common import as_numpy, jax_params, jax_rgp, port_params, rgp_batch, t

B, TICKS = 2, 20


def _inputs():
    rng = np.random.default_rng(5)
    jp = jax_params()
    pb = {k: np.broadcast_to(v, (B,) + v.shape).copy() for k, v in as_numpy(jp).items()}
    pb["aero_drag"] = pb["aero_drag"] * rng.uniform(0.5, 2.0, B)
    pb["rotor_drag"] = pb["rotor_drag"] * rng.uniform(0.5, 2.0, (B, 1))
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, 8.0, t_max=10.0, dt=0.1)
    traj = np.broadcast_to(states_from_flat_outputs(pos, vel), (B, 100, 13)).copy()
    x0 = np.zeros((B, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    return pb, traj, x0, rgp_batch(B, rng, mu_scale=0.0)


def _run_both(qp_iters):
    pb, traj, x0, rgp = _inputs()
    jp = jax_params()
    u_ref = float(jp.hover_input)
    jcfg = JaxEpisodeConfig(mpc=JaxConfig(u_ref=u_ref, qp_iters=qp_iters))
    js = JaxSolver(jcfg.mpc, jax_model(jp))
    _, ref = jax.jit(lambda p, x, tr, r: run_episode_batch(jcfg, js, p, x, tr, TICKS, r))(
        jp._replace(**{k: jnp.asarray(v) for k, v in pb.items()}), jnp.asarray(x0),
        jnp.asarray(traj), jax_rgp(rgp))
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=u_ref, qp_iters=qp_iters))
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(port_params()))
    _, out = run_episode_batch_fused(cfg, solver, interop.quad_params_from_numpy(pb), t(x0),
                                     t(traj), TICKS, interop.rgp_state_from_numpy(rgp))
    return out, ref


def _rmse(x_odom, x_ref):
    return np.sqrt(np.mean(np.sum((np.asarray(x_odom)[..., :3] - np.asarray(x_ref)[..., :3]) ** 2, -1), -1))


def test_circle_trajectory_matches_jax():
    _, pos, vel, acc = circle_trajectory_accelerating(10.0, 8.0, t_max=10.0, dt=0.1)
    _, jpos, jvel, jacc = jax_circle(10.0, 8.0, t_max=10.0, dt=0.1)
    for a, b in ((pos, jpos), (vel, jvel), (acc, jacc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


def test_closed_loop_matches_jax_converged_ipm():
    out, ref = _run_both(qp_iters=40)
    x, xr = out.x_odom.numpy(), np.asarray(ref.x_odom)
    np.testing.assert_allclose(x[:, :5], xr[:, :5], rtol=0, atol=1e-8)
    np.testing.assert_allclose(x, xr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.w_odom.numpy(), np.asarray(ref.w_odom), rtol=0, atol=1e-7)
    np.testing.assert_allclose(out.x_pred_odom.numpy(), np.asarray(ref.x_pred_odom), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.rgp_mu_g_t.numpy(), np.asarray(ref.rgp_mu_g_t), rtol=0, atol=1e-6)
    # C_g ~ 1e-2: measured 3e-10, bound 1e-8 leaves room for another CPU's rounding
    np.testing.assert_allclose(out.rgp_C_g_t.numpy(), np.asarray(ref.rgp_C_g_t), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.x_ref.numpy(), np.asarray(ref.x_ref), rtol=0, atol=0)
    np.testing.assert_allclose(_rmse(x, out.x_ref), _rmse(xr, ref.x_ref), rtol=1e-8)


def test_closed_loop_matches_jax_production_ipm():
    out, ref = _run_both(qp_iters=12)
    x, xr = out.x_odom.numpy(), np.asarray(ref.x_odom)
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, xr, rtol=0, atol=1e-1)
    np.testing.assert_allclose(out.w_odom.numpy(), np.asarray(ref.w_odom), rtol=0, atol=1e-1)
    np.testing.assert_allclose(_rmse(x, out.x_ref), _rmse(xr, ref.x_ref), rtol=2e-2)
    u = out.w_odom.numpy()
    assert u.min() >= 0.0 and u.max() <= 1.0


def test_benchmark_scenario_runs_on_cpu():
    """``bench/closed_loop.py`` end to end at a tiny size (its times here are
    CPU times and are not checked)."""
    from mpc_quad_ros_tpu_torch.bench.closed_loop import closed_loop

    out = closed_loop(B=2, v=8.0, t_max=3.2, device="cpu")
    assert out["device"] == "cpu" and (out["episodes"], out["ticks"]) == (2, 32)
    assert np.isfinite([out["err_mean_m"], out["err_p95_m"], out["tick_solves_per_s"]]).all()
