"""gp1, the pretrained exact GP, through the port's closed loops against the
JAX package's, CPU, float64, with the same ``GPState`` in both: three
per-axis GPs on ten synthetic samples of the hummingbird's own drag, at
hyperparameters of the size a fit ends at (the noise at its 0.01 bound).

- ``run_episode`` (one drone, 10 ticks, N=10) and ``run_episode_batch``
  (two drones sharing the GP) against the JAX ``run_episode``: the
  tolerances of ``tests/test_torch_episode.py`` (x_odom 1e-7, w_odom 1e-8);
- ``run_episode_batch_fused`` (B=4, each episode its own drag and its own
  copy of the GP): with both IPMs converged (40 iterations) against the JAX
  ``run_episode_batch``, as and to the tolerances that
  ``tests/test_torch_closed_loop.py`` holds the gp2 loop to (the port's
  batched IPM is Jacobi-scaled, the JAX per-scenario one is not, so at 12
  iterations they stop at different points: x_odom 1e-8 over the first 5
  ticks and 1e-6 over all, w_odom 1e-7); at the production 12 iterations
  against the JAX ``run_episode_batch_fused``, the same algorithm, to the
  episode tolerances, in the slow tier (its interpret-mode kernels take a
  minute to compile);
- gp0 and gp2 are what they were: an RGP given beside a GP wins, bitwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.loop import EpisodeConfig as JaxEpisodeConfig
from mpc_quad_ros_tpu.loop import run_episode as jax_run_episode
from mpc_quad_ros_tpu.loop import run_episode_batch as jax_run_episode_batch
from mpc_quad_ros_tpu.loop import run_episode_batch_fused as jax_run_episode_batch_fused
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.models.gp import GPState as JaxGPState
from mpc_quad_ros_tpu.models.gp import ensemble_gp_init as jax_ensemble_gp_init
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.loop import (EpisodeConfig, run_episode, run_episode_batch,
                                         run_episode_batch_fused)
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
from mpc_quad_ros_tpu_torch.traj import circle_trajectory_accelerating, states_from_flat_outputs

from test_torch_common import as_numpy, jax_params, jax_rgp, port_params, rgp_batch, t

TICKS = 10
B = 4
GP_THETA = (5.0, 4.0, 0.01)


def gp_state() -> dict:
    """The GP of each axis on ten samples over +-8 m/s of the plant's body
    drag a = -(aero v|v| + rotor v) / m, as numpy arrays (3, ...)."""
    p = as_numpy(jax_params())
    X = np.random.default_rng(11).uniform(-8.0, 8.0, (3, 10))
    y = -(p["aero_drag"] * X * np.abs(X) + p["rotor_drag"][:, None] * X) / p["mass"]
    st = jax_ensemble_gp_init(jnp.asarray(X), jnp.asarray(y), jnp.asarray([GP_THETA] * 3))
    return as_numpy(st)


def circle() -> np.ndarray:
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, 8.0, t_max=10.0, dt=0.1)
    return states_from_flat_outputs(pos, vel)


def batch_inputs(n: int = B, seed: int = 5):
    """Per-episode randomised drag, hover at 3 m."""
    rng = np.random.default_rng(seed)
    pb = {k: np.broadcast_to(v, (n,) + v.shape).copy() for k, v in as_numpy(jax_params()).items()}
    pb["aero_drag"] = pb["aero_drag"] * rng.uniform(0.5, 2.0, n)
    pb["rotor_drag"] = pb["rotor_drag"] * rng.uniform(0.5, 2.0, (n, 1))
    x0 = np.zeros((n, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    return pb, x0, np.broadcast_to(circle(), (n, 100, 13)).copy()


def port_solver(**kw) -> SQPSolver:
    return SQPSolver(MPCConfig(u_ref=float(jax_params().hover_input), **kw),
                     make_mpc_dynamics(port_params()))


def jax_setup(**kw):
    jcfg = JaxEpisodeConfig(mpc=JaxConfig(u_ref=float(jax_params().hover_input), **kw))
    return jcfg, JaxSolver(jcfg.mpc, jax_model(jax_params()))


def jax_gp(arrays: dict) -> JaxGPState:
    return JaxGPState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def check_episode(out, ref, tol_x: float = 1e-7, tol_u: float = 1e-8):
    """test_torch_episode's tolerances; every tick finite, controls in the
    box up to the unscaling's rounding of the batched IPM (U + z leaves it by
    an ulp, ROADMAP queue 3), and no RGP log."""
    for k, tol in (("x_odom", tol_x), ("w_odom", tol_u), ("x_pred_odom", tol_x), ("x_ref", 0)):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=0, atol=tol, err_msg=k)
    u = out.w_odom.numpy()
    assert np.isfinite(out.x_odom.numpy()).all() and u.min() >= -1e-12 and u.max() <= 1.0 + 1e-12
    assert out.rgp_mu_g_t is None


@functools.lru_cache(maxsize=None)
def jax_single():
    """The JAX run_episode of one hummingbird (the preset's drag) in gp1."""
    jcfg, js = jax_setup()
    fn = jax.jit(lambda x, tr, g: jax_run_episode(jcfg, js, jax_params(), x, tr, TICKS, None, g))
    _, _, traj = batch_inputs(1)
    return fn(jnp.asarray(batch_inputs(1)[1][0]), jnp.asarray(traj[0]), jax_gp(gp_state()))[1]


def test_gp1_run_episode_matches_jax():
    pb, x0, traj = batch_inputs(1)
    solver = port_solver()
    _, out = run_episode(EpisodeConfig(mpc=solver.cfg), solver, port_params(), t(x0[0]), t(traj[0]),
                         TICKS, gp_aug=interop.gp_state_from_numpy(gp_state()))
    check_episode(out, jax_single())


def test_gp1_run_episode_batch_shares_the_gp():
    """Two drones with the preset's drag and one (3, n) GP between them:
    each is the JAX package's one-drone run."""
    _, x0, traj = batch_inputs(2)
    solver = port_solver()
    p = port_params().map(lambda a: a.expand((2,) + a.shape))
    _, out = run_episode_batch(EpisodeConfig(mpc=solver.cfg), solver, p, t(x0), t(traj), TICKS,
                               gp_aug=interop.gp_state_from_numpy(gp_state()))
    for b in range(2):
        check_episode(out.map(lambda a: a[b]), jax_single())


def fused_port(qp_iters: int, gp=None, **kw):
    pb, x0, traj = batch_inputs()
    solver = port_solver(qp_iters=qp_iters)
    gp = interop.gp_state_from_numpy(gp_state()) if gp is None else gp
    gp_b = gp.map(lambda a: a.expand((B,) + a.shape).clone())
    return run_episode_batch_fused(EpisodeConfig(mpc=solver.cfg), solver,
                                   interop.quad_params_from_numpy(pb), t(x0), t(traj), TICKS,
                                   gp_aug=gp_b, **kw)


def test_gp1_fused_loop_matches_jax_converged_ipm():
    pb, x0, traj = batch_inputs()
    jcfg, js = jax_setup(qp_iters=40)
    _, ref = jax.jit(lambda p, x, tr, g: jax_run_episode_batch(jcfg, js, p, x, tr, TICKS, None, g))(
        jax_params()._replace(**{k: jnp.asarray(v) for k, v in pb.items()}), jnp.asarray(x0),
        jnp.asarray(traj), jax_gp(gp_state()))
    _, out = fused_port(40)
    np.testing.assert_allclose(out.x_odom[:, :5].numpy(), np.asarray(ref.x_odom)[:, :5], rtol=0,
                               atol=1e-8)
    check_episode(out, ref, tol_x=1e-6, tol_u=1e-7)


@pytest.mark.slow
def test_gp1_fused_loop_matches_jax_fused():
    """The production 12 iterations against the JAX fused loop (its Pallas
    kernels in interpret mode: ~1 min of compiles)."""
    pb, x0, traj = batch_inputs()
    jcfg, js = jax_setup()
    gp_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jax_gp(gp_state()))
    _, ref = jax.jit(lambda p, x, tr, g: jax_run_episode_batch_fused(jcfg, js, p, x, tr, TICKS,
                                                                     None, g))(
        jax_params()._replace(**{k: jnp.asarray(v) for k, v in pb.items()}), jnp.asarray(x0),
        jnp.asarray(traj), gp_b)
    _, out = fused_port(12)
    check_episode(out, ref)


def test_gp1_folded_once_is_the_gp_folded_by_the_caller():
    """The loop folds the GP once before its ticks: the same bits as a run
    given the folded record."""
    gp = interop.gp_state_from_numpy(gp_state())
    _, a = fused_port(12, gp=gp)
    _, b = fused_port(12, gp=fold_drag(gp))
    for k, v in a.fields().items():
        if v is not None:
            assert torch.equal(getattr(b, k), v), k


def test_gp2_beside_a_gp_is_gp2_and_unknown_records_raise():
    pb, x0, traj = batch_inputs(2)
    solver = port_solver()
    cfg = EpisodeConfig(mpc=solver.cfg)
    args = (cfg, solver, interop.quad_params_from_numpy(pb), t(x0), t(traj), 4)
    rgp = interop.rgp_state_from_numpy(rgp_batch(2, np.random.default_rng(3)))
    gp = interop.gp_state_from_numpy(gp_state())
    _, gp2 = run_episode_batch_fused(*args, rgp)
    _, both = run_episode_batch_fused(*args, rgp, gp_aug=gp.map(lambda a: a.expand((2,) + a.shape)))
    for k, v in gp2.fields().items():
        if v is not None:
            assert torch.equal(getattr(both, k), v), k
    with pytest.raises(TypeError, match="augmentation"):
        run_episode_batch_fused(*args, gp_aug=object())
    with pytest.raises(TypeError, match="augmentation"):
        run_episode(*args, gp_aug=jax_rgp(rgp_batch(2, np.random.default_rng(3))))
