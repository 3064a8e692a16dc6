"""The port's closed loops on the CPU, float64: ``run_episode`` (one episode,
or a batch as ``run_episode_batch``) against the JAX package's, and the
fused loop's heterogeneous options (``traj_len``, ``episode_ticks``,
``control_skip``) against its own homogeneous runs.

``run_episode`` runs the per-scenario ``SQPSolver.solve`` in both packages
(the unscaled IPM, 12 iterations): the same algorithm in another order of
operations, so 20 ticks on the accelerating circle at 8 m/s with RGP on
agree to rounding that the loop carries from tick to tick: x_odom 1e-7 and
w_odom 1e-8.  The fused loop's ``solve_batch`` runs another IPM (the
Jacobi-scaled kernel's), held to the JAX loop by
``tests/test_torch_closed_loop.py``.

Resumed from a carry after 10 ticks on the short circle, with `rgp0` passed
beside `carry0` the two packages agree to the same tolerances; with
`carry0` alone the port keeps learning from the carry's RGP (where the JAX
package flies the nominal model: a recorded deviation)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.loop import EpisodeConfig as JaxEpisodeConfig
from mpc_quad_ros_tpu.loop import run_episode as jax_run_episode
from mpc_quad_ros_tpu.loop import run_episode_batch as jax_run_episode_batch
from mpc_quad_ros_tpu.loop.batch import tracking_rmse_masked as jax_rmse_masked
from mpc_quad_ros_tpu.loop.episode import EpisodeOutput as JaxOutput
from mpc_quad_ros_tpu.loop.episode import tracking_rmse as jax_rmse
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.utils import reference as jax_reference
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.loop import (EpisodeConfig, make_episode_fn, run_episode,
                                         run_episode_batch, run_episode_batch_fused,
                                         tracking_rmse, tracking_rmse_masked)
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
from mpc_quad_ros_tpu_torch.traj import circle_trajectory_accelerating, states_from_flat_outputs
from mpc_quad_ros_tpu_torch.utils import reference

from test_torch_common import as_numpy, jax_params, jax_rgp, port_params, rgp_batch, t

B, TICKS = 2, 20
FAULT = dict(fault_tick=5, fault_rotors=(1.0, 1.0, 1.0, 0.5))


def circle(v: float, dt: float = 0.1, t_max: float = 10.0) -> np.ndarray:
    _, pos, vel, _ = circle_trajectory_accelerating(10.0, v, t_max=t_max, dt=dt)
    return states_from_flat_outputs(pos, vel)


def inputs(n: int = B, seed: int = 5) -> dict:
    """Per-episode randomised drag, hover at 3 m, the RGP prior (mu_g = 0)."""
    rng = np.random.default_rng(seed)
    pb = {k: np.broadcast_to(v, (n,) + v.shape).copy() for k, v in as_numpy(jax_params()).items()}
    pb["aero_drag"] = pb["aero_drag"] * rng.uniform(0.5, 2.0, n)
    pb["rotor_drag"] = pb["rotor_drag"] * rng.uniform(0.5, 2.0, (n, 1))
    x0 = np.zeros((n, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    return dict(params=pb, x0=x0, rgp=rgp_batch(n, rng, mu_scale=0.0))


def select(inp: dict, idx) -> dict:
    """Episodes `idx` of `inputs()`: an int drops the batch axis, a slice
    keeps it."""
    return dict(params={k: v[idx] for k, v in inp["params"].items()}, x0=inp["x0"][idx],
                rgp={k: v[idx] for k, v in inp["rgp"].items()})


def port_solver(**kw) -> SQPSolver:
    return SQPSolver(MPCConfig(u_ref=float(jax_params().hover_input), **kw),
                     make_mpc_dynamics(port_params()))


def port_episode(inp: dict, traj: np.ndarray, ticks: int = TICKS, **cfg_kw):
    cfg = EpisodeConfig(mpc=port_solver().cfg, **cfg_kw)
    return run_episode(cfg, port_solver(), interop.quad_params_from_numpy(inp["params"]),
                       t(inp["x0"]), t(traj), ticks, interop.rgp_state_from_numpy(inp["rgp"]))


def jax_config(**cfg_kw):
    jcfg = JaxEpisodeConfig(mpc=JaxConfig(u_ref=float(jax_params().hover_input)), **cfg_kw)
    return jcfg, JaxSolver(jcfg.mpc, jax_model(jax_params()))


def jax_inputs(inp: dict, traj: np.ndarray):
    return (jax_params()._replace(**{k: jnp.asarray(v) for k, v in inp["params"].items()}),
            jnp.asarray(inp["x0"]), jnp.asarray(traj), jax_rgp(inp["rgp"]))


@functools.lru_cache(maxsize=None)
def jax_batch():
    """The JAX run_episode_batch of `inputs()` on the 8 m/s circle."""
    jcfg, js = jax_config()
    traj = np.broadcast_to(circle(8.0), (B, 100, 13)).copy()
    fn = jax.jit(lambda p, x, tr, r: jax_run_episode_batch(jcfg, js, p, x, tr, TICKS, r))
    return fn(*jax_inputs(inputs(), traj))[1]


@functools.lru_cache(maxsize=None)
def port_single():
    """The port's run_episode of episode 0 alone: (final carry, outputs)."""
    return port_episode(select(inputs(), 0), circle(8.0))


def check_episode(out, ref, ticks: int = TICKS):
    """The first `ticks` ticks to the tolerances; every tick finite with the
    controls in the box."""
    axis = out.x_odom.dim() - 2
    for k, tol in (("x_odom", 1e-7), ("w_odom", 1e-8), ("x_pred_odom", 1e-7), ("x_ref", 0),
                   ("rgp_mu_g_t", 1e-6)):
        np.testing.assert_allclose(getattr(out, k).narrow(axis, 0, ticks).numpy(),
                                   np.take(np.asarray(getattr(ref, k)), range(ticks), axis),
                                   rtol=0, atol=tol, err_msg=k)
    u = out.w_odom.numpy()
    assert np.isfinite(out.x_odom.numpy()).all() and u.min() >= 0.0 and u.max() <= 1.0


def test_run_episode_matches_jax():
    ref = jax_batch()
    _, out = port_single()
    check_episode(out, JaxOutput(*(None if a is None else np.asarray(a)[0] for a in ref)))


def test_run_episode_batch_matches_jax():
    inp = inputs()
    traj = np.broadcast_to(circle(8.0), (B, 100, 13)).copy()
    cfg = EpisodeConfig(mpc=port_solver().cfg)
    _, out = run_episode_batch(cfg, port_solver(), interop.quad_params_from_numpy(inp["params"]),
                               t(inp["x0"]), t(traj), TICKS,
                               interop.rgp_state_from_numpy(inp["rgp"]))
    check_episode(out, jax_batch())
    np.testing.assert_allclose(tracking_rmse(out).numpy(),
                               np.asarray(jax_rmse(jax_batch())), rtol=1e-8)


def test_run_episode_fault_and_control_skip_match_jax():
    """fault_tick=5 with rotor 4 at half thrust, and control_skip=10 on the
    circle sampled 10x finer, in one run.

    With the fault the loop turns chaotic once an IPM stops converging (KKT
    1.0 at tick 9): the JAX package against itself with x0 moved by 1e-12 m
    differs by 4e-10 at tick 10, 1.4e-8 at tick 11 and 2.4e-3 at tick 19
    (measured here, and held: more than 1e3 times over the last nine
    ticks).  So the run is held to the tolerances over ticks 0-10, the first
    six with the fault, and to finite states and controls in the box over
    all 20."""
    cfg_kw = dict(FAULT, control_skip=10)
    traj = circle(8.0, dt=0.01)
    inp = select(inputs(), 1)
    jcfg, js = jax_config(**cfg_kw)
    fn = jax.jit(lambda p, x, tr, r: jax_run_episode(jcfg, js, p, x, tr, TICKS, r))
    _, ref = fn(*jax_inputs(inp, traj))
    _, out = port_episode(inp, traj, **cfg_kw)
    check_episode(out, ref, ticks=11)
    # the chaos: the JAX package against itself with x0 moved by 1e-12 m
    _, moved = fn(*jax_inputs(dict(inp, x0=inp["x0"] + np.eye(13)[0] * 1e-12), traj))
    spread = np.abs(np.asarray(ref.x_odom) - np.asarray(moved.x_odom)).max(-1)
    assert spread[-1] > 1e3 * spread[:11].max()


def test_resuming_through_the_carry_is_bitwise():
    inp = select(inputs(), 0)
    cfg = EpisodeConfig(mpc=port_solver().cfg)
    solver = port_solver()
    p = interop.quad_params_from_numpy(inp["params"])
    traj = t(circle(8.0))
    rgp = interop.rgp_state_from_numpy(inp["rgp"])
    first, a = run_episode(cfg, solver, p, t(inp["x0"]), traj, 10, rgp)
    last, b = run_episode(cfg, solver, p, t(inp["x0"]), traj, 10, carry0=first, start_tick=10)
    final, whole = port_single()
    for k, v in whole.fields().items():
        if v is not None:
            assert torch.equal(torch.cat([getattr(a, k), getattr(b, k)]), v), k
    assert torch.equal(last.x, final.x) and torch.equal(last.solver.U, final.solver.U)


@functools.lru_cache(maxsize=None)
def resumed_runs():
    """Episode 0 of `inputs()` on the short (3 s) circle: 10 ticks, then 10
    more resumed from the carry, in the port with `rgp0` passed beside
    `carry0` and without it, and in the JAX package with it: (the carry at
    the resume, port with rgp0, port without, JAX with rgp0)."""
    inp = select(inputs(), 0)
    traj = circle(8.0, t_max=3.0)
    cfg, solver = EpisodeConfig(mpc=port_solver().cfg), port_solver()
    p = interop.quad_params_from_numpy(inp["params"])
    x0, tr = t(inp["x0"]), t(traj)
    first, _ = run_episode(cfg, solver, p, x0, tr, 10, interop.rgp_state_from_numpy(inp["rgp"]))
    _, with_rgp0 = run_episode(cfg, solver, p, x0, tr, 10, rgp0=first.rgp, carry0=first,
                               start_tick=10)
    _, without = run_episode(cfg, solver, p, x0, tr, 10, carry0=first, start_tick=10)

    jcfg, js = jax_config()
    jp, jx0, jtr, jrgp = jax_inputs(inp, traj)
    jfirst, _ = jax.jit(lambda p, x, tr, r: jax_run_episode(jcfg, js, p, x, tr, 10, r))(
        jp, jx0, jtr, jrgp)
    _, jsecond = jax.jit(lambda p, tr, c: jax_run_episode(
        jcfg, js, p, c.x, tr, 10, rgp0=c.rgp, carry0=c, start_tick=10))(jp, jtr, jfirst)
    return first, with_rgp0, without, jsecond


def test_resume_with_rgp0_matches_jax():
    """Resumed with rgp0 beside carry0, the two packages agree."""
    _, with_rgp0, _, jsecond = resumed_runs()
    check_episode(with_rgp0, jsecond, ticks=10)


def test_resume_without_rgp0_keeps_learning():
    """Resumed from a carry alone, the port reads the carry's RGP and keeps
    learning (the JAX package would fly the nominal model and freeze the
    RGP): bitwise the run with rgp0 passed."""
    first, with_rgp0, without, _ = resumed_runs()
    assert without.rgp_mu_g_t is not None
    mu = torch.cat([first.rgp.mu_g[None], without.rgp_mu_g_t])
    assert ((mu[1:] - mu[:-1]).abs().amax((1, 2)) > 0).all()
    for k, v in with_rgp0.fields().items():
        if v is not None:
            assert torch.equal(getattr(without, k), v), k


def test_make_episode_fn_and_gp_aug():
    inp = select(inputs(), 0)
    fn = make_episode_fn(EpisodeConfig(mpc=port_solver().cfg), port_solver(), 3)
    p = interop.quad_params_from_numpy(inp["params"])
    _, out = fn(p, t(inp["x0"]), t(circle(8.0)), interop.rgp_state_from_numpy(inp["rgp"]))
    _, whole = port_single()
    assert torch.equal(out.x_odom, whole.x_odom[:3])
    # gp_aug is the static GP (gp1, tests/test_torch_gp1_loop.py); a record
    # that is no drag model is refused
    with pytest.raises(TypeError, match="augmentation"):
        fn(p, t(inp["x0"]), t(circle(8.0)), gp_aug=object())


# -- the fused loop's heterogeneous batches ------------------------------- #

HETERO_TICKS = 12
V_MAX = (4.0, 8.0, 12.0)


def hetero_inputs():
    """Three episodes at v_max 4, 8, 12 m/s whose circles last 1.6, 1.0 and
    0.7 s at 0.1 s samples (17, 11, 8 samples), padded to 17 with the last
    sample, running 12, 9 and 5 ticks."""
    lens = (17, 11, 8)
    trajs = [circle(v, t_max=(n - 0.5) * 0.1) for v, n in zip(V_MAX, lens)]
    trajs = np.stack([np.concatenate([c, np.repeat(c[-1:], 17 - len(c), 0)]) for c in trajs])
    return inputs(3, seed=7), trajs, torch.tensor(lens), torch.tensor((12, 9, 5))


def fused(inp, traj, ticks=HETERO_TICKS, **kw):
    solver = port_solver()
    cfg = EpisodeConfig(mpc=solver.cfg, control_skip=kw.pop("control_skip", 1))
    return run_episode_batch_fused(cfg, solver, interop.quad_params_from_numpy(inp["params"]),
                                   t(inp["x0"]), t(traj), ticks,
                                   interop.rgp_state_from_numpy(inp["rgp"]), **kw)


@functools.lru_cache(maxsize=None)
def hetero_run():
    inp, traj, lens, ticks = hetero_inputs()
    return fused(inp, traj, traj_len=lens, episode_ticks=ticks)


def test_fused_masked_run_of_identical_shapes_is_bitwise_unmasked():
    inp, traj, _, _ = hetero_inputs()
    _, plain = fused(inp, traj, ticks=6)
    _, masked = fused(inp, traj, ticks=6, traj_len=torch.full((3,), 17),
                      episode_ticks=torch.full((3,), 6))
    assert plain.active is None and bool(masked.active.all())
    for k, v in plain.fields().items():
        if v is not None:
            assert torch.equal(getattr(masked, k), v), k


def test_fused_frozen_carries_stay_bitwise():
    _, _, _, ticks = hetero_inputs()
    final, out = hetero_run()
    for b, n in enumerate(ticks.tolist()):
        assert out.active[b, :n].all() and not out.active[b, n:].any()
        frozen = final.x[b]
        assert all(torch.equal(out.x_odom[b, k], frozen) for k in range(n, HETERO_TICKS))
        assert all(torch.equal(out.rgp_mu_g_t[b, k], final.rgp.mu_g[b])
                   for k in range(n - 1, HETERO_TICKS))


@pytest.mark.parametrize("b", [0, 1, 2])
def test_fused_active_prefix_matches_its_own_run(b):
    inp, traj, lens, ticks = hetero_inputs()
    _, out = hetero_run()
    n, T = ticks[b].item(), lens[b].item()
    _, own = fused(select(inp, slice(b, b + 1)), traj[b:b + 1, :T], ticks=n)
    for k in ("x_odom", "w_odom", "x_pred_odom", "rgp_mu_g_t"):
        np.testing.assert_allclose(getattr(out, k)[b, :n].numpy(), getattr(own, k)[0].numpy(),
                                   rtol=0, atol=1e-9, err_msg=k)


def test_fused_control_skip_is_bitwise_the_coarse_trajectory():
    inp, _, _, _ = hetero_inputs()
    fine = np.broadcast_to(circle(8.0, dt=0.01, t_max=1.0 + 1e-9), (3, 101, 13)).copy()
    _, a = fused(inp, fine, ticks=6, control_skip=10)
    _, b = fused(inp, fine[:, ::10], ticks=6)
    for k, v in b.fields().items():
        if v is not None:
            assert torch.equal(getattr(a, k), v), k


@pytest.mark.parametrize("masked", [False, True])
def test_tracking_rmse_masked_matches_jax(masked):
    _, out = hetero_run()
    if not masked:
        out = out.replace(active=None)
    ref = jax_rmse_masked(JaxOutput(
        x_odom=jnp.asarray(out.x_odom.numpy()), x_pred_odom=None, x_ref=jnp.asarray(out.x_ref.numpy()),
        w_odom=None, cost_solution=None, kkt_residual=None, rgp_mu_g_t=None, v_body=None,
        a_drag=None, active=None if out.active is None else jnp.asarray(out.active.numpy())))
    np.testing.assert_allclose(tracking_rmse_masked(out).numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("skip", [1, 3])
def test_reference_chunk_matches_jax(skip):
    traj = np.random.default_rng(8).standard_normal((25, 13))
    for i in (0, 7, 20, 24):
        np.testing.assert_array_equal(
            reference.get_reference_chunk(t(traj), i, 10, skip).numpy(),
            np.asarray(jax_reference.get_reference_chunk(jnp.asarray(traj), i, 10, skip)))
