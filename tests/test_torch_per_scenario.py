"""The port's per-scenario controller path on the CPU, float64, against the
JAX package: ``SQPSolver.solve`` (the JAX ``solve`` under ``vmap``, whose QP
is the unscaled XLA interior point or projected Newton), its options and the
model pieces it brings (the presets, ``f_disturbed``, ``plant_step``,
``rk4_step(normalize_quat=True)``).

The port condenses with kernel J's and D's plain versions and linearises
with kernel A's, the JAX package with jacfwd and its XLA condensing: the
same algorithm in another order of operations, so the solves agree to
rounding through 12 IPM iterations.  Tolerances, B=4 at the benchmark's
operating point with RGP drag: U 1e-9, X 1e-8 (|X| ~ 15), the cost 1e-10
relative, the KKT 1e-9 (measured: pdip 9e-12 / 1e-11 / 1e-17 relative /
1e-13; projected Newton 7e-11 / 3e-9 / 7e-11 relative / 0).  Each JAX
configuration is compiled once for the module."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models import dynamics as jax_dynamics
from mpc_quad_ros_tpu.models import params as jax_params_mod
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.ops.sqp import SolverCarry as JaxCarry
from mpc_quad_ros_tpu.ops.sqp import init_carry as jax_init_carry
from mpc_quad_ros_tpu.utils.rotations import unit_quat as jax_unit_quat
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import dynamics, make_mpc_dynamics, params
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry
from mpc_quad_ros_tpu_torch.utils.rotations import unit_quat

from test_torch_common import (as_numpy, jax_params, jax_rgp, port_params, solve_inputs, t,
                               trajectory_inputs)

B = 4
PRESETS = ("default_params", "default_v1_params", "hummingbird_params", "crazyflie_params")
# name -> (MPCConfig keywords, preset, carry): "init" is init_carry's,
# "moving" a perturbed trajectory with random duals, so that the shift and
# the warm duals act
CONFIGS = {
    "pdip_cold": (dict(), "hummingbird_params", "init"),
    "pdip_warm_duals_shifted": (dict(warm_start_duals=True, shift_warm_start=True),
                                "hummingbird_params", "moving"),
    "projected_newton": (dict(qp_method="projected_newton"), "hummingbird_params", "init"),
    "riccati_n10": (dict(qp_method="riccati"), "hummingbird_params", "init"),
    "sqp2_unscaled_crazyflie": (dict(sqp_iters=2, scale_stage_by_dt=False),
                                "crazyflie_params", "init"),
}


def _inputs(carry_kind: str, u_ref: float, warm: bool) -> dict:
    inp = solve_inputs(B, seed=31)
    if carry_kind == "moving":
        X, U, _ = trajectory_inputs(B, seed=32)
        rng = np.random.default_rng(33)
        inp["carry"] = {"X": X, "U": U}
        if warm:
            inp["carry"].update(zl=rng.uniform(0.01, 2.0, (B, 40)), zu=rng.uniform(0.01, 2.0, (B, 40)))
    else:
        x0 = inp["x0"]
        inp["carry"] = {"X": np.repeat(x0[:, None], 11, 1), "U": np.full((B, 10, 4), u_ref)}
        if warm:
            inp["carry"].update(zl=np.ones((B, 40)), zu=np.ones((B, 40)))
    return inp


@functools.lru_cache(maxsize=None)
def _run(name: str):
    """(port solution, JAX solution, port carry, JAX carry, inputs) of a
    configuration."""
    kw, preset, carry_kind = CONFIGS[name]
    jp = getattr(jax_params_mod, preset)(dtype=jnp.float64)
    u_ref = float(jp.hover_input)
    inp = _inputs(carry_kind, u_ref, kw.get("warm_start_duals", False))
    jcfg = JaxConfig(u_ref=u_ref, **kw)
    js = JaxSolver(jcfg, jax_model(jp))
    jcarry = JaxCarry(**{k: jnp.asarray(v) for k, v in inp["carry"].items()})
    y = jnp.asarray(inp["y_ref"])
    jc, ref = jax.jit(jax.vmap(js.solve))(jcarry, jnp.asarray(inp["x0"]), y, y[:, -1],
                                           jax_rgp(inp["rgp"]))
    cfg = MPCConfig(u_ref=u_ref, **kw)
    solver = SQPSolver(cfg, make_mpc_dynamics(getattr(params, preset)(torch.float64)))
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    carry, sol = solver.solve(interop.solver_carry_from_numpy(inp["carry"]), x0, y_ref,
                              y_ref[:, -1], interop.rgp_state_from_numpy(inp["rgp"]))
    return sol, ref, carry, jc, inp


def _check(sol, ref):
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(ref.cost), rtol=1e-10)
    np.testing.assert_allclose(sol.kkt_residual.numpy(), np.asarray(ref.kkt_residual),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_matches_jax(name):
    sol, ref, carry, jc, _ = _run(name)
    _check(sol, ref)
    U = sol.U.numpy()
    assert U.min() >= 0.0 and U.max() <= 1.0
    for k in ("zl", "zu"):
        a, b = getattr(carry, k), getattr(jc, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)


def test_solve_unbatched_input_matches_jax():
    """One scenario as x0 (13,): the same ranks back, the JAX row's numbers."""
    _, ref, _, _, inp = _run("pdip_cold")
    cfg = MPCConfig(u_ref=float(jax_params().hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    k = 2
    x0, y_ref = t(inp["x0"][k]), t(inp["y_ref"][k])
    rgp = interop.rgp_state_from_numpy({n: v[k] for n, v in inp["rgp"].items()})
    carry, sol = solver.solve(init_carry(cfg, x0), x0, y_ref, y_ref[-1], rgp)
    assert carry.X.shape == (11, 13) and sol.U.shape == (10, 4) and sol.cost.shape == ()
    _check(sol, type(ref)(*(np.asarray(a)[k] for a in ref)))


def test_solve_isolates_a_nan_scenario():
    inp = solve_inputs(B, seed=34)
    cfg = MPCConfig(u_ref=float(jax_params().hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    rgp = interop.rgp_state_from_numpy(inp["rgp"])
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    _, sol = solver.solve(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1], rgp)
    x_bad = x0.clone()
    x_bad[1, 8] = float("nan")
    _, bad = solver.solve(init_carry(cfg, x_bad), x_bad, y_ref, y_ref[:, -1], rgp)
    keep = torch.arange(B) != 1
    assert torch.isnan(bad.U[1]).all()
    for k in ("X", "U", "cost", "kkt_residual"):
        assert torch.equal(getattr(bad, k)[keep], getattr(sol, k)[keep])


@pytest.mark.parametrize("N, jax_expect", [(15, "pdip"), (31, "pdip"), (32, "riccati")])
def test_auto_per_scenario_switch(N, jax_expect):
    """"auto" on the per-scenario path: the JAX package switches at 32
    (AUTO_RICCATI_MIN_N_XLA), the port at AUTO_RICCATI_MIN_N = 16 on both
    paths, since its f32 unscaled IPM loses scenarios from N=16 on the card."""
    solver = SQPSolver(MPCConfig(n_nodes=N, qp_method="auto"), None)
    jax_solver = JaxSolver(JaxConfig(n_nodes=N, qp_method="auto"), None)
    assert jax_solver._resolve_qp_method(tiled=False) == jax_expect
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        expect = "pdip" if N < sqp.AUTO_RICCATI_MIN_N else "riccati"
        assert solver._resolve_qp_method(tiled=False) == expect
        assert solver._resolve_qp_method() == expect


def test_projected_newton_past_the_ceiling_takes_riccati():
    solver = SQPSolver(MPCConfig(n_nodes=sqp.FUSED_N_MAX + 1, qp_method="projected_newton"), None)
    with pytest.warns(UserWarning, match="condensed kernels' ceiling"):
        assert solver._resolve_qp_method(tiled=False) == "riccati"


@pytest.mark.parametrize("kw, error", [(dict(shift_warm_start=True), ValueError),
                                       (dict(qp_method="projected_newton"), NotImplementedError)])
def test_solve_batch_refuses_what_it_does_not_run(kw, error):
    inp = solve_inputs(2, seed=35)
    cfg = MPCConfig(u_ref=float(jax_params().hover_input), **kw)
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    with pytest.raises(error, match="solve"):
        solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1])
    solver.solve(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1])


@pytest.mark.parametrize("scale", [True, False])
def test_config_scaling_and_init_carry_u0_match_jax(scale):
    jcfg, cfg = JaxConfig(scale_stage_by_dt=scale), MPCConfig(scale_stage_by_dt=scale)
    assert cfg.weight_tuples() == jcfg.weight_tuples()
    assert cfg.stage_scale == jcfg.stage_scale
    x0 = solve_inputs(3, seed=36)["x0"]
    u0 = np.array([0.1, 0.2, 0.3, 0.4])
    jc = jax.vmap(lambda x: jax_init_carry(jcfg, x, jnp.asarray(u0)))(jnp.asarray(x0))
    c = init_carry(cfg, t(x0), t(u0))
    np.testing.assert_array_equal(c.X.numpy(), np.asarray(jc.X))
    np.testing.assert_array_equal(c.U.numpy(), np.asarray(jc.U))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("payload", [False, True])
def test_presets_match_jax(preset, payload):
    ours = interop.to_numpy(getattr(params, preset)(torch.float64, payload=payload))
    theirs = as_numpy(getattr(jax_params_mod, preset)(payload=payload, dtype=jnp.float64))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _states(n: int, seed: int):
    X, U, _ = trajectory_inputs(1, seed=seed, N=n - 1)
    return X[0], np.concatenate([U[0], U[0, -1:]])


def test_disturbed_plant_and_normalised_rk4_match_jax():
    x, u = _states(6, seed=37)
    rng = np.random.default_rng(38)
    f_d, t_d = rng.normal(0, 0.5, (6, 3)), rng.normal(0, 0.01, (6, 3))
    jp, pp = jax_params(), port_params()
    ours = dynamics.f_disturbed(t(x), t(u), pp, t(f_d), t(t_d)).numpy()
    theirs = jax_dynamics.f_disturbed(*map(jnp.asarray, (x, u)), jp, *map(jnp.asarray, (f_d, t_d)))
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-12)
    ours = dynamics.plant_step(t(x), t(1.5 * u - 0.2), pp, 0.005).numpy()
    theirs = jax_dynamics.plant_step(jnp.asarray(x), jnp.asarray(1.5 * u - 0.2), jp, 0.005)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-12)
    f_port = lambda xx, uu: dynamics.f_with_drag(xx, uu, pp)
    f_jax = lambda xx, uu: jax_dynamics.f_with_drag(xx, uu, jp)
    for norm in (False, True):
        ours = dynamics.rk4_step(f_port, t(x), t(u), 0.1, normalize_quat=norm).numpy()
        theirs = jax_dynamics.rk4_step(f_jax, jnp.asarray(x), jnp.asarray(u), 0.1,
                                       normalize_quat=norm)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(ours[:, 3:7], axis=-1), 1.0, rtol=0, atol=1e-14)
    np.testing.assert_allclose(unit_quat(t(x[:, 3:7])).numpy(),
                               np.asarray(jax_unit_quat(jnp.asarray(x[:, 3:7]))), rtol=0, atol=1e-15)
