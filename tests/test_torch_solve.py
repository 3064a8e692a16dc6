"""The port's ``SQPSolver.solve_batch`` on the CPU (float64, plain versions
of both kernels) against the JAX package, B=8 scenarios at the benchmark's
operating point with per-scenario RGP drag.

Two oracles:
- At the production 12 IPM iterations, the JAX package's own per-scenario
  pieces (``_assemble``: jacfwd linearisation + condensing) with its XLA
  ``solve_box_qp_pdip`` on the Jacobi-scaled QP — the algorithm of the
  Pallas hybrid pipeline.  Same algorithm, so 1e-9 (rounding through 12 IPM
  iterations).
- The vmapped ``SQPSolver.solve`` itself, whose XLA IPM is unscaled: its cold
  start differs from the scaled one, so the two agree only once both have
  converged — compared at 40 IPM iterations (measured |dU| ~5e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_quad_ros_tpu.models.augmented import fold_drag as jax_fold_drag
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.ops.qp import qp_kkt_residual as jax_kkt
from mpc_quad_ros_tpu.ops.qp import solve_box_qp_pdip
from mpc_quad_ros_tpu.ops.sqp import init_carry as jax_init_carry
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry

from test_torch_common import jax_params, jax_rgp, port_params, solve_inputs, t

B = 8


def _port_solve(inp, **cfg_kw):
    cfg = MPCConfig(u_ref=float(jax_params().hover_input), **cfg_kw)
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    carry, sol = solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1],
                                    interop.rgp_state_from_numpy(inp["rgp"]))
    return solver, sol


def _jax_setup(inp, **cfg_kw):
    cfg = JaxConfig(u_ref=float(jax_params().hover_input), **cfg_kw)
    solver = JaxSolver(cfg, jax_model(jax_params()))
    x0, y_ref = jnp.asarray(inp["x0"]), jnp.asarray(inp["y_ref"])
    carry = jax.vmap(lambda x: jax_init_carry(cfg, x))(x0)
    return solver, carry, x0, y_ref


def test_solve_batch_matches_jax_hybrid_algorithm():
    inp = solve_inputs(B, seed=21)
    _, sol = _port_solve(inp)
    solver, carry, x0, y_ref = _jax_setup(inp)
    aug = jax_fold_drag(jax_rgp(inp["rgp"]))

    def step(X, U, x0, yr, a):
        H, g, lb, ub, M, d = solver._assemble(X, U, x0, yr, yr[-1], a)
        s = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-12))
        z = solve_box_qp_pdip(H * s[:, None] * s[None, :], g * s, lb / s, ub / s, iters=12) * s
        Xn, Un = X + d + M @ z, U + z.reshape(U.shape)
        return Xn, Un, solver.ls_cost(Xn, Un, yr, yr[-1]), jax_kkt(H, g, lb, ub, z)

    X, U, cost, kkt = jax.jit(jax.vmap(step))(carry.X, carry.U, x0, y_ref, aug)
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(X), rtol=0, atol=1e-8)    # |X| ~ 15
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(cost), rtol=1e-10)
    np.testing.assert_allclose(sol.kkt_residual.numpy(), np.asarray(kkt), rtol=0, atol=1e-9)
    U_np = sol.U.numpy()
    assert U_np.min() >= 0.0 and U_np.max() <= 1.0


@pytest.mark.parametrize("sqp_iters", [1, 2])
def test_solve_batch_matches_vmapped_solve_converged(sqp_iters):
    inp = solve_inputs(B, seed=22)
    _, sol = _port_solve(inp, qp_iters=40, sqp_iters=sqp_iters)
    solver, carry, x0, y_ref = _jax_setup(inp, qp_iters=40, sqp_iters=sqp_iters)
    _, ref = jax.jit(jax.vmap(solver.solve))(carry, x0, y_ref, y_ref[:, -1], jax_rgp(inp["rgp"]))
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-7)
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-6)
    # the second Gauss-Newton step linearises at points already 1e-7 apart
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(ref.cost), rtol=1e-8)
    assert sol.kkt_residual.max() <= 1e-4 and np.asarray(ref.kkt_residual).max() <= 1e-4


def test_any_batch_size():
    """No multiple-of-128 rule: one scenario alone solves as inside a batch."""
    inp = solve_inputs(B, seed=23)
    _, sol = _port_solve(inp)
    one = {"x0": inp["x0"][3:4], "y_ref": inp["y_ref"][3:4],
           "rgp": {k: v[3:4] for k, v in inp["rgp"].items()}}
    _, sol1 = _port_solve(one)
    # batched factorisations block differently by batch size; 12 IPM
    # iterations carry that last-ulp difference to ~1e-11
    np.testing.assert_allclose(sol1.U.numpy()[0], sol.U.numpy()[3], rtol=0, atol=1e-10)


def test_config_weights_and_cost_match_jax():
    jcfg, cfg = JaxConfig(), MPCConfig()
    assert cfg.weight_tuples() == jcfg.weight_tuples()
    # the attitude-weight mean: one ulp between the two frameworks' means
    np.testing.assert_allclose(cfg.q_diagonal().numpy(), np.asarray(jcfg.q_diagonal()), rtol=1e-15)
    assert (cfg.dt, cfg.stage_scale) == (jcfg.dt, jcfg.stage_scale)
    inp = solve_inputs(B, seed=24)
    rng = np.random.default_rng(0)
    X = np.repeat(inp["x0"][:, None], 11, axis=1) + rng.standard_normal((B, 11, 13))
    U = rng.uniform(0, 1, (B, 10, 4))
    port = SQPSolver(cfg, make_mpc_dynamics(port_params())).ls_cost(
        t(X), t(U), t(inp["y_ref"]), t(inp["y_ref"][:, -1]))
    js = JaxSolver(jcfg, jax_model(jax_params()))
    ref = jax.vmap(js.ls_cost)(*map(jnp.asarray, (X, U, inp["y_ref"], inp["y_ref"][:, -1])))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-13)
    jc = jax.vmap(lambda x: jax_init_carry(jcfg, x))(jnp.asarray(inp["x0"]))
    c = init_carry(cfg, t(inp["x0"]))
    np.testing.assert_array_equal(c.X.numpy(), np.asarray(jc.X))
    np.testing.assert_array_equal(c.U.numpy(), np.asarray(jc.U))
