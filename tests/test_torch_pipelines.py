"""The port's three batched pipelines and the warm-started IPM duals
(``MPCConfig.pipeline``, ``MPCConfig.warm_start_duals``) on the CPU.

- Every pipeline x warm_start_duals, one solve at the benchmark's operating
  point with RGP drag (f64, plain versions of the kernels, which share their
  code): U bitwise equal across "hybrid", "split" and "fused"; X within
  1e-12 ("split" forms X + (d + M z), the others the dX recurrence).
- The duals: shape (B, N*4) in the carry, carried through two chained solves
  (they move, they change the second solve, they stay finite and positive);
  None without the flag; the Riccati step passes them through untouched.
- The dispatch: "pdip" past FUSED_N_MAX warns and takes the Riccati step
  under every pipeline; an unknown pipeline raises (the JAX package falls
  back to "split").
- ``interop.solver_carry_from_numpy`` takes the JAX package's carry, duals
  included.
- The regulation chain of ``tests/test_warm_start.py`` (f32, B=8, 30 ticks):
  warm at 6 IPM iterations within twice the max KKT of cold at 12.
- Against the JAX package's ``solve_batch`` with the same options at B=128,
  N=5 in interpret mode ("split" + warm from the JAX carry's real duals,
  "fused" + cold): U to 1e-9.  About a minute of interpret-mode compiles
  each, so these two are in the slow tier; the kernels they run are held
  against the Pallas kernels in tier 1 (test_torch_condense_kernel,
  test_torch_qp_kernel, test_torch_fused_step).
- On a CUDA device (skipped here): "split" launches kernels A, D and E only,
  "fused" kernel F only, warm and cold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.ops.sqp import init_carry as jax_init_carry
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.bench.regulation import regulation_chain
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.cuda import (condense_kernel, lin_kernel, qp_kernel,
                                             riccati_kernel, sqp_fused_kernel)
from mpc_quad_ros_tpu_torch.ops.sqp import FUSED_N_MAX, MPCConfig, SQPSolver, init_carry

from test_torch_common import jax_params, jax_rgp, port_params, require_cuda, solve_inputs, t

B = 8
COUNTERS = (lin_kernel.linearize, sqp_fused_kernel.fused_sqp_from_J,
            riccati_kernel.riccati_ipm_from_J, condense_kernel.condense_cost_from_J,
            qp_kernel.solve_box_qp_pdip_batch, sqp_fused_kernel.fused_sqp_step)


def _solver(params, **cfg_kw):
    cfg = MPCConfig(u_ref=float(params.hover_input.flatten()[0]), **cfg_kw)
    return SQPSolver(cfg, make_mpc_dynamics(params))


def _solve(inp, carry=None, params=None, **cfg_kw):
    """One port solve of `inp` (carry from init_carry unless given)."""
    params = port_params() if params is None else params
    kw = dict(dtype=params.mass.dtype, device=params.mass.device)
    solver = _solver(params, **cfg_kw)
    x0, y_ref = t(inp["x0"]).to(**kw), t(inp["y_ref"]).to(**kw)
    rgp = interop.rgp_state_from_numpy(inp["rgp"], **kw)
    carry = init_carry(solver.cfg, x0) if carry is None else carry
    return solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)


@pytest.fixture(scope="module")
def solves():
    """{(pipeline, warm): (carry, sol)} of one solve, and a second chained
    solve of each warm pipeline."""
    inp = solve_inputs(B, seed=81)
    first = {(pipe, warm): _solve(inp, pipeline=pipe, warm_start_duals=warm)
             for pipe in ("hybrid", "split", "fused") for warm in (False, True)}
    second = {pipe: _solve(inp, first[(pipe, True)][0], pipeline=pipe, warm_start_duals=True)
              for pipe in ("hybrid", "split", "fused")}
    return inp, first, second


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("pipeline", ["split", "fused"])
def test_pipelines_agree_with_hybrid(solves, pipeline, warm):
    _, first, _ = solves
    (c_h, s_h), (c, s) = first[("hybrid", warm)], first[(pipeline, warm)]
    assert torch.equal(s.U, s_h.U)
    np.testing.assert_allclose(s.X.numpy(), s_h.X.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(s.kkt_residual.numpy(), s_h.kkt_residual.numpy(), rtol=0, atol=1e-12)
    if warm:
        assert torch.equal(c.zl, c_h.zl) and torch.equal(c.zu, c_h.zu)
    else:
        assert c.zl is None and c.zu is None


@pytest.mark.parametrize("pipeline", ["hybrid", "split", "fused"])
def test_duals_round_trip_two_solves(solves, pipeline):
    inp, first, second = solves
    c1, _ = first[(pipeline, True)]
    c2, s2 = second[pipeline]
    assert c1.zl.shape == c1.zu.shape == (B, 40) and c2.zl.shape == (B, 40)
    assert (c2.zl - c1.zl).abs().max() > 1e-6               # the duals moved
    for zd in (c1.zl, c1.zu, c2.zl, c2.zu):
        assert torch.isfinite(zd).all() and (zd > 0).all()
    # the second solve started from them: a cold second solve differs
    _, s_cold = _solve(inp, c1.replace(zl=None, zu=None), pipeline=pipeline)
    assert not torch.equal(s2.U, s_cold.U)
    assert torch.isfinite(s2.U).all()


def test_flag_off_carries_no_duals():
    cfg = MPCConfig()
    assert init_carry(cfg, torch.zeros(3, 13)).zl is None
    carry = init_carry(dataclasses.replace(cfg, warm_start_duals=True), torch.zeros(3, 13))
    assert torch.equal(carry.zl, torch.ones(3, 40)) and torch.equal(carry.zu, torch.ones(3, 40))


def test_riccati_passes_duals_through():
    inp = solve_inputs(2, seed=82)
    carry = init_carry(MPCConfig(warm_start_duals=True), t(inp["x0"]))
    carry = carry.replace(zl=carry.zl * 3.0)
    c2, sol = _solve(inp, carry, qp_method="riccati", warm_start_duals=True)
    assert c2.zl is carry.zl and c2.zu is carry.zu
    assert torch.isfinite(sol.U).all()


@pytest.mark.parametrize("pipeline", ["hybrid", "split", "fused"])
def test_pdip_past_the_ceiling_takes_riccati_under_every_pipeline(pipeline):
    N = FUSED_N_MAX + 1
    solver = _solver(port_params(), n_nodes=N, t_horizon=0.1 * N, pipeline=pipeline)
    with pytest.warns(UserWarning, match="shared-memory ceiling"):
        step = solver._step()
    assert step == solver._gn_step_batch_riccati


def test_unknown_pipeline_raises():
    inp = solve_inputs(2, seed=83)
    with pytest.raises(ValueError, match="unknown pipeline"):
        _solve(inp, pipeline="tiled")


def test_cpu_solves_launch_no_kernel():
    for fn in COUNTERS:
        fn.launches = 0
    inp = solve_inputs(2, seed=88)
    for pipe in ("hybrid", "split", "fused"):
        _solve(inp, pipeline=pipe, warm_start_duals=True)
    assert [fn.launches for fn in COUNTERS] == [0] * len(COUNTERS)


@pytest.mark.parametrize("warm", [False, True])
def test_carry_from_the_jax_package(warm):
    cfg = JaxConfig(warm_start_duals=warm)
    x0 = jnp.asarray(solve_inputs(3, seed=84)["x0"])
    jc = jax.vmap(lambda x: jax_init_carry(cfg, x))(x0)
    carry = interop.solver_carry_from_numpy(_carry_numpy(jc))
    ours = init_carry(MPCConfig(warm_start_duals=warm), t(x0))
    for k in ("X", "U", "zl", "zu"):
        a, b = getattr(carry, k), getattr(ours, k)
        assert (a is None and b is None) or torch.equal(a, b)
    assert (carry.zl is not None) == warm


def test_steady_chain_warm6_matches_cold12():
    cold12, _, _ = regulation_chain(B, "cpu", False, 12, ticks=30)
    warm6, _, _ = regulation_chain(B, "cpu", True, 6, ticks=30)
    assert warm6["kkt_max"] <= 2.0 * cold12["kkt_max"], (warm6, cold12)
    assert warm6["kkt_max"] < 1e-3


def _jax_solve(inp, carry=None, **cfg_kw):
    N = inp["y_ref"].shape[1]
    cfg = JaxConfig(u_ref=float(jax_params().hover_input), n_nodes=N, t_horizon=0.1 * N, **cfg_kw)
    solver = JaxSolver(cfg, jax_model(jax_params()))
    x0, y_ref = jnp.asarray(inp["x0"]), jnp.asarray(inp["y_ref"])
    carry = jax.vmap(lambda x: jax_init_carry(cfg, x))(x0) if carry is None else carry
    return solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], jax_rgp(inp["rgp"]))


def _carry_numpy(jc) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in jc._asdict().items()}


@pytest.mark.slow
def test_split_warm_matches_jax_solve_batch():
    N = 5
    inp = solve_inputs(128, seed=85, N=N)
    kw = dict(pipeline="split", warm_start_duals=True)
    jc1, _ = _jax_solve(inp, **kw)
    jc2, jsol = _jax_solve(inp, jc1, **kw)
    carry = interop.solver_carry_from_numpy(_carry_numpy(jc1))
    c2, sol = _solve(inp, carry, n_nodes=N, t_horizon=0.1 * N, **kw)
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(c2.zl.numpy(), np.asarray(jc2.zl), rtol=0, atol=1e-9)


@pytest.mark.slow
def test_fused_cold_matches_jax_solve_batch():
    N = 5
    inp = solve_inputs(128, seed=86, N=N)
    _, jsol = _jax_solve(inp, pipeline="fused")
    _, sol = _solve(inp, n_nodes=N, t_horizon=0.1 * N, pipeline="fused")
    np.testing.assert_allclose(sol.U.numpy(), np.asarray(jsol.U), rtol=0, atol=1e-9)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("pipeline, launched", [("split", [1, 0, 0, 1, 1, 0]),
                                                ("fused", [0, 0, 0, 0, 0, 1])])
def test_cuda_pipeline_launches_its_kernels(pipeline, launched, warm):
    dev = require_cuda()
    inp = solve_inputs(64, seed=87)
    p32 = port_params().map(lambda a: a.float().to(dev))
    for fn in COUNTERS:
        fn.launches = 0
    kw = dict(pipeline=pipeline, warm_start_duals=warm)
    carry, sol = _solve(inp, params=p32, **kw)
    _, sol = _solve(inp, carry, params=p32, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in COUNTERS] == [2 * n for n in launched]
    # U + z in f32 may pass the box by an ulp: z = clip(z', lb/s, ub/s) s
    # rounds, in every pipeline and in the JAX kernels alike
    assert torch.isfinite(sol.U).all() and -1e-6 <= sol.U.min() and sol.U.max() <= 1 + 1e-6
    # the f32 card's first solve against the f64 plain versions on the CPU
    _, ref = _solve(inp, **kw)
    _, first = _solve(inp, params=p32, **kw)
    assert (first.U.double().cpu() - ref.U).abs().max() < 4e-2
