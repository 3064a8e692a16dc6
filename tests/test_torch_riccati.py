"""The port's Riccati backend on the CPU, float64, against the JAX package.

- ``ops/riccati.py``: ``riccati_step`` (free and clamped) and
  ``solve_ocp_box_riccati_ipm`` against the JAX functions (vmapped) on random
  OCPs in the style of ``tests/test_riccati_kernel.py``, where more than half
  the bounds end active, at N=12 and N=40.  The same equations with LAPACK
  solves on both sides: 1e-10 (measured ~1e-14).
- ``SQPSolver.solve_batch(qp_method="riccati")`` against the JAX package's
  ``solve_batch(qp_method="riccati")`` at B=4, N=15 with per-scenario RGP
  drag (JAX's vmapped XLA path): X, U, the cost and the honest KKT.  The port
  runs the Pallas kernel's algorithm (Cholesky of the 4x4 systems) and takes
  the gradient by the adjoint over J, JAX runs LU solves and reverse mode, so
  rounding only: U and the KKT 1e-11, X 1e-10 (|X| ~ 10), cost 1e-11
  relative (measured 1e-15, 4e-14, 3e-15 relative).
- ``_resolve_qp_method``: "auto" on both sides of ``AUTO_RICCATI_MIN_N``,
  "pdip" past ``FUSED_N_MAX`` warns and solves by the Riccati path,
  "projected_newton" raises."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.ops.riccati import riccati_step as jax_riccati_step
from mpc_quad_ros_tpu.ops.riccati import solve_ocp_box_riccati_ipm as jax_riccati_ipm
from mpc_quad_ros_tpu.ops.sqp import init_carry as jax_init_carry
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops import riccati
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry

from test_torch_common import jax_params, jax_rgp, port_params, solve_inputs, t

NX, NU = 13, 4
Q = (10.0, 10.0, 10.0, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05)
RD = (0.1,) * NU
PT = tuple(2.0 * v for v in Q)
LB, UB = -0.16, 0.3


def random_ocp(B: int, N: int, seed: int = 0) -> dict:
    """A, B near the identity / small, the bounds [-0.16, 0.3] on du: most
    bounds end active (as in tests/test_riccati_kernel.py)."""
    rng = np.random.default_rng(seed)
    return dict(A=rng.normal(0, 0.08, (B, N, NX, NX)) + np.eye(NX),
                Bm=rng.normal(0, 0.15, (B, N, NX, NU)),
                c=rng.normal(0, 0.02, (B, N, NX)), dx0=rng.normal(0, 0.05, (B, NX)),
                qlin=rng.normal(0, 0.5, (B, N, NX)), rlin=rng.normal(0, 0.1, (B, N, NU)),
                plin=rng.normal(0, 0.5, (B, NX)),
                lb=np.full((B, N, NU), LB), ub=np.full((B, N, NU), UB))


def jax_ipm(o: dict, iters: int = 12):
    """The JAX package's oracle, vmapped over the scenarios."""
    q, rd, pt = (jnp.asarray(v) for v in (Q, RD, PT))
    one = lambda A, Bm, c, ql, rl, pl, d0, l, u: jax_riccati_ipm(
        A, Bm, c, q, ql, rd, rl, pt, pl, d0, l, u, iters=iters)
    return jax.jit(jax.vmap(one))(*(jnp.asarray(o[k]) for k in
                                    ("A", "Bm", "c", "qlin", "rlin", "plin", "dx0", "lb", "ub")))


@pytest.mark.parametrize("N", [12, 40])
def test_riccati_ipm_matches_jax(N):
    o = random_ocp(6, N, seed=N)
    ours = riccati.solve_ocp_box_riccati_ipm(
        t(o["A"]), t(o["Bm"]), t(o["c"]), t(Q), t(o["qlin"]), t(RD), t(o["rlin"]), t(PT),
        t(o["plin"]), t(o["dx0"]), t(o["lb"]), t(o["ub"]), 12)
    ref = jax_ipm(o)
    for a, b in zip(ours, ref):          # dU, dX, zl, zu
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    du = ours[0].numpy()
    assert np.mean((du <= LB + 1e-3) | (du >= UB - 1e-3)) > 0.5


@pytest.mark.parametrize("N", [12, 40])
@pytest.mark.parametrize("clamped", [False, True])
def test_riccati_step_matches_jax(N, clamped):
    o = random_ocp(4, N, seed=100 + N)
    keys = ["A", "Bm", "c", "qlin", "rlin", "plin", "dx0"] + (["lb", "ub"] if clamped else [])
    q, rd, pt = (jnp.asarray(v) for v in (Q, RD, PT))

    def one(A, Bm, c, ql, rl, pl, d0, *box):
        return jax_riccati_step(A, Bm, c, q, ql, rd, rl, pt, pl, d0, *box)

    ref = jax.vmap(one)(*(jnp.asarray(o[k]) for k in keys))
    box = (t(o["lb"]), t(o["ub"])) if clamped else ()
    ours = riccati.riccati_step(t(o["A"]), t(o["Bm"]), t(o["c"]), t(Q), t(o["qlin"]), t(RD),
                                t(o["rlin"]), t(PT), t(o["plin"]), t(o["dx0"]), *box)
    for a, b in zip(ours, ref):          # dU, dX
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


@pytest.mark.parametrize("sqp_iters", [1, 2])
def test_solve_batch_riccati_matches_jax(sqp_iters):
    B, N = 4, 15
    inp = solve_inputs(B, seed=41, N=N)
    kw = dict(n_nodes=N, t_horizon=0.1 * N, u_ref=float(jax_params().hover_input),
              qp_method="riccati", sqp_iters=sqp_iters)
    cfg = MPCConfig(**kw)
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    _, sol = solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1],
                                interop.rgp_state_from_numpy(inp["rgp"]))

    jcfg = JaxConfig(**kw)
    jsolver = JaxSolver(jcfg, jax_model(jax_params()))
    jx0, jy = jnp.asarray(inp["x0"]), jnp.asarray(inp["y_ref"])
    carry = jax.vmap(lambda x: jax_init_carry(jcfg, x))(jx0)
    _, ref = jsolver.solve_batch(carry, jx0, jy, jy[:, -1], jax_rgp(inp["rgp"]))

    np.testing.assert_allclose(sol.U.numpy(), np.asarray(ref.U), rtol=0, atol=1e-11)
    np.testing.assert_allclose(sol.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(ref.cost), rtol=1e-11)
    np.testing.assert_allclose(sol.kkt_residual.numpy(), np.asarray(ref.kkt_residual),
                               rtol=0, atol=1e-11)
    U = sol.U.numpy()
    assert U.min() >= 0.0 and U.max() <= 1.0
    # X is the nonlinear rollout of U from x0, as in the JAX package
    np.testing.assert_array_equal(sol.X[:, 0].numpy(), inp["x0"])


def _resolve(method: str, N: int) -> str:
    return SQPSolver(MPCConfig(n_nodes=N, qp_method=method), make_mpc_dynamics(port_params())
                     )._resolve_qp_method()


@pytest.mark.parametrize("N, expect", [(sqp.AUTO_RICCATI_MIN_N - 1, "pdip"),
                                       (sqp.AUTO_RICCATI_MIN_N, "riccati"),
                                       (sqp.FUSED_N_MAX + 1, "riccati")])
def test_auto_dispatch(N, expect):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _resolve("auto", N) == expect
    # "auto" never picks the condensed kernel past its ceiling
    assert sqp.AUTO_RICCATI_MIN_N <= sqp.FUSED_N_MAX + 1


def test_pdip_past_the_ceiling_takes_riccati():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _resolve("pdip", sqp.FUSED_N_MAX) == "pdip"
        assert _resolve("riccati", sqp.FUSED_N_MAX) == "riccati"
    N = sqp.FUSED_N_MAX + 1
    with pytest.warns(UserWarning, match="shared-memory ceiling"):
        assert _resolve("pdip", N) == "riccati"

    inp = solve_inputs(2, seed=42, N=N)
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    rgp = interop.rgp_state_from_numpy(inp["rgp"])
    sols = {}
    for m in ("pdip", "riccati"):
        cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(jax_params().hover_input),
                        qp_method=m)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, sols[m] = SQPSolver(cfg, make_mpc_dynamics(port_params())).solve_batch(
                init_carry(cfg, x0), x0, y_ref, y_ref[:, -1], rgp)
    for k in ("X", "U", "cost", "kkt_residual"):
        assert torch.equal(getattr(sols["pdip"], k), getattr(sols["riccati"], k))


@pytest.mark.parametrize("method, error", [("projected_newton", NotImplementedError),
                                           ("dense", ValueError)])
def test_unported_methods_raise(method, error):
    with pytest.raises(error):
        _resolve(method, 10)
