"""The port's box-QP solvers (``ops/qp.py``) on the CPU, float64, against the
JAX package's XLA ones on random positive definite box QPs shaped like the
condensed MPC QP (nz = 8 and 40, the box [-0.16, 0.84] of du at hover, a
gradient that leaves many bounds active).

The same algorithm with LAPACK factorisations on both sides: z (and the
duals) to 1e-9 (measured ~1e-15)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops import qp as jax_qp
from mpc_quad_ros_tpu_torch.ops import qp

from test_torch_common import t
from test_torch_cuda_common import box_qp

B = 6


@functools.lru_cache(maxsize=None)
def _jax_pdip(warm: bool, return_duals: bool):
    if warm:
        fn = lambda H, g, lb, ub, zl, zu: jax_qp.solve_box_qp_pdip(
            H, g, lb, ub, iters=12, zl0=zl, zu0=zu, return_duals=return_duals)
    else:
        fn = lambda H, g, lb, ub, zl, zu: jax_qp.solve_box_qp_pdip(
            H, g, lb, ub, iters=12, return_duals=return_duals)
    return jax.jit(jax.vmap(fn))


_jax_pn = jax.jit(jax.vmap(lambda H, g, lb, ub: jax_qp.solve_box_qp_projected_newton(
    H, g, lb, ub, iters=8)))
_jax_kkt = jax.jit(jax.vmap(jax_qp.qp_kkt_residual))


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("nz", [8, 40])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("return_duals", [False, True])
def test_pdip_matches_jax(nz, warm, return_duals):
    p = box_qp(nz, seed=nz + 2 * warm)
    ref = _jax_pdip(warm, return_duals)(*(jnp.asarray(p[k]) for k in
                                          ("H", "g", "lb", "ub", "zl0", "zu0")))
    duals = (t(p["zl0"]), t(p["zu0"])) if warm else (None, None)
    out = qp.solve_box_qp_pdip(t(p["H"]), t(p["g"]), t(p["lb"]), t(p["ub"]), 12, *duals,
                               return_duals=return_duals)
    for a, b in zip(_as_list(out), _as_list(ref), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    z = _as_list(out)[0].numpy()
    assert (z >= p["lb"]).all() and (z <= p["ub"]).all()


@pytest.mark.parametrize("nz", [8, 40])
def test_projected_newton_matches_jax(nz):
    p = box_qp(nz, seed=50 + nz)
    args = [p[k] for k in ("H", "g", "lb", "ub")]
    z = qp.solve_box_qp_projected_newton(*map(t, args), 8)
    ref = _jax_pn(*map(jnp.asarray, args))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), rtol=0, atol=1e-9)
    kkt = qp.qp_kkt_residual(*map(t, args), z)
    np.testing.assert_allclose(kkt.numpy(), np.asarray(_jax_kkt(*map(jnp.asarray, args), ref)),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("solver", ["pdip", "projected_newton"])
@pytest.mark.parametrize("fault", ["nan", "indefinite"])
def test_a_failed_scenario_leaves_the_others_unchanged(solver, fault):
    """A NaN, or a matrix that is not positive definite, in scenario 2: its
    z is NaN, the other scenarios' bitwise what they were (Cholesky failures
    are NaN for that scenario alone, as in the JAX package)."""
    p = box_qp(40, seed=60)
    run = {"pdip": lambda H: qp.solve_box_qp_pdip(H, *map(t, (p["g"], p["lb"], p["ub"])), 12),
           "projected_newton": lambda H: qp.solve_box_qp_projected_newton(
               H, *map(t, (p["g"], p["lb"], p["ub"])), 8)}[solver]
    H = t(p["H"])
    z = run(H)
    H_bad = H.clone()
    if fault == "nan":
        H_bad[2, 5, 6] = float("nan")
    else:
        H_bad[2] = -H_bad[2] - 100.0 * torch.eye(40, dtype=H.dtype)
    z_bad = run(H_bad)
    keep = torch.arange(B) != 2
    assert torch.isnan(z_bad[2]).any()
    assert torch.equal(z_bad[keep], z[keep])
