"""Kernel B (condense + IPM + KKT + dX, ``ops/cuda/sqp_fused_kernel.py``) on
the CPU, float64, on the QP subproblems of perturbed trajectories.

- Condensing against the JAX package's ``SQPSolver._cost_from_lin``: H and g
  to 1e-12 relative to their largest entry (the same sums in another order).
- The IPM against the JAX package's ``solve_box_qp_pdip`` applied to the
  Jacobi-scaled problem, which is the algorithm of the Pallas kernel's
  ``ipm_box_solve`` (scaling s = diag(H)^-1/2, unit duals in the scaled
  space): z to 1e-9.  Both factorise the same matrices with different
  Cholesky codes; 12 IPM iterations amplify that rounding by ~1e3-1e4.
- The whole plain step against that oracle plus ``qp_kkt_residual`` and
  X + d + M z, and the kernel's own source built with g++ for the host
  against the plain step (1e-9), cold and warm-started from the cold
  solve's duals, with NaN isolation between scenarios.
- On a CUDA device: ``test_torch_cuda_kernels.py`` (JAX-free, so that it
  collects on the GPU host)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.augmented import fold_drag as jax_fold_drag
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu.ops.qp import qp_kkt_residual as jax_kkt
from mpc_quad_ros_tpu.ops.qp import solve_box_qp_pdip
from mpc_quad_ros_tpu_torch.ops.cuda import sqp_fused_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import condense_from_J
from mpc_quad_ros_tpu_torch.ops.cuda.qp_kernel import ipm_box_solve
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig

from test_torch_common import N, host_library, jax_params, jax_rgp, t, trajectory_inputs

B = 6
ITERS = 12


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


def _jax_pdip_scaled(H, g, lb, ub, iters=ITERS):
    """The Pallas kernel's IPM written with the JAX package's XLA functions."""
    s = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-12))
    return solve_box_qp_pdip(H * s[:, None] * s[None, :], g * s, lb / s, ub / s, iters=iters) * s


@pytest.fixture(scope="module")
def qp():
    """Kernel B's inputs from the JAX linearisation of a perturbed
    trajectory, and the JAX package's condensed QP of the same step."""
    X, U, rgp = trajectory_inputs(B, seed=11)
    rng = np.random.default_rng(12)
    x0 = X[:, 0] + 0.05 * rng.standard_normal((B, 13))
    y_ref = X[:, 1:] + 0.3 * rng.standard_normal((B, N, 13))
    y_ref_N = y_ref[:, -1]
    cfg = JaxConfig(u_ref=float(jax_params().hover_input))
    solver = JaxSolver(cfg, jax_model(jax_params()))
    aug = jax_fold_drag(jax_rgp(rgp))
    args = tuple(map(jnp.asarray, (X, U, x0, y_ref, y_ref_N)))
    A, Bm, r = jax.jit(jax.vmap(solver._linearize))(args[0], args[1], aug)
    H, g, lb, ub, M, d = jax.jit(jax.vmap(solver._cost_from_lin))(*args, A, Bm, r)

    q, p, rw = MPCConfig(u_ref=cfg.u_ref).weight_tuples()
    J = np.concatenate([np.swapaxes(np.asarray(A), -1, -2), np.swapaxes(np.asarray(Bm), -1, -2)], axis=2)
    Uf = U.reshape(B, -1)
    port = dict(J=J, r=np.asarray(r), dx0=x0 - X[:, 0],
                ex0=X - np.concatenate([y_ref, y_ref_N[:, None]], axis=1),
                gu=(Uf - cfg.u_ref) * np.tile(np.asarray(cfg.r_cost) * cfg.stage_scale, N),
                lb=cfg.u_lb - Uf, ub=cfg.u_ub - Uf)
    ref = dict(H=H, g=g, lb=lb, ub=ub, M=M, d=d)
    return {k: t(v).contiguous() for k, v in port.items()}, ref, (q, p, rw)


def _args(port):
    return [port[k] for k in ("J", "r", "dx0", "ex0", "gu", "lb", "ub")]


def test_condense_matches_jax_cost_from_lin(qp):
    port, ref, (q, p, rw) = qp
    H, g = condense_from_J(port["J"], port["r"], port["dx0"], port["ex0"], q, p, rw)
    g = g + port["gu"]
    Hr, gr = np.asarray(ref["H"]), np.asarray(ref["g"])
    assert np.abs(H.numpy() - Hr).max() <= 1e-12 * np.abs(Hr).max()
    assert np.abs(g.numpy() - gr).max() <= 1e-12 * np.abs(gr).max()
    np.testing.assert_array_equal(H.numpy(), H.mT.numpy())     # mirrored, exactly symmetric


def test_ipm_matches_jax_pdip_on_scaled_problem(qp):
    _, ref, _ = qp
    H, g, lb, ub = (ref[k] for k in ("H", "g", "lb", "ub"))
    z, _, _ = ipm_box_solve(*(t(a) for a in (H, g, lb, ub)), ITERS)
    z_ref = jax.vmap(_jax_pdip_scaled)(H, g, lb, ub)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=0, atol=1e-9)


def test_plain_step_matches_jax(qp):
    port, ref, (q, p, rw) = qp
    z, dX, kkt, _, _ = sqp_fused_kernel.fused_sqp_from_J(*_args(port), q, p, rw, ITERS)
    H, g, lb, ub = (ref[k] for k in ("H", "g", "lb", "ub"))
    z_ref = jax.vmap(_jax_pdip_scaled)(H, g, lb, ub)
    dX_ref = ref["d"] + jnp.einsum("bkxz,bz->bkx", ref["M"], z_ref)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dX.numpy(), np.asarray(dX_ref), rtol=0, atol=1e-8)   # |dX| ~ 10
    np.testing.assert_allclose(kkt.numpy(), np.asarray(jax.vmap(jax_kkt)(H, g, lb, ub, z_ref)),
                               rtol=0, atol=1e-9)


def _host_step(lib, args, q, p, rw, duals=None):
    Bn = args[0].shape[0]
    f64 = dict(dtype=torch.float64)
    out = (torch.empty(Bn, 4 * N, **f64), torch.empty(Bn, N + 1, 13, **f64),
           torch.empty(Bn, **f64), torch.empty(Bn, 4 * N, **f64), torch.empty(Bn, 4 * N, **f64))
    w = torch.tensor(list(q) + list(p) + list(rw), **f64)
    dual_ptrs = [d.data_ptr() for d in duals] if duals is not None else [None, None]
    rc = lib.mpcq_sqp_fused_host_f64(*(a.data_ptr() for a in args), *dual_ptrs, w.data_ptr(),
                                     *(o.data_ptr() for o in out), Bn, N, ITERS)
    assert rc == 0
    return out


def _host_matches_plain_and_isolates(lib, port, q, p, rw, duals):
    args = _args(port)
    ref = sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, ITERS, duals)
    out = _host_step(lib, args, q, p, rw, duals)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)

    # a NaN in one scenario leaves every other scenario bitwise unchanged
    bad = 2
    J_bad = port["J"].clone()
    J_bad[bad, 3, 5, 8] = float("nan")
    out_bad = _host_step(lib, [J_bad] + args[1:], q, p, rw, duals)
    keep = torch.arange(B) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


def test_kernel_source_on_host_matches_plain(qp, host_lib):
    port, _, (q, p, rw) = qp
    _host_matches_plain_and_isolates(host_lib, port, q, p, rw, None)


def _cold_duals(port, q, p, rw):
    return sqp_fused_kernel.fused_sqp_from_J_plain(*_args(port), q, p, rw, ITERS)[3:]


def test_kernel_source_on_host_warm_matches_plain(qp, host_lib):
    """The warm path: duals of the cold solve in, the same step."""
    port, _, (q, p, rw) = qp
    duals = _cold_duals(port, q, p, rw)
    z_cold = sqp_fused_kernel.fused_sqp_from_J_plain(*_args(port), q, p, rw, ITERS)[0]
    z_warm = sqp_fused_kernel.fused_sqp_from_J_plain(*_args(port), q, p, rw, ITERS, duals)[0]
    assert not torch.equal(z_warm, z_cold)          # the duals were used
    _host_matches_plain_and_isolates(host_lib, port, q, p, rw, duals)
