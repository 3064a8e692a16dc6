"""Kernel C (the Riccati-factorised box IPM, ``ops/cuda/riccati_kernel.py``)
and kernel B's shared memory up to FUSED_N_MAX, on the CPU in float64.

- The plain version against the JAX package's XLA oracle
  ``ops/riccati.solve_ocp_box_riccati_ipm`` (vmapped), with J formed from A
  and B as ``tests/test_riccati_kernel.py`` forms it, at N=12 and N=40: the
  same iterations with Cholesky instead of LU for the 4x4 systems, 1e-12
  (measured ~2e-15); dX is the affine rollout of dU.
- The plain version against the Pallas kernel itself in interpret mode at
  B=128, N=12, in float64: the same algorithm, 1e-12 (measured 2e-15).
- The kernel's own source built with g++ for the host against the plain
  version: 1e-12 (measured 3e-15), and a NaN in one scenario leaves every
  other scenario bitwise unchanged.
- ``mpcq_sqp_ws_bytes`` of the host build: kernel B's workspace (one packed
  nz x (nz + 1) matrix, J streamed) is 12,752 bytes at N=10 and 132,912 at
  ``FUSED_N_MAX`` = 40, the JAX package's ceiling, under an H100 block's
  232,448 bytes; its shared memory alone would pass that only at N=54.
- On a CUDA device (skipped here): kernel C against its f64 plain version,
  kernel B's ValueError at N=41, and solve_batch(qp_method="pdip") past
  FUSED_N_MAX, at N = 41, 80, 160, through kernels A and C only."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops.pallas.riccati_kernel import solve_ocp_box_riccati_ipm_pallas_tiled
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.cuda import lin_kernel, riccati_kernel, sqp_fused_kernel
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry

from test_torch_common import host_library, jax_params, port_params, require_cuda, solve_inputs, t
from test_torch_riccati import PT, Q, RD, jax_ipm, random_ocp

ITERS = 12
H100_SMEM_PER_BLOCK = 232_448
ARGS = ("c", "dx0", "qlin", "rlin", "plin", "lb", "ub")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


def kernel_inputs(o: dict) -> list:
    """[J, c, dx0, qlin, rlin, plin, lb, ub] as contiguous tensors; J
    (B, N, 17, 13) holds the columns of [A | B]."""
    J = np.concatenate([o["A"], o["Bm"]], axis=3).transpose(0, 1, 3, 2)
    return [t(J).contiguous()] + [t(o[k]).contiguous() for k in ARGS]


def affine_rollout(args, du):
    J, c, dx0 = args[:3]
    A, Bm = J[:, :, :13].mT, J[:, :, 13:].mT
    dx, out = dx0, [dx0]
    for k in range(du.shape[1]):
        dx = (A[:, k] @ dx[..., None])[..., 0] + (Bm[:, k] @ du[:, k, :, None])[..., 0] + c[:, k]
        out.append(dx)
    return torch.stack(out, 1)


@pytest.mark.parametrize("N", [12, 40])
def test_plain_matches_jax_oracle(N):
    o = random_ocp(6, N, seed=200 + N)
    args = kernel_inputs(o)
    du, dX = riccati_kernel.riccati_ipm_from_J(*args, Q, PT, RD, ITERS)
    ref = jax_ipm(o)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dX.numpy(), np.asarray(ref[1]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dX.numpy(), affine_rollout(args, du).numpy(), rtol=0, atol=1e-12)


def test_plain_matches_pallas_kernel():
    B, N = 128, 12
    o = random_ocp(B, N, seed=5)
    args = kernel_inputs(o)

    def tile(a):
        a = jnp.asarray(a.numpy())
        return jnp.moveaxis(a.reshape((B // 128, 128) + a.shape[1:]), 1, -1)

    def untile(a):
        return np.moveaxis(np.asarray(a), -1, 1).reshape((B,) + a.shape[1:-1])

    dUt, dXt = solve_ocp_box_riccati_ipm_pallas_tiled(
        *(tile(a) for a in args), q=Q, p_term=PT, rdiag=RD, nu=4, iters=ITERS, interpret=True)
    du, dX = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, Q, PT, RD, ITERS)
    np.testing.assert_allclose(du.numpy(), untile(dUt), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dX.numpy(), untile(dXt), rtol=0, atol=1e-12)


def _host_solve(lib, args):
    B, N = args[0].shape[:2]
    du = torch.empty(B, N, 4, dtype=torch.float64)
    dX = torch.empty(B, N + 1, 13, dtype=torch.float64)
    w = torch.tensor(list(Q) + list(PT) + list(RD), dtype=torch.float64)
    rc = lib.mpcq_riccati_ipm_host_f64(*(a.data_ptr() for a in args), w.data_ptr(),
                                       du.data_ptr(), dX.data_ptr(), B, N, ITERS)
    assert rc == 0
    return du, dX


@pytest.mark.parametrize("N", [12, 40])
def test_kernel_source_on_host_matches_plain(host_lib, N):
    B = 6
    args = kernel_inputs(random_ocp(B, N, seed=300 + N))
    ref = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, Q, PT, RD, ITERS)
    out = _host_solve(host_lib, args)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)

    # a NaN in one scenario leaves every other scenario bitwise unchanged
    bad = 2
    J_bad = args[0].clone()
    J_bad[bad, N // 2, 5, 8] = float("nan")
    out_bad = _host_solve(host_lib, [J_bad] + args[1:])
    keep = torch.arange(B) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


def test_fused_n_max_is_kernel_b_shared_memory_ceiling(host_lib):
    ws = host_lib.mpcq_sqp_ws_bytes
    assert (ws(10), ws(40)) == (12_752, 132_912)
    assert ws(sqp.FUSED_N_MAX) <= H100_SMEM_PER_BLOCK
    # the shared memory is no longer what stops kernel B at FUSED_N_MAX
    assert ws(53) <= H100_SMEM_PER_BLOCK < ws(54)
    # kernel C (J streamed a stage at a time, K in a device scratch) launches
    # far past it: 24 N + 1128 floats
    ric = host_lib.mpcq_riccati_ws_bytes
    assert ric(40) == 4 * (24 * 40 + 1128) == 8_352
    assert ric(2374) <= H100_SMEM_PER_BLOCK < ric(2375)


def test_cuda_kernel_matches_f64_plain():
    dev = require_cuda()
    args = kernel_inputs(random_ocp(256, 40, seed=7))
    du_d, dX_d = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, Q, PT, RD, ITERS)
    du, dX = riccati_kernel.riccati_ipm_from_J(*(a.float().to(dev) for a in args),
                                               Q, PT, RD, ITERS)
    # f32 rounding through 12 iterations (measured 1.6e-6 on an H100);
    # the JAX package pins its f32 kernel at 1e-3 of the converged truth
    assert (du.double().cpu() - du_d).abs().max() < 1e-4
    assert (dX.double().cpu() - dX_d).abs().max() < 1e-4


def test_cuda_kernel_b_refuses_past_its_ceiling():
    dev = require_cuda()
    B, N = 4, sqp.FUSED_N_MAX + 1
    nz = 4 * N
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="FUSED_N_MAX"):
        sqp_fused_kernel.fused_sqp_from_J(z(B, N, 17, 13), z(B, N, 13), z(B, 13),
                                          z(B, N + 1, 13), z(B, nz), z(B, nz), z(B, nz) + 1,
                                          Q, PT, RD, ITERS)


@pytest.mark.parametrize("N", [sqp.FUSED_N_MAX + 1, 80, 160])
def test_cuda_solve_batch_riccati_runs_kernels_a_and_c(N):
    dev = require_cuda()
    inp = solve_inputs(64, seed=43, N=N)
    p = port_params().map(lambda a: a.float().to(dev))
    counters = (lin_kernel.linearize, sqp_fused_kernel.fused_sqp_from_J,
                riccati_kernel.riccati_ipm_from_J)
    for fn in counters:
        fn.launches = 0
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(p.hover_input), qp_method="pdip")
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    x0, y_ref = t(inp["x0"]).float().to(dev), t(inp["y_ref"]).float().to(dev)
    rgp = interop.rgp_state_from_numpy(inp["rgp"], device=dev, dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, sol = solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1], rgp)
    torch.cuda.synchronize()
    assert torch.isfinite(sol.U).all() and torch.isfinite(sol.kkt_residual).all()
    assert bool(((sol.U >= 0) & (sol.U <= 1)).all())
    # kernel A twice (the step and the KKT's adjoint), kernel C once, B never
    assert [fn.launches for fn in counters] == [2, 0, 1]
