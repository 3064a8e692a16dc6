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
- ``mpcq_sqp_ws_bytes`` of the host build: kernel B's block (one packed
  nz x (nz + 1) matrix and one condensing map a scenario, J read from device
  memory) is 17,808 bytes at N=10 (two scenarios) and 131,144 at
  ``FUSED_N_MAX`` = 40 (one), the JAX package's ceiling, under an H100
  block's 232,448 bytes; its shared memory alone would pass that only at
  N=54.
- On a CUDA device: ``test_torch_cuda_kernels.py`` and
  ``test_torch_cuda_paths.py`` (JAX-free, so that they collect on the GPU
  host)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops.pallas.riccati_kernel import solve_ocp_box_riccati_ipm_pallas_tiled
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.cuda import riccati_kernel

from test_torch_common import host_library
from test_torch_cuda_common import PT, Q, RD, random_ocp
from test_torch_cuda_common import riccati_kernel_inputs as kernel_inputs
from test_torch_riccati import jax_ipm

ITERS = 12
H100_SMEM_PER_BLOCK = 232_448


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


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
    # a block: two scenarios of 8,904 B at N = 10, one at N = 40
    assert (ws(10), ws(40)) == (2 * 8_904, 131_144)
    assert ws(sqp.FUSED_N_MAX) <= H100_SMEM_PER_BLOCK
    # the shared memory is no longer what stops kernel B at FUSED_N_MAX
    assert ws(53) <= H100_SMEM_PER_BLOCK < ws(54)
    # kernel C (J streamed a stage at a time, K in a device scratch) launches
    # far past it: 24 N + 1312 floats
    ric = host_lib.mpcq_riccati_ws_bytes
    assert ric(40) == 4 * (24 * 40 + 1312) == 9_088
    assert ric(2366) <= H100_SMEM_PER_BLOCK < ric(2367)
