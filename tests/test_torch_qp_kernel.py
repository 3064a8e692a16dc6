"""Kernel E (the standalone box-QP interior point, ``ops/cuda/qp_kernel.py``)
on the CPU, float64, on the condensed QPs of perturbed trajectories.

- The plain IPM against the JAX package's Pallas kernel
  ``solve_box_qp_pdip_pallas(..., symmetrize=False)`` in interpret mode, at
  N=5 (nz=20; the interpret-mode compile grows with nz),
  cold-started and warm-started from the cold solve's duals
  (``return_duals=True``): z, zl and zu to 1e-9 (12 iterations amplify the
  rounding of two Cholesky codes by ~1e3-1e4).
- The kernel's own source built with g++ for the host against the plain
  version (1e-9), cold and warm, with NaN isolation between scenarios.
- The wrapper: one warm dual alone is refused.
- On a CUDA device: ``test_torch_cuda_kernels.py`` (JAX-free, so that it
  collects on the GPU host)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops.pallas.qp_kernel import solve_box_qp_pdip_pallas
from mpc_quad_ros_tpu_torch.ops.cuda import qp_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import condense_from_J

from test_torch_common import gn_step_inputs, host_library, ptr

B, N, ITERS = 6, 5, 12


@pytest.fixture(scope="module")
def qp():
    """(H, g, lb, ub) of B scenarios, and the plain cold solve's duals."""
    inp = gn_step_inputs(B, seed=61, N=N)
    H, g = condense_from_J(*(inp[k] for k in ("J", "r", "dx0", "ex0")),
                           *inp["solver"].cfg.weight_tuples())
    box = (H, g + inp["gu"], inp["lb"], inp["ub"])
    _, zl, zu = qp_kernel.ipm_box_solve(*box, ITERS)
    return box, (zl, zu)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


@pytest.mark.parametrize("warm", [False, True])
def test_plain_matches_pallas_qp_kernel(qp, warm):
    box, duals = qp
    kw = dict(zl0=jnp.asarray(duals[0].numpy()), zu0=jnp.asarray(duals[1].numpy())) if warm else {}
    ref = solve_box_qp_pdip_pallas(*(jnp.asarray(a.numpy()) for a in box), iters=ITERS,
                                   interpret=True, return_duals=True, symmetrize=False, **kw)
    out = qp_kernel.solve_box_qp_pdip_batch(*box, ITERS, *(duals if warm else (None, None)))
    for ours, theirs in zip(out, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-9)
    if warm:
        assert not torch.equal(out[0], qp_kernel.ipm_box_solve(*box, ITERS)[0])


def _host(lib, box, duals):
    Bn, nz = box[1].shape
    out = [torch.empty(Bn, nz, dtype=torch.float64) for _ in range(3)]
    d = duals if duals is not None else (None, None)
    assert lib.mpcq_box_qp_host_f64(*map(ptr, box), *map(ptr, d), *map(ptr, out), Bn, nz,
                                    ITERS) == 0
    return out


@pytest.mark.parametrize("warm", [False, True])
def test_kernel_source_on_host_matches_plain(qp, host_lib, warm):
    box, duals = qp
    duals = duals if warm else None
    ref = qp_kernel.ipm_box_solve(*box, ITERS, *(duals or (None, None)))
    out = _host(host_lib, box, duals)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)

    bad = 4
    H_bad = box[0].clone()
    H_bad[bad, 5, 6] = float("nan")
    out_bad = _host(host_lib, (H_bad,) + box[1:], duals)
    keep = torch.arange(B) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


def test_one_dual_alone_is_refused(qp):
    box, duals = qp
    with pytest.raises(ValueError, match="both"):
        qp_kernel.solve_box_qp_pdip_batch(*box, ITERS, duals[0], None)
