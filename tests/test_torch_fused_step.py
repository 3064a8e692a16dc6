"""Kernel F (the whole Gauss-Newton step in one kernel, ``ops/cuda/
sqp_fused_kernel.py::fused_sqp_step``) on the CPU, float64.

- The plain version (kernel A's plain linearisation, then kernel B's plain
  step) against the JAX package's Pallas kernel ``make_fused_sqp_step`` in
  interpret mode, on one 128-lane tile of perturbed N=3 trajectories with
  per-scenario RGP drag, cold and warm-started from the cold step's duals:
  z to 1e-9, dX to 1e-8 (|dX| ~ 10), KKT to 1e-9, the duals to 1e-9.
- The kernel's own source built with g++ for the host against the plain
  version (1e-9), cold and warm, with NaN isolation between scenarios.
- Its shared-memory workspace and device scratch at FUSED_N_MAX = 40, under
  an H100 block's 232,448 B, beside kernels B, D and E at the same horizon.
- On a CUDA device: ``test_torch_cuda_kernels.py`` (JAX-free, so that it
  collects on the GPU host)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.augmented import fold_drag as jax_fold_drag
from mpc_quad_ros_tpu.ops.pallas.sqp_fused_kernel import make_fused_sqp_step
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.cuda import sqp_fused_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.lin_kernel import model_constants

from test_torch_common import (gn_step_inputs, host_library, jax_params, jax_rgp, ptr, tiled,
                               untiled)

N, ITERS = 3, 12
BOX = ("dx0", "ex0", "gu", "lb", "ub")


@pytest.fixture(scope="module")
def step():
    """The step's inputs at B=128 and the plain cold step's duals."""
    inp = gn_step_inputs(128, seed=71, N=N)
    cfg = inp["solver"].cfg
    args = (inp["X"], inp["U"], *(inp[k] for k in BOX), inp["aug"], inp["solver"].f, cfg.dt,
            *cfg.weight_tuples(), ITERS)
    cold = sqp_fused_kernel.fused_sqp_step(*args)
    return inp, args, cold[3:]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


@pytest.mark.parametrize("warm", [False, True])
def test_plain_matches_pallas_fused_kernel(step, warm):
    inp, args, duals = step
    cfg = inp["solver"].cfg
    fused = make_fused_sqp_step(jax_params(), cfg.dt)
    aug = tuple(jnp.asarray(tiled(leaf)) for leaf in jax_fold_drag(jax_rgp(inp["rgp"])))
    tile = lambda a: jnp.asarray(tiled(a.numpy()))
    ref = fused(tile(inp["X"]), tile(inp["U"]), *(tile(inp[k]) for k in BOX), aug,
                *cfg.weight_tuples(), ITERS, interpret=True,
                duals=tuple(map(tile, duals)) if warm else None)
    z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_step(*args, duals=duals if warm else None)
    np.testing.assert_allclose(z.numpy(), untiled(ref[0]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dX.numpy(), untiled(ref[1]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(kkt.numpy(), untiled(ref[2])[:, 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(zl.numpy(), untiled(ref[3]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(zu.numpy(), untiled(ref[4]), rtol=0, atol=1e-9)


def _host(lib, inp, duals, X):
    cfg = inp["solver"].cfg
    Bn = X.shape[0]
    nz = 4 * N
    f64 = dict(dtype=torch.float64)
    out = (torch.empty(Bn, nz, **f64), torch.empty(Bn, N + 1, 13, **f64), torch.empty(Bn, **f64),
           torch.empty(Bn, nz, **f64), torch.empty(Bn, nz, **f64))
    aug = inp["aug"].map(lambda a: a[:Bn].contiguous())
    consts = torch.tensor(model_constants(inp["solver"].f.params, cfg.dt), **f64)
    w = torch.tensor([v for ws in cfg.weight_tuples() for v in ws], **f64)
    d = [duals[0][:Bn].contiguous(), duals[1][:Bn].contiguous()] if duals else [None, None]
    rc = lib.mpcq_sqp_step_host_f64(
        ptr(X), ptr(inp["U"][:Bn].contiguous()), ptr(aug.X), ptr(aug.w), ptr(aug.L),
        ptr(aug.sigma_f), aug.X.shape[-1], *(ptr(inp[k][:Bn].contiguous()) for k in BOX),
        *map(ptr, d), ptr(consts), ptr(w), *map(ptr, out), Bn, N, ITERS)
    assert rc == 0
    return out


@pytest.mark.parametrize("warm", [False, True])
def test_kernel_source_on_host_matches_plain(step, host_lib, warm):
    inp, args, duals = step
    duals = duals if warm else None
    Bn = 8
    cut = lambda a: a[:Bn] if torch.is_tensor(a) else a
    ref = sqp_fused_kernel.fused_sqp_step_plain(
        *map(cut, args[:7]), args[7].map(lambda a: a[:Bn]), *args[8:],
        None if duals is None else tuple(map(cut, duals)))
    X = inp["X"][:Bn].contiguous()
    out = _host(host_lib, inp, duals, X)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)

    bad = 5
    X_bad = X.clone()
    X_bad[bad, 2, 8] = float("nan")
    out_bad = _host(host_lib, inp, duals, X_bad)
    keep = torch.arange(Bn) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


def test_workspace_fits_up_to_fused_n_max(host_lib):
    limit = 232_448          # the shared memory an H100 block may opt into
    n = sqp.FUSED_N_MAX
    # kernel F at N = 40: a warp a scenario and a block, the strip table
    # (3,280 strips of 16 bits, 1,640 floats) and one team's region: the
    # 160 x 164 slot, g, the 13 x 160 map and two d vectors, rounded up to
    # four floats; J and the defects lie in the device scratch, a slice of
    # 40 x (17 x 13 + 13) floats a team, and one spare slice a block
    assert host_lib.mpcq_sqp_step_lanes(65536, n) == 32
    assert (host_lib.mpcq_sqp_step_ws_bytes(n)
            == 4 * (1_640 + (160 * 164 + 160 + 13 * 160 + 26 + 2)) == 120_592)
    assert host_lib.mpcq_sqp_step_scratch_bytes(32, n) == 2 * 4 * n * (17 * 13 + 13)
    assert host_lib.mpcq_sqp_step_ws_bytes(n) <= limit
    assert (host_lib.mpcq_condense_ws_bytes(n) < host_lib.mpcq_box_qp_ws_bytes(4 * n)
            < host_lib.mpcq_sqp_ws_bytes(n) <= limit)
