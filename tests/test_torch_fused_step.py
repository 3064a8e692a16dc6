"""Kernel F (the whole Gauss-Newton step in one kernel, ``ops/cuda/
sqp_fused_kernel.py::fused_sqp_step``) on the CPU, float64.

- The plain version (kernel A's plain linearisation, then kernel B's plain
  step) against the JAX package's Pallas kernel ``make_fused_sqp_step`` in
  interpret mode, on one 128-lane tile of perturbed N=3 trajectories with
  per-scenario RGP drag, cold and warm-started from the cold step's duals:
  z to 1e-9, dX to 1e-8 (|dX| ~ 10), KKT to 1e-9, the duals to 1e-9.
- The kernel's own source built with g++ for the host against the plain
  version (1e-9), cold and warm, with NaN isolation between scenarios.
- Its shared-memory workspace: kernel B's plus r, under an H100 block's
  232,448 B up to FUSED_N_MAX = 30 and past it at 31.
- On a CUDA device (skipped here): the kernel against the f64 plain version,
  cold and warm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.augmented import fold_drag as jax_fold_drag
from mpc_quad_ros_tpu.ops.pallas.sqp_fused_kernel import make_fused_sqp_step
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.cuda import sqp_fused_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.lin_kernel import model_constants

from test_torch_common import (gn_step_inputs, host_library, jax_params, jax_rgp, ptr,
                               require_cuda, tiled, untiled)

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
    assert host_lib.mpcq_sqp_step_ws_bytes(n) == host_lib.mpcq_sqp_ws_bytes(n) + 52 * n
    assert host_lib.mpcq_sqp_step_ws_bytes(n) <= limit < host_lib.mpcq_sqp_step_ws_bytes(n + 1)
    assert host_lib.mpcq_condense_ws_bytes(n) < host_lib.mpcq_box_qp_ws_bytes(4 * n) <= limit


@pytest.mark.parametrize("warm", [False, True])
def test_cuda_kernel_matches_f64_plain(step, warm):
    dev = require_cuda()
    inp, args, duals = step
    duals = duals if warm else None
    ref = sqp_fused_kernel.fused_sqp_step_plain(*args, duals)
    f32 = lambda a: a.float().to(dev) if torch.is_tensor(a) else a
    p32 = inp["solver"].f.params.map(f32)
    z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_step(
        *map(f32, args[:7]), args[7].map(f32), make_mpc_dynamics(p32), *args[9:],
        duals=None if duals is None else tuple(map(f32, duals)))
    assert (z.double().cpu() - ref[0]).abs().max() < 4e-2     # the f32 12-iteration floor
    assert kkt.max().item() <= ref[2].max().item() + 1e-3
    assert torch.isfinite(zl).all() and (zl > 0).all() and (zu > 0).all()
