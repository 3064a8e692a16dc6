"""Kernel D (condensing from J, ``ops/cuda/condense_kernel.py``) on the CPU,
float64.

- The plain version against the JAX package's Pallas kernel
  ``condense_cost_from_J_tiled`` in interpret mode, on one 128-lane tile of
  N=5 linearisations of perturbed trajectories: H, g, M and d to 1e-12
  relative to their largest entry (the same sums; the Pallas kernel mirrors
  only the strict block-lower part of H, the port the strict lower triangle,
  so the diagonal blocks' upper entries may differ in the last bit).  H is
  exactly symmetric, and the plain H and g are kernel B's.
- The kernel's own source built with g++ for the host against the plain
  version (1e-9), with NaN isolation between scenarios.
- On a CUDA device (skipped here): the kernel against the f64 plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops.pallas.condense_kernel import condense_cost_from_J_tiled
from mpc_quad_ros_tpu_torch.ops.cuda import condense_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import condense_from_J

from test_torch_common import gn_step_inputs, host_library, ptr, require_cuda, tiled, untiled

N = 5
ARGS = ("J", "r", "dx0", "ex0")


@pytest.fixture(scope="module")
def step():
    inp = gn_step_inputs(128, seed=51, N=N)
    return inp, inp["solver"].cfg.weight_tuples()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_plain_matches_pallas_condense_from_J(step):
    inp, (q, p, rw) = step
    H, g, M, d = condense_kernel.condense_cost_from_J(*(inp[k] for k in ARGS), q, p, rw)
    out = condense_cost_from_J_tiled(*(jnp.asarray(tiled(inp[k])) for k in ARGS),
                                     q=q, p=p, rw=rw, interpret=True)
    for ours, ref in zip((H, g, M, d), out):
        assert _rel(ours.numpy(), untiled(ref)) <= 1e-12
    np.testing.assert_array_equal(H.numpy(), H.mT.numpy())       # mirrored, exactly symmetric
    # the split and hybrid pipelines form H and g alike
    H_b, g_b = condense_from_J(*(inp[k] for k in ARGS), q, p, rw)
    assert torch.equal(H, H_b) and torch.equal(g, g_b)
    assert torch.equal(M[:, 0], torch.zeros_like(M[:, 0])) and torch.equal(d[:, 0], inp["dx0"])


def _host(lib, args, q, p, rw):
    Bn, Nn = args[0].shape[:2]
    nz = 4 * Nn
    f64 = dict(dtype=torch.float64)
    out = (torch.empty(Bn, nz, nz, **f64), torch.empty(Bn, nz, **f64),
           torch.empty(Bn, Nn + 1, 13, nz, **f64), torch.empty(Bn, Nn + 1, 13, **f64))
    w = torch.tensor(list(q) + list(p) + list(rw), **f64)
    assert lib.mpcq_condense_host_f64(*map(ptr, args), ptr(w), *map(ptr, out), Bn, Nn) == 0
    return out


def test_kernel_source_on_host_matches_plain(step, host_lib):
    inp, (q, p, rw) = step
    args = [inp[k][:8].contiguous() for k in ARGS]
    ref = condense_kernel.condense_cost_from_J_plain(*args, q, p, rw)
    out = _host(host_lib, args, q, p, rw)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)

    bad = 3
    args[0] = args[0].clone()
    args[0][bad, 2, 4, 7] = float("nan")
    out_bad = _host(host_lib, args, q, p, rw)
    keep = torch.arange(8) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


def test_cuda_kernel_matches_f64_plain(step):
    dev = require_cuda()
    inp, (q, p, rw) = step
    args = [inp[k] for k in ARGS]
    ref = condense_kernel.condense_cost_from_J_plain(*args, q, p, rw)
    out = condense_kernel.condense_cost_from_J(*(a.float().to(dev) for a in args), q, p, rw)
    # f32 sums of at most 13 N terms per entry, relative to the largest entry
    for a, b in zip(out, ref):
        assert _rel(a.double().cpu().numpy(), b.numpy()) < 1e-5
    assert torch.equal(out[0], out[0].mT)
