"""Kernels D (condensing from J) and J (condensing fed A and B),
``ops/cuda/condense_kernel.py``, on the CPU, float64.

- The plain version against the JAX package's Pallas kernel
  ``condense_cost_from_J_tiled`` in interpret mode, on one 128-lane tile of
  N=5 linearisations of perturbed trajectories: H, g, M and d to 1e-12
  relative to their largest entry (the same sums; the Pallas kernel mirrors
  only the strict block-lower part of H, the port the strict lower triangle,
  so the diagonal blocks' upper entries may differ in the last bit).  H is
  exactly symmetric, and the plain H and g are kernel B's.
- The kernel's own source built with g++ for the host against the plain
  version (1e-9), with NaN isolation between scenarios.
- Kernel J's plain version against the JAX package's ``condense_cost_pallas``
  (``_condense_kernel``) in interpret mode on the same tile, to 1e-12; its
  source on the host against its plain version, with NaN isolation, and
  bitwise equal to kernel D's host build on the same linearisation (the
  same code once A and B are staged in J's layout).
- On a CUDA device: ``test_torch_cuda_kernels.py`` (JAX-free, so that it
  collects on the GPU host)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops.pallas.condense_kernel import (condense_cost_from_J_tiled,
                                                          condense_cost_pallas)
from mpc_quad_ros_tpu_torch.ops.cuda import condense_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import condense_from_J, split_AB

from test_torch_common import gn_step_inputs, host_library, ptr, tiled, untiled

N = 5
ARGS = ("J", "r", "dx0", "ex0")
TAIL = ARGS[1:]


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


def _AB(J):
    return [a.contiguous() for a in split_AB(J)]


def _host(lib, args, q, p, rw, entry="mpcq_condense_host_f64"):
    Bn, Nn = args[0].shape[:2]
    nz = 4 * Nn
    f64 = dict(dtype=torch.float64)
    out = (torch.empty(Bn, nz, nz, **f64), torch.empty(Bn, nz, **f64),
           torch.empty(Bn, Nn + 1, 13, nz, **f64), torch.empty(Bn, Nn + 1, 13, **f64))
    w = torch.tensor(list(q) + list(p) + list(rw), **f64)
    assert getattr(lib, entry)(*map(ptr, args), ptr(w), *map(ptr, out), Bn, Nn) == 0
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


def test_ab_plain_matches_pallas_condense_kernel(step):
    inp, (q, p, rw) = step
    A, Bm = _AB(inp["J"])
    out = condense_kernel.condense_cost_from_AB(A, Bm, *(inp[k] for k in TAIL), q, p, rw)
    ref = condense_cost_pallas(*(jnp.asarray(a.numpy()) for a in (A, Bm, *(inp[k] for k in TAIL))),
                               q=q, p=p, rw=rw, interpret=True)
    for ours, theirs in zip(out, ref):
        assert _rel(ours.numpy(), np.asarray(theirs)) <= 1e-12
    np.testing.assert_array_equal(out[0].numpy(), out[0].mT.numpy())
    # kernel D's plain version on the J these blocks came from
    for a, b in zip(out, condense_kernel.condense_cost_from_J_plain(
            *(inp[k] for k in ARGS), q, p, rw)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-13


def test_ab_kernel_source_on_host_matches_plain(step, host_lib):
    inp, (q, p, rw) = step
    tail = [inp[k][:8].contiguous() for k in TAIL]
    J = inp["J"][:8].contiguous()
    args = _AB(J) + tail
    ref = condense_kernel.condense_cost_from_AB_plain(*args, q, p, rw)
    out = _host(host_lib, args, q, p, rw, "mpcq_condense_ab_host_f64")
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)
    # staged in J's layout, A and B run kernel D's code: bitwise its output
    for a, b in zip(out, _host(host_lib, [J] + tail, q, p, rw)):
        assert torch.equal(a, b)

    bad = 3
    args[0] = args[0].clone()
    args[0][bad, 2, 7, 4] = float("nan")
    out_bad = _host(host_lib, args, q, p, rw, "mpcq_condense_ab_host_f64")
    keep = torch.arange(8) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])
