"""Kernels D and J: condensing, fed the linearisation J (kernel D, the
"split" pipeline's second kernel) or its A and B blocks (kernel J, the
small-batch step's).

Kernel D replaces ``mpc_quad_ros_tpu/ops/pallas/condense_kernel.py::
_condense_kernel_J`` (entry ``condense_cost_from_J_tiled``), kernel J
replaces ``_condense_kernel`` (entry ``condense_cost_pallas``, which the JAX
``solve_batch`` runs for B < 128).  The CUDA source of both is
``csrc/condense_kernel.cu`` (the condensing chains of kernel B from
``csrc/condense.cuh``, one scenario run by a warp for kernel D and by a
block for kernel J; bounded by the 2.6 GB it moves at B=65536, N=10, mostly
the condensing maps M — see the source's header).

Inputs: J (B, N, 17, 13), or A (B, N, 13, 13) and Bm (B, N, 13, 4); r
(B, N, 13), dx0 (B, 13), ex0 (B, N+1, 13); q, p (13) and rw (4) weight
floats.  Returns H (B, nz, nz) with the control diagonal, g (B, nz) without
the control term gu, M (B, N+1, 13, nz) and d (B, N+1, 13), scenario-major.

``condense_cost_from_J`` and ``condense_cost_from_AB`` run the plain PyTorch
version (``condense_common.condense``) for CPU tensors and launch their
kernel for CUDA tensors (f32, contiguous, sm_90), raising on anything else.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .condense_common import NT, NU, NX, check_weights, condense, condense_from_J
from .qp_kernel import check_smem

def condense_cost_from_J_plain(J, r, dx0, ex0, q, p, rw):
    return condense_from_J(J, r, dx0, ex0, q, p, rw, with_maps=True)


def condense_cost_from_AB_plain(A, Bm, r, dx0, ex0, q, p, rw):
    return condense(A, Bm, r, dx0, ex0, q, p, rw, with_maps=True)


@functools.lru_cache(maxsize=16)
def _host_weights(weights: tuple) -> torch.Tensor:
    """The weight floats the C entries read, one host tensor per tuple."""
    return _build.host_floats(weights)


def _launch(name, entry, tensors, shapes, B, N, q, p, rw):
    """Check the inputs, launch `entry` and return (H, g, M, d, status)."""
    _build.check_cuda_inputs(name, tensors, shapes)
    check_weights(name, q, p, rw)
    lib = _build.load_library()
    dev = next(iter(tensors.values())).device
    check_smem(name, lib.mpcq_condense_ws_bytes(N), dev, f"N={N}")
    weights = _host_weights(tuple(map(float, (*q, *p, *rw))))
    nz = N * NU
    kw = dict(dtype=torch.float32, device=dev)
    H = torch.empty((B, nz, nz), **kw)
    g = torch.empty((B, nz), **kw)
    M = torch.empty((B, N + 1, NX, nz), **kw)
    d = torch.empty((B, N + 1, NX), **kw)
    rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors.values()), weights.data_ptr(),
                             H.data_ptr(), g.data_ptr(), M.data_ptr(), d.data_ptr(), B, N,
                             torch.cuda.current_stream(dev).cuda_stream)
    return H, g, M, d, rc


def _tail_shapes(B, N) -> dict:
    return dict(r=(B, N, NX), dx0=(B, NX), ex0=(B, N + 1, NX))


def condense_cost_from_J(J, r, dx0, ex0, q, p, rw):
    """Kernel D."""
    if J.device.type == "cpu":
        return condense_cost_from_J_plain(J, r, dx0, ex0, q, p, rw)
    B, N = J.shape[:2]
    *out, rc = _launch("condense_kernel", "mpcq_condense", dict(J=J, r=r, dx0=dx0, ex0=ex0),
                       dict(J=(B, N, NT, NX), **_tail_shapes(B, N)), B, N, q, p, rw)
    condense_cost_from_J.launches += 1
    _build.check_status("condense_kernel", rc)
    return tuple(out)


def condense_cost_from_AB(A, Bm, r, dx0, ex0, q, p, rw):
    """Kernel J."""
    if A.device.type == "cpu":
        return condense_cost_from_AB_plain(A, Bm, r, dx0, ex0, q, p, rw)
    B, N = A.shape[:2]
    *out, rc = _launch("condense_ab_kernel", "mpcq_condense_ab",
                       dict(A=A, Bm=Bm, r=r, dx0=dx0, ex0=ex0),
                       dict(A=(B, N, NX, NX), Bm=(B, N, NX, NU), **_tail_shapes(B, N)),
                       B, N, q, p, rw)
    condense_cost_from_AB.launches += 1
    _build.check_status("condense_ab_kernel", rc)
    return tuple(out)


condense_cost_from_J.launches = 0
condense_cost_from_AB.launches = 0
