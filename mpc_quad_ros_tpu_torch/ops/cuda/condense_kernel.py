"""Kernel D: condensing from the linearisation J — the "split" pipeline's
second kernel.

Replaces ``mpc_quad_ros_tpu/ops/pallas/condense_kernel.py::
_condense_kernel_J`` (entry ``condense_cost_from_J_tiled``); the CUDA source
is ``csrc/condense_kernel.cu`` (one warp per scenario, the condensing code
of kernel B from ``csrc/condense.cuh``; bounded by the 2.6 GB it moves at
B=65536, N=10, mostly the condensing maps M — see the source's header).

Inputs: J (B, N, 17, 13), r (B, N, 13), dx0 (B, 13), ex0 (B, N+1, 13); q, p
(13) and rw (4) weight floats.  Returns H (B, nz, nz) with the control
diagonal, g (B, nz) without the control term gu, M (B, N+1, 13, nz) and
d (B, N+1, 13), scenario-major.

``condense_cost_from_J`` runs the plain PyTorch version
(``condense_common.condense_from_J``) for CPU tensors and launches the kernel
for CUDA tensors (f32, contiguous, sm_90), raising on anything else.
"""

from __future__ import annotations

import torch

from . import _build
from .condense_common import NT, NU, NX, check_weights, condense_from_J
from .qp_kernel import check_smem


def condense_cost_from_J_plain(J, r, dx0, ex0, q, p, rw):
    return condense_from_J(J, r, dx0, ex0, q, p, rw, with_maps=True)


def _launch(J, r, dx0, ex0, q, p, rw):
    B, N = J.shape[:2]
    nz = N * NU
    tensors = dict(J=J, r=r, dx0=dx0, ex0=ex0)
    shapes = dict(J=(B, N, NT, NX), r=(B, N, NX), dx0=(B, NX), ex0=(B, N + 1, NX))
    _build.check_cuda_inputs("condense_kernel", tensors, shapes)
    check_weights("condense_kernel", q, p, rw)
    lib = _build.load_library()
    check_smem("condense_kernel", lib.mpcq_condense_ws_bytes(N), J.device, f"N={N}")
    weights = _build.host_floats(list(q) + list(p) + list(rw))
    kw = dict(dtype=J.dtype, device=J.device)
    H = torch.empty((B, nz, nz), **kw)
    g = torch.empty((B, nz), **kw)
    M = torch.empty((B, N + 1, NX, nz), **kw)
    d = torch.empty((B, N + 1, NX), **kw)
    rc = lib.mpcq_condense(*(t.data_ptr() for t in tensors.values()), weights.data_ptr(),
                           H.data_ptr(), g.data_ptr(), M.data_ptr(), d.data_ptr(), B, N,
                           torch.cuda.current_stream(J.device).cuda_stream)
    condense_cost_from_J.launches += 1
    _build.check_status("condense_kernel", rc)
    return H, g, M, d


def condense_cost_from_J(J, r, dx0, ex0, q, p, rw):
    if J.device.type == "cpu":
        return condense_cost_from_J_plain(J, r, dx0, ex0, q, p, rw)
    return _launch(J, r, dx0, ex0, q, p, rw)


condense_cost_from_J.launches = 0
