"""Kernel A: RK4 shooting-map linearisation with the folded-RGP drag.

Replaces ``mpc_quad_ros_tpu/ops/pallas/lin_kernel.py::_lin_kernel``; the CUDA
source is ``csrc/lin_kernel.cu`` (a block of 32 columns: tangent 0 of each
column records the drag's moments, the other 16 tangents read them back, J
leaves shared memory as 16-byte stores; bounded by operations — see the
source's header).

For every (scenario b, stage k): xp[b, k] = RK4(f, X[b, k], U[b, k], dt) and
J[b, k, i] = d xp[b, k] / d (x, u)_i, i < 17, scenario-major:
xp (B, N, 13), J (B, N, 17, 13).  X is the whole (B, N+1, 13) trajectory;
aug a per-scenario ``FoldedDrag`` with leaves (B, 3, nb) / (B, 3), or None.

``linearize`` runs the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors (f32, contiguous, sm_90), raising on anything else.
"""

from __future__ import annotations

import torch

from ...models.dynamics import rk4_step
from ...models.params import QuadParams
from . import _build

NX, NU, NT = 13, 4, 17


def model_constants(params: QuadParams, dt: float) -> list[float]:
    """The scalars the kernel's model reads, derived as the JAX kernel's
    ``_make_f`` derives them (thrust gains in the parameters' dtype, the
    rest in double), plus dt, dt/2, dt/6."""
    p = params.map(lambda a: a.detach().cpu())
    kt = (p.rotor_functionality * p.max_thrust).tolist()
    mass, g2 = float(p.mass), float(p.g[2])
    J0, J1, J2 = p.J.tolist()
    return (kt + p.x_f.tolist() + p.y_f.tolist() + p.z_l_tau.tolist()
            + [1.0 / mass, g2, -(float(p.payload_mass) / mass) * g2, J0, J1, J2,
               J1 - J2, J2 - J0, J0 - J1, dt, dt / 2, dt / 6])


def linearize_plain(f, X: torch.Tensor, U: torch.Tensor, aug, dt: float):
    """RK4 of the MPC model f and its 17 forward tangents: ``torch.func.jvp``
    vectorised over the unit tangents with ``torch.func.vmap``."""
    x = X[:, :-1]
    if aug is not None:
        aug = aug.map(lambda a: a.unsqueeze(1))      # broadcast over the stages
    step = lambda xx, uu: rk4_step(lambda a, b: f(a, b, aug), xx, uu, dt)
    eye = torch.eye(NT, dtype=X.dtype, device=X.device)
    tx = eye[:, None, None, :NX].expand((NT,) + x.shape)
    tu = eye[:, None, None, NX:].expand((NT,) + U.shape)
    J = torch.func.vmap(lambda a, b: torch.func.jvp(step, (x, U), (a, b))[1])(tx, tu)
    return step(x, U), J.permute(1, 2, 0, 3)

def _launch(X, U, aug, consts):
    B, N1, _ = X.shape
    N = N1 - 1
    tensors = {"X": X, "U": U}
    shapes = {"X": (B, N + 1, NX), "U": (B, N, NU)}
    nb = 0
    if aug is not None:
        nb = aug.X.shape[-1]
        tensors.update(Xb=aug.X, wb=aug.w, L=aug.L, sigma_f=aug.sigma_f)
        shapes.update(Xb=(B, 3, nb), wb=(B, 3, nb), L=(B, 3), sigma_f=(B, 3))
    _build.check_cuda_inputs("lin_kernel", tensors, shapes)
    lib = _build.load_library()
    consts = _build.host_floats(consts)
    xp = torch.empty((B, N, NX), dtype=X.dtype, device=X.device)
    J = torch.empty((B, N, NT, NX), dtype=X.dtype, device=X.device)
    aug_ptrs = ([aug.X.data_ptr(), aug.w.data_ptr(), aug.L.data_ptr(), aug.sigma_f.data_ptr()]
                if aug is not None else [None] * 4)
    rc = lib.mpcq_lin(X.data_ptr(), U.data_ptr(), *aug_ptrs, nb, xp.data_ptr(),
                      J.data_ptr(), B, N, consts.data_ptr(),
                      torch.cuda.current_stream(X.device).cuda_stream)
    linearize.launches += 1
    _build.check_status("lin_kernel", rc)
    return xp, J


def linearize(X: torch.Tensor, U: torch.Tensor, aug, f, dt: float,
              consts: list[float] | None = None):
    """(xp, J) of the RK4 step along (X, U).  `f` is the MPC model (its
    ``params`` feed the kernel); `consts` = ``model_constants(f.params, dt)``,
    derived here when not given."""
    if X.device.type == "cpu":
        return linearize_plain(f, X, U, aug, dt)
    if consts is None:
        consts = model_constants(f.params, dt)
    return _launch(X, U, aug, consts)


linearize.launches = 0
