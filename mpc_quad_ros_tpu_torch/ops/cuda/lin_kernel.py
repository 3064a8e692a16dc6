"""Kernel A: RK4 shooting-map linearisation with the folded-RGP drag.

Replaces ``mpc_quad_ros_tpu/ops/pallas/lin_kernel.py::_lin_kernel``; the CUDA
source is ``csrc/lin_kernel.cu`` (a tile of up to 128 columns a block: each column's
primal step once, one thread a column, recording what the tangents read;
then the tile's 17 tangents a column, one item a thread, each warp's rows
of J out through shared memory as 16-byte stores; bounded by operations —
see the source's header).

For every (scenario b, stage k): xp[b, k] = RK4(f, X[b, k], U[b, k], dt) and
J[b, k, i] = d xp[b, k] / d (x, u)_i, i < 17, scenario-major:
xp (B, N, 13), J (B, N, 17, 13).  X is the whole (B, N+1, 13) trajectory;
aug a per-scenario ``FoldedDrag`` with leaves (B, 3, nb) / (B, 3), or None.

``linearize`` runs the plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors (f32, contiguous, sm_90), raising on anything else.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD
from torch.overrides import TorchFunctionMode

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


_T = torch.Tensor
_ARITHMETIC = frozenset({
    _T.__add__, _T.__radd__, _T.add, torch.add, _T.__sub__, _T.__rsub__, _T.sub, torch.sub,
    _T.__mul__, _T.__rmul__, _T.mul, torch.mul, _T.__truediv__, _T.__rtruediv__, _T.div,
    torch.div})


def _is_dual(a) -> bool:
    return isinstance(a, torch.Tensor) and fwAD.unpack_dual(a).tangent is not None


class _ConstantTangents(TorchFunctionMode):
    """Gives the constant operand of an arithmetic op on a dual tensor a zero
    tangent of its own.  Forward AD would otherwise stand a ZeroTensor in
    for it, and torch computes the shape of each product with a ZeroTensor
    in the Python Meta kernel that ``torch/_meta_registrations.py``
    registers over the C++ one: ~0.6 ms a product on the CPU, most of a
    closed-loop tick.  A Python number becomes a 0-dim tensor of the dual's
    dtype, the cast the op makes anyway.  The tangents keep their bits
    (x_t c + 0 x_p = x_t c) where the primal is finite."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _ARITHMETIC and len(args) == 2 and _is_dual(args[0]) != _is_dual(args[1]):
            i = 1 if _is_dual(args[0]) else 0
            c = args[i]
            if not isinstance(c, torch.Tensor):
                c = torch.tensor(c, dtype=args[1 - i].dtype)
            args = list(args)
            args[i] = fwAD.make_dual(c, torch.zeros_like(c))
        return func(*args, **(kwargs or {}))


# The one-pass plain version computes the primal 17 times over: past this
# many (scenario, stage) pairs that costs more than the constant tangents it
# saves.  On one CPU core (torch 2.13, RGP drag) it is 4.4x faster at B=1,
# N=5 and 1.4x at B=32, N=10; the two break even at about 500 pairs in f64
# and 1000 in f32.  The CPU scalars stay on the CPU, so a CUDA op takes the
# same path for them as without the mode (a division by one multiplies by
# its reciprocal).
ONE_PASS_MAX_STAGES = 400


def linearize_plain(f, X: torch.Tensor, U: torch.Tensor, aug, dt: float):
    """RK4 of the MPC model f and its 17 forward tangents, by two versions
    that agree bit for bit: up to ONE_PASS_MAX_STAGES (scenario, stage)
    pairs, one forward-AD pass over 17 copies of (x, u), copy i carrying the
    i-th unit tangent; past it, ``torch.func.jvp`` vectorised over the unit
    tangents with ``torch.func.vmap``."""
    x = X[:, :-1]
    if aug is not None:
        aug = aug.map(lambda a: a.unsqueeze(1))      # broadcast over the stages
    step = lambda xx, uu: rk4_step(lambda a, b: f(a, b, aug), xx, uu, dt)
    eye = torch.eye(NT, dtype=X.dtype, device=X.device)
    tx, tu = eye[:, None, None, :NX], eye[:, None, None, NX:]
    if x.shape[0] * x.shape[1] > ONE_PASS_MAX_STAGES:
        J = torch.func.vmap(lambda a, b: torch.func.jvp(step, (x, U), (a, b))[1])(
            tx.expand((NT,) + x.shape), tu.expand((NT,) + U.shape))
        return step(x, U), J.permute(1, 2, 0, 3)
    copies = lambda a, t: fwAD.make_dual(a.expand((NT,) + a.shape).contiguous(),
                                         t.expand((NT,) + a.shape).contiguous())
    with fwAD.dual_level(), _ConstantTangents():
        xp, J = fwAD.unpack_dual(step(copies(x, tx), copies(U, tu)))
    return xp[0].clone(), J.permute(1, 2, 0, 3)


def drag_args(aug, B: int) -> tuple[dict, dict, list, int]:
    """The folded drag's share of kernels A's and F's arguments: its tensors
    and their shapes (for ``_build.check_cuda_inputs``), the four pointers
    Xb, wb, L, sigma_f (null without drag) and nb."""
    if aug is None:
        return {}, {}, [None] * 4, 0
    nb = aug.X.shape[-1]
    tensors = dict(Xb=aug.X, wb=aug.w, L=aug.L, sigma_f=aug.sigma_f)
    shapes = dict(Xb=(B, 3, nb), wb=(B, 3, nb), L=(B, 3), sigma_f=(B, 3))
    return tensors, shapes, [t.data_ptr() for t in tensors.values()], nb


def _launch(X, U, aug, consts):
    B, N1, _ = X.shape
    N = N1 - 1
    drag, drag_shapes, aug_ptrs, nb = drag_args(aug, B)
    _build.check_cuda_inputs("lin_kernel", {"X": X, "U": U, **drag},
                             {"X": (B, N + 1, NX), "U": (B, N, NU), **drag_shapes})
    lib = _build.load_library()
    consts = _build.host_floats(consts)
    xp = torch.empty((B, N, NX), dtype=X.dtype, device=X.device)
    J = torch.empty((B, N, NT, NX), dtype=X.dtype, device=X.device)
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
