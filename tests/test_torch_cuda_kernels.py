"""The port's kernels on a CUDA device (each test skips without one): each
kernel's wrapper against its plain version in f64 (and for G, H and I in
f32), and the wrappers refusing what the kernels do not take.  JAX-free, so
that it collects on the GPU host:

    python -m pytest tests/test_torch_cuda_*.py -q

Each test keeps the checks and tolerances it had beside the kernel's CPU
tests (``test_torch_<kernel>.py``), on the same seeds; the inputs come from
the port's own parameters and RGP (``test_torch_cuda_common``)."""

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.bench import phases, probe_hybrid
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.cuda import (_build, condense_kernel, lin_kernel, qp_kernel,
                                             riccati_kernel, sqp_fused_kernel)
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import condense_from_J, split_AB

from test_torch_cuda_common import (PT, Q, RD, gn_step_inputs, port_params, random_ocp,
                                    require_cuda, riccati_kernel_inputs, t, trajectory_inputs)

PROBES = {"mirror": (probe_hybrid.mirror_probe_plain, probe_hybrid.mirror_probe),
          "elem": (probe_hybrid.elem_probe_plain, probe_hybrid.elem_probe)}
ITERS = 12


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _fma_input(grid=2, S=8, seed=0):
    return np.random.default_rng(seed).uniform(0.99, 1.01, (grid, S, 128))


# ---------------------------------------------------------------- G, H, I

def test_cuda_fma_matches_plain():
    dev = require_cuda()
    x = torch.from_numpy(_fma_input(4, 8, seed=2))
    for resident in (True, False):
        for chains, steps in ((16, 64), (8, 61)):
            ref = phases.fma_chains_plain(x, chains, steps)
            out = phases.fma_chains(x.float().to(dev), chains, steps, resident)
            # one FFMA rounding a step on a growing sum, relative (read 2.6e-6
            # against f64 on an H100)
            assert _rel(out.double().cpu().numpy(), ref.numpy()) < 1e-5
    with pytest.raises(ValueError):
        phases.fma_chains(x.float().to(dev), 3, 4)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_cuda_probe_matches_plain(name):
    dev = require_cuda()
    plain, wrapper = PROBES[name]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((256, 40, 40)))
    out = wrapper(x.float().to(dev), 4)
    # one multiply-add a repetition per entry: f32 rounding, relative
    assert _rel(out.double().cpu().numpy(), plain(x, 4).numpy()) < 1e-6


@pytest.mark.parametrize("name", sorted(PROBES))
def test_cuda_probe_refuses_odd_widths_and_unaligned_views(name):
    dev = require_cuda()
    _, wrapper = PROBES[name]
    launches = wrapper.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        wrapper(torch.zeros((8, 6, 6), device=dev), 4)
    flat = torch.zeros(8 * 40 * 40 + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(flat[1:].view(8, 40, 40), 4)
    assert wrapper.launches == launches


# ---------------------------------------------------------------- D and J

@pytest.fixture(scope="module")
def condense_step():
    inp = gn_step_inputs(128, seed=51, N=5)
    return inp, inp["solver"].cfg.weight_tuples()


def _AB(J):
    return [a.contiguous() for a in split_AB(J)]


def test_cuda_condense_kernel_matches_f64_plain(condense_step):
    dev = require_cuda()
    inp, (q, p, rw) = condense_step
    args = [inp[k] for k in ("J", "r", "dx0", "ex0")]
    ref = condense_kernel.condense_cost_from_J_plain(*args, q, p, rw)
    out = condense_kernel.condense_cost_from_J(*(a.float().to(dev) for a in args), q, p, rw)
    # f32 sums of at most 13 N terms per entry, relative to the largest entry
    for a, b in zip(out, ref):
        assert _rel(a.double().cpu().numpy(), b.numpy()) < 1e-5
    assert torch.equal(out[0], out[0].mT)


def test_cuda_ab_kernel_matches_f64_plain(condense_step):
    dev = require_cuda()
    inp, (q, p, rw) = condense_step
    A, Bm = _AB(inp["J"])
    tail = [inp[k] for k in ("r", "dx0", "ex0")]
    ref = condense_kernel.condense_cost_from_AB_plain(A, Bm, *tail, q, p, rw)
    f32 = lambda a: a.float().to(dev)
    out = condense_kernel.condense_cost_from_AB(f32(A), f32(Bm), *map(f32, tail), q, p, rw)
    for a, b in zip(out, ref):
        assert _rel(a.double().cpu().numpy(), b.numpy()) < 1e-5
    d_out = condense_kernel.condense_cost_from_J(f32(inp["J"]), *map(f32, tail), q, p, rw)
    for a, b in zip(out, d_out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- F

@pytest.fixture(scope="module")
def sqp_step():
    """The step's inputs at B=128, N=3 and the plain cold step's duals."""
    inp = gn_step_inputs(128, seed=71, N=3)
    cfg = inp["solver"].cfg
    args = (inp["X"], inp["U"], *(inp[k] for k in ("dx0", "ex0", "gu", "lb", "ub")), inp["aug"],
            inp["solver"].f, cfg.dt, *cfg.weight_tuples(), ITERS)
    cold = sqp_fused_kernel.fused_sqp_step(*args)
    return inp, args, cold[3:]


@pytest.mark.parametrize("warm", [False, True])
def test_cuda_sqp_step_kernel_matches_f64_plain(sqp_step, warm):
    dev = require_cuda()
    inp, args, duals = sqp_step
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


# ---------------------------------------------------------------- A

def test_cuda_lin_kernel_matches_plain():
    dev = require_cuda()
    dt = 0.1
    X, U, rgp = trajectory_inputs(256, seed=3)
    f = make_mpc_dynamics(port_params().map(lambda a: a.float().to(dev)))
    aug = fold_drag(interop.rgp_state_from_numpy(rgp, device=dev, dtype=torch.float32)).map(
        lambda a: a.contiguous())
    Xc, Uc = t(X).float().to(dev), t(U).float().to(dev)
    xp, J = lin_kernel.linearize(Xc, Uc, aug, f, dt)
    xp_p, J_p = lin_kernel.linearize_plain(f, Xc, Uc, aug, dt)
    # f32: positions ~10 m (ulp 1e-6) through 4 RK4 stages; J entries ~10
    assert (xp - xp_p).abs().max() <= 1e-5
    assert (J - J_p).abs().max() <= 1e-4
    with pytest.raises(TypeError):
        lin_kernel.linearize(Xc.double(), Uc.double(), aug.map(lambda a: a.double()), f, dt)


# ---------------------------------------------------------------- E

@pytest.fixture(scope="module")
def box_qp_step():
    """(H, g, lb, ub) of 6 scenarios at N=5, and the plain cold solve's duals."""
    inp = gn_step_inputs(6, seed=61, N=5)
    H, g = condense_from_J(*(inp[k] for k in ("J", "r", "dx0", "ex0")),
                           *inp["solver"].cfg.weight_tuples())
    box = (H, g + inp["gu"], inp["lb"], inp["ub"])
    _, zl, zu = qp_kernel.ipm_box_solve(*box, ITERS)
    return box, (zl, zu)


@pytest.mark.parametrize("warm", [False, True])
def test_cuda_qp_kernel_matches_f64_plain(box_qp_step, warm):
    dev = require_cuda()
    box, duals = box_qp_step
    duals = duals if warm else (None, None)
    z_d, _, _ = qp_kernel.ipm_box_solve(*box, ITERS, *duals)
    f32 = lambda a: None if a is None else a.float().to(dev)
    z, zl, zu = qp_kernel.solve_box_qp_pdip_batch(*map(f32, box), ITERS, *map(f32, duals))
    assert (z.double().cpu() - z_d).abs().max() < 4e-2      # the f32 12-iteration floor
    assert torch.isfinite(zl).all() and (zl > 0).all() and (zu > 0).all()


def test_cuda_qp_kernel_refuses_past_its_ceiling():
    """232,448 B a block holds kernel E's one-warp block up to nz = 229 (its
    ceiling was 214 before its matrix and strip table were laid out anew):
    it runs there and at 214, and refuses 230 and 300."""
    dev = require_cuda()
    for nz in (214, 229):
        H = torch.eye(nz, device=dev).expand(2, nz, nz).contiguous()
        v = torch.zeros(2, nz, device=dev)
        z, zl, zu = qp_kernel.solve_box_qp_pdip_batch(H, v, v - 1, v + 1, ITERS)
        torch.cuda.synchronize()
        assert torch.isfinite(z).all() and z.abs().max() < 1e-3 and (zl > 0).all()
    for nz in (230, 300):
        H = torch.eye(nz, device=dev).expand(2, nz, nz).contiguous()
        v = torch.zeros(2, nz, device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            qp_kernel.solve_box_qp_pdip_batch(H, v, v - 1, v + 1, ITERS)


# ---------------------------------------------------------------- C

def test_cuda_riccati_kernel_matches_f64_plain():
    dev = require_cuda()
    args = riccati_kernel_inputs(random_ocp(256, 40, seed=7))
    du_d, dX_d = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, Q, PT, RD, ITERS)
    du, dX = riccati_kernel.riccati_ipm_from_J(*(a.float().to(dev) for a in args),
                                               Q, PT, RD, ITERS)
    # f32 rounding through 12 iterations (measured 1.6e-6 on an H100);
    # the JAX package pins its f32 kernel at 1e-3 of the converged truth
    assert (du.double().cpu() - du_d).abs().max() < 1e-4
    assert (dX.double().cpu() - dX_d).abs().max() < 1e-4


def test_cuda_kernel_b_refuses_past_its_ceiling():
    dev = require_cuda()
    B, N = 4, sqp.FUSED_N_MAX + 1
    nz = 4 * N
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="FUSED_N_MAX"):
        sqp_fused_kernel.fused_sqp_from_J(z(B, N, 17, 13), z(B, N, 13), z(B, 13),
                                          z(B, N + 1, 13), z(B, nz), z(B, nz), z(B, nz) + 1,
                                          Q, PT, RD, ITERS)


# ---------------------------------------------------------------- B

@pytest.fixture(scope="module")
def fused_step():
    """Kernel B's inputs of 5 scenarios at N=10 and its weights: an odd count,
    so that the last block's second warp has no scenario."""
    inp = gn_step_inputs(5, seed=11)
    args = [inp[k] for k in ("J", "r", "dx0", "ex0", "gu", "lb", "ub")]
    return args, inp["solver"].cfg.weight_tuples()


@pytest.mark.parametrize("warm", [False, True])
def test_cuda_sqp_fused_kernel_matches_f64_plain(fused_step, warm):
    dev = require_cuda()
    args, (q, p, rw) = fused_step
    duals = (sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, ITERS)[3:]
             if warm else None)
    z_d, dX_d, kkt_d, zl_d, zu_d = sqp_fused_kernel.fused_sqp_from_J_plain(
        *args, q, p, rw, ITERS, duals)
    f32 = lambda a: a.float().to(dev)
    z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_from_J(
        *map(f32, args), q, p, rw, ITERS, duals=None if duals is None else tuple(map(f32, duals)))
    # the 12-iteration f32 IPM floor on z; on the max KKT, 1e-3 over the
    # oracle's.  Warm-started from the duals of the same QP the f64 oracle
    # converges (max KKT ~1e-6), and the f32 KKT sits at its own rounding
    # floor: terms of Hz + g reach ~1e4, and an H100 run of kernel B at
    # B=65536 read 2.9e-3 over the scenarios the f64 oracle solves to 1e-4.
    floor = 3e-3 if warm else 0.0
    assert (z.double().cpu() - z_d).abs().max() < 4e-2
    assert kkt.max().item() <= max(kkt_d.max().item(), floor) + 1e-3
    assert torch.isfinite(zl).all() and (zl > 0).all() and (zu > 0).all()


# ---------------------------------------------------------------- the wrappers' checks

def test_cuda_wrappers_refuse_other_inputs():
    """What reaches a kernel is checked first: dtype, then device."""
    x = torch.zeros(2, 11, 13, dtype=torch.float64)
    with pytest.raises(TypeError):
        _build.check_cuda_inputs("k", {"X": x}, {"X": (2, 11, 13)})
    with pytest.raises(ValueError):
        _build.check_cuda_inputs("k", {"X": x.float()}, {"X": (2, 11, 13)})
    with pytest.raises(RuntimeError):
        _build.check_status("k", 700)
