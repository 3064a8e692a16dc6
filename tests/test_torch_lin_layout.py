"""Kernel A's block layout (``csrc/lin_kernel.cu``) on the CPU, float64.

- The kernel's own source built with g++ for the host runs the card's
  partition: tiles of 128 columns, in each tile the primal step of every
  column (one thread a column, what the tangents read recorded per RK4
  stage), x+ out through each warp's stage buffer, then the tile's 128 x 17
  (column, tangent) items in rounds of its 128 threads, each warp's 32 rows
  of J out through its stage buffer.  B = 24 scenarios at N = 7: 168
  columns, two tiles, the second one ragged, scenario 18 across the
  boundary.
- Against the plain version (``torch.func`` jvp of the RK4 step) without
  drag and with the folded RGP drag at nb = 10 and 20 (nb = 0 is the model
  without drag): xp and J to 1e-9 (the same formulas; measured ~1e-15).
- Against the JAX package's linearisation (``SQPSolver._linearize``: jacfwd
  through the RK4 step of ``make_mpc_dynamics``, the reference of the
  Pallas ``_lin_kernel``, whose interpret mode takes ~40 s a call here):
  xp and J to 1e-9.
- NaN isolation: one scenario's trajectory poisoned (the one across the
  tiles' boundary) leaves every other scenario's xp and J bitwise unchanged.
- Tiles of 32 and 64 columns (the card's width for batches that fill less
  than a wave of it at 128): bitwise the tiles of 128.
- The recorded pass against the dual pass it takes apart (one lin_item a
  (column, tangent), the primal recomputed in each, as kernel F walks them):
  xp and J bitwise.
- The block's shared memory: 9,984 floats (the records of 128 columns, 65
  floats each, and four stage buffers of 32 x 13)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.augmented import fold_drag as jax_fold_drag
from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics as jax_model
from mpc_quad_ros_tpu.ops import MPCConfig as JaxConfig
from mpc_quad_ros_tpu.ops import SQPSolver as JaxSolver
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.cuda import lin_kernel

from test_torch_common import (host_library, jax_params, jax_rgp, port_params, ptr, rgp_batch, t,
                               trajectory_inputs)

B, N, BAD = 24, 7, 18
DT = 0.1
NBS = (0, 10, 20)          # basis vectors per axis; 0: no drag


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


@pytest.fixture(scope="module", params=NBS, ids=lambda nb: f"nb{nb}")
def case(request):
    nb = request.param
    X, U, _ = trajectory_inputs(B, seed=60 + nb, N=N)
    rgp = rgp_batch(B, np.random.default_rng(70 + nb), nb=nb) if nb else None
    aug = (fold_drag(interop.rgp_state_from_numpy(rgp)).map(lambda a: a.contiguous())
           if rgp else None)
    return dict(X=X, U=U, rgp=rgp, aug=aug, nb=nb)


def _host(lib, X, U, aug, entry="mpcq_lin_host_f64", *extra):
    X, U = t(X).contiguous(), t(U).contiguous()
    consts = torch.tensor(lin_kernel.model_constants(port_params(), DT), dtype=torch.float64)
    xp = torch.empty((B, N, 13), dtype=torch.float64)
    J = torch.empty((B, N, 17, 13), dtype=torch.float64)
    leaves = (aug.X, aug.w, aug.L, aug.sigma_f) if aug is not None else (None,) * 4
    nb = aug.X.shape[-1] if aug is not None else 0
    rc = getattr(lib, entry)(ptr(X), ptr(U), *map(ptr, leaves), nb, ptr(xp), ptr(J), B, N,
                             ptr(consts), *extra)
    assert rc == 0
    return xp, J


def test_host_blocks_match_plain(host_lib, case):
    xp, J = _host(host_lib, case["X"], case["U"], case["aug"])
    xp_p, J_p = lin_kernel.linearize(t(case["X"]), t(case["U"]), case["aug"],
                                     make_mpc_dynamics(port_params()), DT)
    np.testing.assert_allclose(xp.numpy(), xp_p.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(J.numpy(), J_p.numpy(), rtol=0, atol=1e-9)
    if case["nb"]:    # the drag really acts on this trajectory
        xp0, _ = _host(host_lib, case["X"], case["U"], None)
        assert (xp - xp0).abs().max() > 1e-3


def test_host_blocks_match_jax(host_lib, case):
    xp, J = _host(host_lib, case["X"], case["U"], case["aug"])
    solver = JaxSolver(JaxConfig(), jax_model(jax_params()))
    X, U = jnp.asarray(case["X"]), jnp.asarray(case["U"])
    if case["rgp"] is not None:
        A, Bm, r = jax.jit(jax.vmap(solver._linearize))(X, U, jax_fold_drag(jax_rgp(case["rgp"])))
    else:
        A, Bm, r = jax.jit(jax.vmap(lambda x, u: solver._linearize(x, u, None)))(X, U)
    np.testing.assert_allclose(J[..., :13, :].mT.numpy(), np.asarray(A), rtol=0, atol=1e-9)
    np.testing.assert_allclose(J[..., 13:, :].mT.numpy(), np.asarray(Bm), rtol=0, atol=1e-9)
    np.testing.assert_allclose((xp - t(case["X"])[:, 1:]).numpy(), np.asarray(r), rtol=0,
                               atol=1e-9)


def test_host_blocks_nan_isolated(host_lib, case):
    xp, J = _host(host_lib, case["X"], case["U"], case["aug"])
    X_bad = case["X"].copy()
    X_bad[BAD, 3, 4] = np.nan      # qx: J depends on it with or without drag
    xp_b, J_b = _host(host_lib, X_bad, case["U"], case["aug"])
    keep = torch.arange(B) != BAD
    assert torch.isnan(xp_b[BAD, 3]).any() and torch.isnan(J_b[BAD, 3]).any()
    assert torch.equal(xp_b[keep], xp[keep]) and torch.equal(J_b[keep], J[keep])
    # the poisoned scenario's other stages keep their values
    assert torch.equal(J_b[BAD, :3], J[BAD, :3]) and torch.equal(J_b[BAD, 4:], J[BAD, 4:])


def test_recorded_pass_matches_dual_pass_bitwise(host_lib, case):
    xp, J = _host(host_lib, case["X"], case["U"], case["aug"])
    xp_d, J_d = _host(host_lib, case["X"], case["U"], case["aug"], "mpcq_lin_dual_host_f64")
    assert torch.equal(xp.view(torch.int64), xp_d.view(torch.int64))
    assert torch.equal(J.view(torch.int64), J_d.view(torch.int64))


@pytest.mark.parametrize("cols", [32, 64])
def test_tile_widths_agree_bitwise(host_lib, case, cols):
    xp, J = _host(host_lib, case["X"], case["U"], case["aug"])
    xp_c, J_c = _host(host_lib, case["X"], case["U"], case["aug"], "mpcq_lin_tiles_host_f64",
                      cols)
    assert torch.equal(xp.view(torch.int64), xp_c.view(torch.int64))
    assert torch.equal(J.view(torch.int64), J_c.view(torch.int64))


def test_block_shared_memory(host_lib):
    """128 columns a block: the 4 RK4 stages' state (q, v, w: 40 floats), a_m,
    and 4 stages x (m, jd) = 24 floats a column, and a stage buffer of 32 x
    13 floats a warp: 9,984 floats, 39,936 B (an H100 SM holds 5 such blocks
    by shared memory, with 1 KB of its own a block)."""
    cols, warps = 128, 4
    assert host_lib.mpcq_lin_ws_bytes(N) == 4 * (cols * (40 + 1 + 24) + warps * 32 * 13) == 39_936
    assert 5 * (39_936 + 1024) <= 233_472 < 6 * (39_936 + 1024)
