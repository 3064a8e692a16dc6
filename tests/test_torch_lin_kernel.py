"""Kernel A (RK4 linearisation, ``ops/cuda/lin_kernel.py``) on the CPU.

- Its plain PyTorch version against the JAX package's ``SQPSolver._linearize``
  (jacfwd through the RK4 step of ``make_mpc_dynamics``) with the per-scenario
  folded RGP drag, float64, to 1e-12 absolute: both differentiate the same
  formulas, so only rounding differs (J entries are O(10)).
- The kernel's own source (``csrc/lin_kernel.cu``) built with g++ for the host
  in float64, against the plain version to 1e-12: the same model run on dual
  numbers, with the drag's diagonal-Jacobian rule.
- On a CUDA device: ``test_torch_cuda_kernels.py`` (JAX-free, so that it
  collects on the GPU host)."""

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

from test_torch_common import (N, host_library, jax_params, jax_rgp, port_params, t,
                               trajectory_inputs)

B = 6
DT = 0.1


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


def _plain(X, U, rgp):
    aug = None if rgp is None else fold_drag(interop.rgp_state_from_numpy(rgp)).map(
        lambda a: a.contiguous())
    return lin_kernel.linearize(t(X), t(U), aug, make_mpc_dynamics(port_params()), DT), aug


@pytest.mark.parametrize("with_aug", [True, False])
def test_plain_matches_jax_linearize(with_aug):
    X, U, rgp = trajectory_inputs(B, seed=1)
    (xp, J), _ = _plain(X, U, rgp if with_aug else None)
    solver = JaxSolver(JaxConfig(), jax_model(jax_params()))
    aug = jax_fold_drag(jax_rgp(rgp)) if with_aug else None
    if with_aug:
        A, Bm, r = jax.jit(jax.vmap(solver._linearize))(jnp.asarray(X), jnp.asarray(U), aug)
    else:
        A, Bm, r = jax.jit(jax.vmap(lambda x, u: solver._linearize(x, u, None)))(
            jnp.asarray(X), jnp.asarray(U))
    np.testing.assert_allclose(J[..., :13, :].mT.numpy(), np.asarray(A), rtol=0, atol=1e-12)
    np.testing.assert_allclose(J[..., 13:, :].mT.numpy(), np.asarray(Bm), rtol=0, atol=1e-12)
    np.testing.assert_allclose((xp - t(X)[:, 1:]).numpy(), np.asarray(r), rtol=0, atol=1e-12)
    if with_aug:   # the drag really acts: the model differs from the nominal one
        (xp0, _), _ = _plain(X, U, None)
        assert (xp - xp0).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_aug", [True, False])
def test_plain_versions_agree_bitwise(monkeypatch, dtype, with_aug):
    """The one-pass forward-AD version (up to ONE_PASS_MAX_STAGES pairs) and
    the vmapped ``jvp`` (past it) give the same bits, a NaN scenario's too."""
    X, U, rgp = trajectory_inputs(B, seed=3)
    X[2, 4, 5] = np.nan
    aug = None if not with_aug else fold_drag(interop.rgp_state_from_numpy(rgp)).map(
        lambda a: a.to(dtype).contiguous())
    p = port_params().map(lambda a: a.to(dtype) if a.is_floating_point() else a)
    args = (make_mpc_dynamics(p), t(X).to(dtype), t(U).to(dtype), aug, DT)
    assert B * N <= lin_kernel.ONE_PASS_MAX_STAGES
    one = lin_kernel.linearize_plain(*args)
    monkeypatch.setattr(lin_kernel, "ONE_PASS_MAX_STAGES", 0)
    vmapped = lin_kernel.linearize_plain(*args)
    for a, b in zip(one, vmapped):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(a.isnan(), b.isnan())
    assert one[1][2].isnan().any() and not one[1][:2].isnan().any()


@pytest.mark.parametrize("with_aug", [True, False])
def test_kernel_source_on_host_matches_plain(host_lib, with_aug):
    X, U, rgp = trajectory_inputs(B, seed=2)
    (xp, J), aug = _plain(X, U, rgp if with_aug else None)
    consts = torch.tensor(lin_kernel.model_constants(port_params(), DT), dtype=torch.float64)
    Xt, Ut = t(X), t(U)
    xp_h, J_h = torch.empty_like(xp), torch.empty(J.shape, dtype=J.dtype)
    ptrs = ([a.data_ptr() for a in (aug.X, aug.w, aug.L, aug.sigma_f)] if with_aug
            else [None] * 4)
    rc = host_lib.mpcq_lin_host_f64(Xt.data_ptr(), Ut.data_ptr(), *ptrs,
                                    aug.X.shape[-1] if with_aug else 0,
                                    xp_h.data_ptr(), J_h.data_ptr(), B, N, consts.data_ptr())
    assert rc == 0
    np.testing.assert_allclose(xp_h.numpy(), xp.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(J_h.numpy(), J.numpy(), rtol=0, atol=1e-12)


def test_model_constants_match_jax_kernel_scalars():
    """The POD struct carries what the JAX kernel's _make_f bakes in."""
    jp = jax_params()
    c = lin_kernel.model_constants(port_params(), DT)
    kt = np.asarray(jp.rotor_functionality) * float(jp.max_thrust)
    np.testing.assert_array_equal(c[:4], kt)
    assert c[16] == 1.0 / float(jp.mass)
    assert c[18] == -(float(jp.payload_mass) / float(jp.mass)) * float(jp.g[2])
    assert c[25:] == [DT, DT / 2, DT / 6]
