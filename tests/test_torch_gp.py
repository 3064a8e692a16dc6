"""The port's exact GP (``mpc_quad_ros_tpu_torch/models/gp.py``) and the
learned-drag model (``models/augmented.py``) against the JAX package's, CPU,
float64.

- ``gp_init``, ``gp_predict`` (with its covariance): 1e-12 of the largest
  entry (K^-1 and alpha 1e-10, the covariance 1e-12 of the magnitudes it is
  the difference of), the 3 axes at once (JAX: vmapped);
- ``gp_nll`` and its gradient (``torch.autograd`` against
  ``jax.value_and_grad``) at fixed theta: 1e-10 relative;
- ``gp_fit`` (scipy's L-BFGS-B on either package's gradients): the fitted
  theta to 1e-6 relative and the NLL at the optimum to 1e-9 relative, on
  synthetic drag samples y = -0.42 v|v| + noise, where most fits end with
  the noise at its 0.01 bound and sigma_f at 20-45;
- ``fold_drag``, ``gp_mean_world`` and the MPC model for the RGP, the GP and
  the folded state: 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models import augmented as jaug
from mpc_quad_ros_tpu.models import gp as jgp
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import augmented as taug
from mpc_quad_ros_tpu_torch.models import gp as tgp

from test_torch_common import (as_numpy, jax_params, jax_rgp, port_params, require_cuda,
                               rgp_batch, t, trajectory_inputs)

THETA = np.array([[2.5, 3.0, 0.05], [1.5, 2.0, 0.2], [4.0, 10.0, 0.01]])


def rel(a, b) -> float:
    """Largest difference over the largest entry of the reference."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny))


def drag_samples(seed: int, n: int = 10, noise: float = 0.1):
    """n synthetic quadratic-drag samples per axis (3, n) on +-8 m/s."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-8.0, 8.0, (3, n))
    return X, -0.42 * X * np.abs(X) + noise * rng.standard_normal((3, n))


def jax_gp_states(seed: int = 0):
    X, y = drag_samples(seed)
    return jgp.ensemble_gp_init(jnp.asarray(X), jnp.asarray(y), jnp.asarray(THETA))


def test_gp_init_and_predict_with_cov():
    X, y = drag_samples(0)
    ref = jax_gp_states(0)
    out = tgp.ensemble_gp_init(t(X), t(y), t(THETA))
    for name in ("X", "y", "theta"):
        assert rel(getattr(out, name), getattr(ref, name)) <= 1e-12, name
    # K + (noise + 1e-7) I with the noise at 0.01 is ill-conditioned (~1e4):
    # two LU inverses agree to ~1e-12 of K^-1's largest entry times that
    for name in ("alpha", "K_inv"):
        assert rel(getattr(out, name), getattr(ref, name)) <= 1e-10, name
    # the prediction from the very same state
    st = interop.gp_state_from_numpy(as_numpy(ref))
    xs = np.random.default_rng(1).uniform(-9.0, 9.0, (3, 6))
    mu, cov = jax.vmap(lambda s, x: jgp.gp_predict(s, x, with_cov=True))(ref, jnp.asarray(xs))
    tmu, tcov = tgp.gp_predict(st, t(xs), with_cov=True)
    assert rel(tmu, mu) <= 1e-12
    # the covariance is k** - k*^T K^-1 k*, a small difference of terms of
    # the prior's size: held to 1e-12 of the sum of their magnitudes
    k_s = np.abs(tgp.rbf(st.X, t(xs), st.theta[:, 0, None, None], st.theta[:, 1, None, None]).numpy())
    scale = (np.swapaxes(k_s, -1, -2) @ np.abs(st.K_inv.numpy()) @ k_s).max()
    assert np.abs(tcov.numpy() - np.asarray(cov)).max() <= 1e-12 * scale
    assert rel(tgp.ensemble_gp_predict(st, t(xs)), jgp.ensemble_gp_predict(ref, jnp.asarray(xs))) <= 1e-12


@pytest.mark.parametrize("d", [0, 1, 2])
def test_gp_nll_and_gradient(d):
    X, y = drag_samples(2)
    th = THETA[d]
    v, g = jax.value_and_grad(lambda th_: jgp.gp_nll(jnp.asarray(X[d]), jnp.asarray(y[d]), th_))(
        jnp.asarray(th))
    th_t = torch.tensor(th, requires_grad=True)
    tv = tgp.gp_nll(t(X[d]), t(y[d]), th_t)
    (tg,) = torch.autograd.grad(tv, th_t)
    assert rel(tv.detach(), v) <= 1e-10
    assert rel(tg, g) <= 1e-10


@pytest.mark.parametrize("seed,noise", [(0, 0.1), (6, 0.01)])
def test_gp_fit_matches_jax(seed, noise):
    """Both fits start at (1, 1, 1) and follow the same L-BFGS-B iterates;
    seed 6 ends with the noise at its lower bound (0.01) on every axis,
    seed 0 on the first."""
    X, y = drag_samples(seed, noise=noise)
    for d in range(3):
        ref = jgp.gp_fit(jnp.asarray(X[d]), jnp.asarray(y[d]))
        out = tgp.gp_fit(t(X[d]), t(y[d]))
        assert rel(out.theta, ref.theta) <= 1e-6, (d, out.theta, ref.theta)
        nll = tgp.gp_nll(t(X[d]), t(y[d]), out.theta)
        nll_ref = jgp.gp_nll(jnp.asarray(X[d]), jnp.asarray(y[d]), ref.theta)
        assert rel(nll, nll_ref) <= 1e-9, d
        assert out.theta.min() >= 0.01
        if seed == 6 or d == 0:
            assert float(out.theta[2]) == 0.01


def test_ensemble_gp_fit_stacks_the_axes():
    X, y = drag_samples(0, n=6)
    out = tgp.ensemble_gp_fit(t(X), t(y))
    assert out.alpha.shape == (3, 6) and out.K_inv.shape == (3, 6, 6)
    for d in range(3):
        one = tgp.gp_fit(t(X[d]), t(y[d]))
        assert torch.equal(out.theta[d], one.theta) and torch.equal(out.alpha[d], one.alpha)


def aug_states():
    """The three drag records of one batch of 2 scenarios: the RGP (the
    shared test inputs), the GP (fixed theta) and the GP folded."""
    rgp = rgp_batch(2, np.random.default_rng(7))
    X, y = drag_samples(8)
    gp = jax_gp_states(8)
    gp = {k: np.broadcast_to(v, (2,) + v.shape).copy() for k, v in as_numpy(gp).items()}
    return rgp, gp


@pytest.mark.parametrize("kind", ["rgp", "gp", "folded_gp"])
def test_fold_drag_gp_mean_world_and_model(kind):
    rgp, gp = aug_states()
    if kind == "rgp":
        jstate, tstate = jax_rgp(rgp), interop.rgp_state_from_numpy(rgp)
    else:
        jstate = jgp.GPState(**{k: jnp.asarray(v) for k, v in gp.items()})
        tstate = interop.gp_state_from_numpy(gp)
    jf, tf = jaug.fold_drag(jstate), taug.fold_drag(tstate)
    for name in ("X", "w", "L", "sigma_f"):
        assert rel(getattr(tf, name), getattr(jf, name)) <= 1e-12, name
    if kind == "folded_gp":
        jstate, tstate = jf, tf
    # the JAX branches take one scenario (x (13,), state (3, ...)); the
    # port's broadcast over the batch and a stage axis
    X, U, _ = trajectory_inputs(2, seed=9)
    one = lambda b: jax.tree.map(lambda a: a[b], jstate)
    ref = np.stack([jaug.gp_mean_world(jnp.asarray(X[b, 0]), one(b)) for b in range(2)])
    out = taug.gp_mean_world(t(X[:, :1]), tstate.map(lambda a: a[:, None]))[:, 0]
    assert rel(out, ref) <= 1e-12
    jfn, f = jaug.make_mpc_dynamics(jax_params()), taug.make_mpc_dynamics(port_params())
    ref_f = np.stack([jfn(jnp.asarray(X[b, 0]), jnp.asarray(U[b, 0]), one(b)) for b in range(2)])
    assert rel(f(t(X[:, 0]), t(U[:, 0]), tstate), ref_f) <= 1e-12


def test_fold_drag_passes_other_records_through():
    assert taug.fold_drag(None) is None
    other = object()
    assert taug.fold_drag(other) is other
    with pytest.raises(TypeError, match="augmentation"):
        taug.gp_mean_world(torch.zeros(13, dtype=torch.float64), other)


def test_gp_fit_on_cuda_matches_cpu():
    """The fit on the card (float64, one host transfer an evaluation)
    against the CPU's."""
    dev = require_cuda()
    X, y = drag_samples(0)
    for d in range(3):
        cpu = tgp.gp_fit(t(X[d]), t(y[d]))
        card = tgp.gp_fit(t(X[d]).to(dev), t(y[d]).to(dev))
        assert card.theta.device.type == "cuda"
        assert rel(card.theta.cpu(), cpu.theta) <= 1e-6
