"""The port's recursive GP (``mpc_quad_ros_tpu_torch/models/rgp.py``) against
the JAX package's, CPU, float64: prediction with its covariance, prediction
from an external basis response, ``rgp_init`` with a prior mean and
covariance, the Kalman update (k = 1 and 3, symmetrised or not), the
eigendecomposition square root and a 50-sample stream of the joint basis
and hyperparameter learner, each to 1e-12 of the largest entry.  The
states are the JAX package's (handed over as numpy by ``interop``), so only
the function under test differs; the port broadcasts over a leading (3,)
axis where the JAX package vmaps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models import rgp as jrgp
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import rgp as trgp

from test_torch_common import as_numpy, t

NB = 8
THETA = (2.0, 0.5, 0.3)
TOL = 1e-12


def rel(a, b) -> float:
    """Largest difference over the largest entry of the reference."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny))


def jax_states(seed: int = 0):
    """Three per-axis RGP states (basis over +-5, a random prior mean and a
    random SPD covariance) from the JAX rgp_init, stacked over axes."""
    rng = np.random.default_rng(seed)
    X = np.linspace(-5.0, 5.0, NB) + 0.1 * rng.standard_normal((3, NB))
    y = rng.standard_normal((3, NB))
    A = rng.standard_normal((3, NB, NB))
    C = A @ np.swapaxes(A, -1, -2) / NB + 0.1 * np.eye(NB)
    return jax.vmap(lambda X_, y_, C_: jrgp.rgp_init(X_, y_, C_, theta=THETA))(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(C))


def port_state(js):
    return interop.rgp_state_from_numpy(as_numpy(js))


def test_rgp_init_with_prior_mean_and_covariance():
    rng = np.random.default_rng(1)
    X = np.linspace(-5.0, 5.0, NB)
    y = rng.standard_normal(NB)
    A = rng.standard_normal((NB, NB))
    C = A @ A.T
    for args in ((None, None), (y, None), (y, C)):
        ref = jrgp.rgp_init(jnp.asarray(X), *(None if a is None else jnp.asarray(a) for a in args),
                            theta=THETA)
        out = trgp.rgp_init(t(X), *(None if a is None else t(a) for a in args), theta=THETA)
        for k in ("X", "mu_g", "C_g", "K_x_inv", "theta"):
            assert rel(getattr(out, k), getattr(ref, k)) <= TOL, k


def test_rgp_predict_with_cov():
    js = jax_states()
    xs = np.random.default_rng(2).uniform(-6.0, 6.0, (3, 5))
    mu, C_p, Jt = jax.vmap(lambda s, x: jrgp.rgp_predict(s, x, with_cov=True))(js, jnp.asarray(xs))
    tmu, tC, tJ = trgp.rgp_predict(port_state(js), t(xs), with_cov=True)
    for a, b in ((tmu, mu), (tC, C_p), (tJ, Jt)):
        assert rel(a, b) <= TOL
    assert rel(trgp.ensemble_predict(port_state(js), t(xs)), jrgp.ensemble_predict(js, jnp.asarray(xs))) <= TOL
    K = trgp.rgp_kernel_matrix(port_state(js), t(xs), t(xs))
    assert rel(K, jax.vmap(jrgp.rgp_kernel_matrix)(js, jnp.asarray(xs), jnp.asarray(xs))) <= TOL


def test_rgp_predict_using_y():
    js = jax_states(3)
    rng = np.random.default_rng(3)
    xs, y = rng.uniform(-6.0, 6.0, (3, 4)), rng.standard_normal((3, NB))
    ref = jrgp.ensemble_predict_using_y(js, jnp.asarray(xs), jnp.asarray(y))
    assert rel(trgp.rgp_predict_using_y(port_state(js), t(xs), t(y)), ref) <= TOL
    assert rel(trgp.rgp_gain(port_state(js), t(xs)), jax.vmap(jrgp.rgp_gain)(js, jnp.asarray(xs))) <= TOL


@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_rgp_regress(k, symmetrize):
    js = jax_states(4)
    rng = np.random.default_rng(4)
    x_t, y_t = rng.uniform(-5.0, 5.0, (3, k)), rng.standard_normal((3, k))
    ref = jax.vmap(lambda s, x, y: jrgp.rgp_regress(s, x, y, symmetrize=symmetrize))(
        js, jnp.asarray(x_t), jnp.asarray(y_t))
    out = trgp.rgp_regress(port_state(js), t(x_t), t(y_t), symmetrize=symmetrize)
    for name in ("mu_g", "C_g"):
        assert rel(getattr(out, name), getattr(ref, name)) <= TOL, name
    if symmetrize:
        np.testing.assert_array_equal(out.C_g.numpy(), np.swapaxes(out.C_g.numpy(), -1, -2))


def test_sqrtm_psd():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 3, 3))
    C = A @ np.swapaxes(A, -1, -2)
    C[0] = np.diag([2.0, 1.0, 0.0]) - 1e-13 * np.eye(3)     # one eigenvalue clipped
    S = trgp._sqrtm_psd(t(C))
    assert rel(S, jax.vmap(jrgp._sqrtm_psd)(jnp.asarray(C))) <= TOL
    assert rel(S[1:] @ S[1:], C[1:]) <= TOL


def test_rgp_learn_stream_of_50_samples():
    """50 scalar samples of a noisy sine through the learner, the 3 axes at
    once (JAX: vmapped), from the JAX package's prior of each axis."""
    js = jax.vmap(lambda X_: jrgp.rgp_init(X_, theta=THETA))(
        jnp.asarray(np.stack([np.linspace(-5.0, 5.0, NB)] * 3)))
    ref = jax.vmap(jrgp.rgp_learn_init)(js)
    out = trgp.rgp_learn_init(port_state(js))
    for name in ("mu_eta", "C_eta", "C_g_eta"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    rng = np.random.default_rng(6)
    xs = rng.uniform(-5.0, 5.0, (50, 3, 1))
    ys = np.sin(xs) + 0.1 * rng.standard_normal(xs.shape)
    learn = jax.jit(jax.vmap(jrgp.rgp_learn))
    for x, y in zip(xs, ys):
        ref = learn(ref, jnp.asarray(x), jnp.asarray(y))
        out = trgp.rgp_learn(out, t(x), t(y))
    for name in ("mu_g", "C_g", "K_x_inv", "theta"):
        assert rel(getattr(out.base, name), getattr(ref.base, name)) <= TOL, name
    for name in ("mu_eta", "C_eta"):
        assert rel(getattr(out, name), getattr(ref, name)) <= TOL, name
    # the reference's quirk: the cross-covariance is never updated
    np.testing.assert_array_equal(out.C_g_eta.numpy(), np.zeros((3, NB, 3)))
    assert np.isfinite(out.base.mu_g.numpy()).all()
    # the learn state crosses over from the JAX package too
    back = interop.rgp_learn_state_from_numpy(
        {**{k: np.asarray(v) for k, v in ref._asdict().items() if k != "base"},
         "base": as_numpy(ref.base)})
    np.testing.assert_array_equal(back.base.C_g.numpy(), np.asarray(ref.base.C_g))


def test_ensemble_init():
    ranges = [(-3.0, 3.0), (-5.0, 4.0), (-1.0, 2.0)]
    ref = jrgp.ensemble_init(ranges, NB, theta=THETA, dtype=jnp.float64)
    out = trgp.ensemble_init(ranges, NB, theta=THETA, dtype=torch.float64)
    for name in ("X", "mu_g", "C_g", "K_x_inv", "theta"):
        assert rel(getattr(out, name), getattr(ref, name)) <= TOL, name
