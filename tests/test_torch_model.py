"""The port's model layer against the JAX package, float64 on the CPU:
rotations, dynamics, the RGP and the folded drag.  Tolerance 1e-12 (the
golden-log bound of tests/test_dynamics.py) unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models import augmented as jaug
from mpc_quad_ros_tpu.models import dynamics as jdyn
from mpc_quad_ros_tpu.models import rgp as jrgp
from mpc_quad_ros_tpu.utils import rotations as jrot
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import augmented as taug
from mpc_quad_ros_tpu_torch.models import dynamics as tdyn
from mpc_quad_ros_tpu_torch.models import rgp as trgp
from mpc_quad_ros_tpu_torch.utils import rotations as trot

from test_torch_common import as_numpy, jax_params, jax_rgp, port_params, rgp_batch, t

TOL = 1e-12
RNG = np.random.default_rng(7)
# non-unit quaternions on purpose: neither package renormalises
Q = RNG.standard_normal((6, 4))
V = RNG.standard_normal((6, 3))
X = np.concatenate([RNG.standard_normal((6, 3)), Q, 3 * RNG.standard_normal((6, 3)),
                    RNG.standard_normal((6, 3))], axis=1)
U = RNG.uniform(0.0, 1.0, (6, 4))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), a.numpy() if torch.is_tensor(a) else a,
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name, args", [
    ("q_to_rot_mat", (Q,)), ("v_dot_q", (V, Q)), ("quaternion_inverse", (Q,)),
    ("quaternion_derivative", (Q, V)),
])
def test_rotations(name, args):
    close(getattr(trot, name)(*map(t, args)), getattr(jrot, name)(*map(jnp.asarray, args)))


def _batched_params():
    """Per-row randomised drag, as the closed loop's plant sees it."""
    jp = jax_params()
    s = RNG.uniform(0.5, 2.0, (2, 6))
    jb = {k: np.broadcast_to(v, (6,) + v.shape).copy() for k, v in as_numpy(jp).items()}
    jb["aero_drag"] = jb["aero_drag"] * s[0]
    jb["rotor_drag"] = jb["rotor_drag"] * s[1][:, None]
    return jp._replace(**{k: jnp.asarray(v) for k, v in jb.items()}), interop.quad_params_from_numpy(jb)


@pytest.mark.parametrize("name", ["f_nominal", "f_with_drag"])
@pytest.mark.parametrize("batched", [False, True])
def test_continuous_dynamics(name, batched):
    if batched:
        jp, tp = _batched_params()
    else:
        jp, tp = jax_params(), port_params()
    close(getattr(tdyn, name)(t(X), t(U), tp), getattr(jdyn, name)(jnp.asarray(X), jnp.asarray(U), jp))


def test_payload_quirk():
    """-(payload_mass / mass) g is added to v̇ as in the reference."""
    jp = jax_params()._replace(payload_mass=jnp.asarray(0.3))
    tp = port_params().replace(payload_mass=torch.tensor(0.3, dtype=torch.float64))
    close(tdyn.f_nominal(t(X), t(U), tp), jdyn.f_nominal(jnp.asarray(X), jnp.asarray(U), jp))


def test_rk4_step_no_renormalisation():
    jp, tp = jax_params(), port_params()
    out = tdyn.rk4_step(lambda x, u: tdyn.f_nominal(x, u, tp), t(X), t(U), 0.1)
    ref = jdyn.rk4_step(lambda x, u: jdyn.f_nominal(x, u, jp), jnp.asarray(X), jnp.asarray(U), 0.1)
    close(out, ref)
    assert not np.allclose(np.linalg.norm(out.numpy()[:, 3:7], axis=1), 1.0)


def test_plant_substeps():
    jp, tp = _batched_params()
    u = U * 1.4 - 0.2                               # some controls outside [0, 1]: clipped
    out = tdyn.plant_substeps(t(X), t(u), tp, 0.005, 20)
    import jax

    ref = jax.vmap(lambda x, uu, p: jdyn.plant_substeps(x, uu, p, 0.005, 20))(
        jnp.asarray(X), jnp.asarray(u), jp)
    close(out, ref, tol=1e-11)                      # 20 chained RK4 steps of |x| ~ 10


def test_compute_a_drag_target():
    X2 = X + 0.01 * RNG.standard_normal(X.shape)
    for a, b in zip(tdyn.compute_a_drag_target(t(X), t(X2), 0.1),
                    jdyn.compute_a_drag_target(jnp.asarray(X), jnp.asarray(X2), 0.1)):
        close(a, b, tol=1e-11)                      # a difference divided by dt = 0.1


def test_fold_drag_and_gp_mean_world():
    rgp = rgp_batch(6, RNG)
    jf = jaug.fold_drag(jax_rgp(rgp))
    tf = taug.fold_drag(interop.rgp_state_from_numpy(rgp))
    for name in ("X", "w", "L", "sigma_f"):
        close(getattr(tf, name), getattr(jf, name), tol=1e-9)   # w ~ 1e3: relative 1e-12
    close(taug.gp_mean_world(t(X), tf), jaug.gp_mean_world(jnp.asarray(X), jf), tol=1e-10)
    f = taug.make_mpc_dynamics(port_params())
    jfn = jaug.make_mpc_dynamics(jax_params())
    close(f(t(X), t(U), tf), jfn(jnp.asarray(X), jnp.asarray(U), jf), tol=1e-10)


def test_rgp_init():
    X_b = np.linspace(-10.0, 10.0, 10)
    ref = jrgp.rgp_init(jnp.asarray(X_b), theta=(3.0, 0.1, 0.01))
    out = trgp.rgp_init(t(X_b), theta=(3.0, 0.1, 0.01))
    for name in ("X", "mu_g", "C_g", "theta"):
        close(getattr(out, name), getattr(ref, name))
    # the inverse of an ill-conditioned K_x: two LU implementations agree
    # to ~1e-10 relative of its largest entry
    Ki, Kr = out.K_x_inv.numpy(), np.asarray(ref.K_x_inv)
    assert np.abs(Ki - Kr).max() <= 1e-10 * np.abs(Kr).max()


@pytest.mark.parametrize("k", [1, 3])
def test_rgp_regress(k):
    """k = 1 is the closed loop's elementwise path, k = 3 the matrix path;
    batched over (episodes, axes) in the port, vmapped in JAX."""
    import jax

    rgp = rgp_batch(4, RNG)
    x_t = RNG.uniform(-8.0, 8.0, (4, 3, k))
    y_t = RNG.standard_normal((4, 3, k))
    out = trgp.rgp_regress(interop.rgp_state_from_numpy(rgp), t(x_t), t(y_t))
    ref = jax.vmap(jax.vmap(jrgp.rgp_regress))(jax_rgp(rgp), jnp.asarray(x_t), jnp.asarray(y_t))
    for name in ("mu_g", "C_g"):
        close(getattr(out, name), getattr(ref, name), tol=1e-10)   # products with K_x^-1 ~ 1e4
    C = out.C_g.numpy()
    np.testing.assert_array_equal(C, np.swapaxes(C, -1, -2))      # re-symmetrised
