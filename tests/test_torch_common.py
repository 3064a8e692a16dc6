"""Shared inputs of the PyTorch port's CPU tests (no tests of its own).

The same numpy arrays, made from a seed, go through the JAX package and
through the port (``mpc_quad_ros_tpu_torch``), both in float64 on the CPU.
Parameters and GP state cross over through ``interop``."""

import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.models.params import hummingbird_params as jax_hummingbird
from mpc_quad_ros_tpu.models.rgp import RGPState as JaxRGPState
from mpc_quad_ros_tpu.models.rgp import rgp_init as jax_rgp_init
from mpc_quad_ros_tpu_torch import interop

# the tier runs several pytest workers: one intra-op thread each
torch.set_num_threads(1)

N, NB = 10, 10


def as_numpy(record) -> dict:
    """A JAX NamedTuple as {field: numpy array}."""
    return {k: np.asarray(v) for k, v in record._asdict().items()}


def jax_params():
    return jax_hummingbird(dtype=jnp.float64)


def port_params():
    return interop.quad_params_from_numpy(as_numpy(jax_params()))


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def rgp_batch(B: int, rng, mu_scale: float = 0.3, nb: int = NB) -> dict:
    """(B, 3) RGP states from the JAX rgp_init (basis linspace(-10, 10, nb),
    theta (3, 0.1, 0.01)) with a random posterior mean, as numpy."""
    r1 = jax_rgp_init(jnp.linspace(-10.0, 10.0, nb), theta=(3.0, 0.1, 0.01))
    out = {k: np.broadcast_to(np.asarray(v), (B, 3) + np.shape(v)).copy()
           for k, v in r1._asdict().items()}
    out["mu_g"] = mu_scale * rng.standard_normal((B, 3, nb))
    return out


def jax_rgp(arrays: dict) -> JaxRGPState:
    return JaxRGPState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def solve_inputs(B: int, seed: int = 0) -> dict:
    """The benchmark's operating point: hover at 3 m with velocities
    U(-3, 3), the reference stepped 1-5 m along x over the horizon."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7:10] += rng.uniform(-3.0, 3.0, (B, 3))
    y_ref = np.repeat(x0[:, None, :], N, axis=1)
    y_ref[:, :, 0] += np.linspace(0.0, 1.0, N)[None, :] * rng.uniform(1.0, 5.0, (B, 1))
    return {"x0": x0, "y_ref": y_ref, "rgp": rgp_batch(B, rng)}


def trajectory_inputs(B: int, seed: int = 0):
    """A perturbed (B, N+1, 13) state trajectory (non-unit quaternions
    included) and (B, N, 4) controls inside the box."""
    rng = np.random.default_rng(seed)
    X = np.zeros((B, N + 1, 13))
    X[..., 3] = 1.0
    X[..., 2] = 3.0
    X += 0.2 * rng.standard_normal(X.shape)
    X[..., 7:10] += rng.uniform(-4.0, 4.0, (B, 1, 3))
    U = rng.uniform(0.2, 0.7, (B, N, 4))
    return X, U, rgp_batch(B, rng)


def host_library(tmp_dir: pathlib.Path):
    """The g++ build of the port's CUDA sources (their f64 host entry points)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the kernels' host version")
    from mpc_quad_ros_tpu_torch.ops.cuda import _build

    return _build.load_host_library(tmp_dir)


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)
