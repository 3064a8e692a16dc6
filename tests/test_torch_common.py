"""Shared inputs of the PyTorch port's CPU tests (no tests of its own).

The same numpy arrays, made from a seed, go through the JAX package and
through the port (``mpc_quad_ros_tpu_torch``), both in float64 on the CPU.
Parameters and GP state cross over through ``interop``.  The input makers
are ``test_torch_cuda_common``'s (JAX-free), fed the JAX package's RGP."""

import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from mpc_quad_ros_tpu.models.params import hummingbird_params as jax_hummingbird
from mpc_quad_ros_tpu.models.rgp import RGPState as JaxRGPState
from mpc_quad_ros_tpu.models.rgp import rgp_init as jax_rgp_init
from mpc_quad_ros_tpu_torch import interop

import test_torch_cuda_common as cuda_common
from test_torch_cuda_common import N, NB, require_cuda, t  # noqa: F401  (re-exported)


def as_numpy(record) -> dict:
    """A JAX NamedTuple as {field: numpy array}."""
    return {k: np.asarray(v) for k, v in record._asdict().items()}


def jax_params():
    return jax_hummingbird(dtype=jnp.float64)


def port_params():
    return interop.quad_params_from_numpy(as_numpy(jax_params()))


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


def solve_inputs(B: int, seed: int = 0, N: int = N) -> dict:
    """``test_torch_cuda_common.solve_inputs`` with the JAX package's RGP."""
    return cuda_common.solve_inputs(B, seed, N, rgp_batch)


def trajectory_inputs(B: int, seed: int = 0, N: int = N):
    """``test_torch_cuda_common.trajectory_inputs`` with the JAX package's RGP."""
    return cuda_common.trajectory_inputs(B, seed, N, rgp_batch)


def gn_step_inputs(B: int, seed: int = 0, N: int = N) -> dict:
    """``test_torch_cuda_common.gn_step_inputs`` with the JAX package's RGP
    (its parameters are the port's, bitwise the JAX package's)."""
    return cuda_common.gn_step_inputs(B, seed, N, rgp_batch)


def tiled(a) -> np.ndarray:
    """(128, ...) -> (1, ..., 128): one lanes-last tile of the Pallas kernels."""
    return np.moveaxis(np.asarray(a), 0, -1)[None]


def untiled(a) -> np.ndarray:
    """The inverse of ``tiled``."""
    return np.moveaxis(np.asarray(a)[0], -1, 0)


def ptr(tensor):
    """A host entry's pointer argument: the data pointer, or None for null."""
    return None if tensor is None else tensor.data_ptr()


def host_library(tmp_dir: pathlib.Path):
    """The g++ build of the port's CUDA sources (their f64 host entry points)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the kernels' host version")
    from mpc_quad_ros_tpu_torch.ops.cuda import _build

    return _build.load_host_library(tmp_dir)


