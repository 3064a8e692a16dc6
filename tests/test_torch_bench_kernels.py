"""Kernels G (f32 multiply-add chains, ``bench/phases.py::fma_chains``), H
and I (the transpose probe, ``bench/probe_hybrid.py::mirror_probe`` and
``elem_probe``) on the CPU, float64.

- The plain versions against the JAX package's Pallas kernels in interpret
  mode: ``_fma_kernel`` at grid=2, S=8, chains=4, steps=16 to 1e-12
  relative; ``_mirror_kernel`` and ``_elem_kernel`` on one 128-scenario tile
  at nz=8, reps=4 to 1e-14 of the largest entry (the same operations in the
  same order; XLA may fuse a multiply-add, so an entry that cancels may
  differ in its last bits).
- The kernels' own sources built with g++ for the host against the plain
  versions, with NaN isolation between scenarios for H and I.
- On a CUDA device (skipped here): the kernels against their plain versions
  in f32 and in f64."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mpc_quad_ros_tpu.bench.phases import _fma_kernel
from mpc_quad_ros_tpu.bench.probe_hybrid import _elem_kernel, _mirror_kernel
from mpc_quad_ros_tpu_torch.bench import phases, probe_hybrid

from test_torch_common import host_library, ptr, require_cuda, tiled, untiled

PROBES = {"mirror": (_mirror_kernel, probe_hybrid.mirror_probe_plain, probe_hybrid.mirror_probe),
          "elem": (_elem_kernel, probe_hybrid.elem_probe_plain, probe_hybrid.elem_probe)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


def _fma_input(grid=2, S=8, seed=0):
    return np.random.default_rng(seed).uniform(0.99, 1.01, (grid, S, 128))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_fma_plain_matches_pallas_kernel():
    grid, S, chains, steps = 2, 8, 4, 16
    x = _fma_input(grid, S)
    call = pl.pallas_call(
        functools.partial(_fma_kernel, chains=chains, steps=steps), grid=(grid,),
        in_specs=[pl.BlockSpec((1, S, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, S, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, S, 128), jnp.float64), interpret=True)
    ref = np.asarray(call(jnp.asarray(x)))
    ours = phases.fma_chains(torch.from_numpy(x), chains, steps)
    assert ours.dtype == torch.float64
    assert _rel(ours.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_plain_matches_pallas_kernel(name):
    kernel, plain, _ = PROBES[name]
    nz, reps = 8, 4
    x = np.random.default_rng(3).standard_normal((128, nz, nz))
    call = pl.pallas_call(
        functools.partial(kernel, nz=nz, reps=reps), grid=(1,),
        in_specs=[pl.BlockSpec((1, nz, nz, 128), lambda i: (i, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, nz, nz, 128), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, nz, nz, 128), jnp.float64), interpret=True)
    ref = untiled(call(jnp.asarray(tiled(x))))
    ours = plain(torch.from_numpy(x), reps)
    assert _rel(ours.numpy(), ref) <= 1e-14
    low = np.tril(np.ones((nz, nz), bool), -1)
    if name == "mirror":      # the strict lower triangle never changes
        np.testing.assert_array_equal(ours.numpy()[:, low], x[:, low])
    else:                     # the upper triangle and the diagonal never change
        np.testing.assert_array_equal(ours.numpy()[:, ~low], x[:, ~low])


@pytest.mark.parametrize("resident", [True, False], ids=["registers", "smem_streaming"])
def test_fma_source_on_host_matches_plain(host_lib, resident):
    x = torch.from_numpy(_fma_input(3, 8, seed=1))
    for chains, steps in ((4, 16), (16, 7), (1, 0)):
        ref = phases.fma_chains_plain(x, chains, steps)
        out = torch.empty_like(x)
        assert host_lib.mpcq_fma_host_f64(ptr(x), ptr(out), x.numel(), chains, steps,
                                          int(resident)) == 0
        assert _rel(out.numpy(), ref.numpy()) <= 1e-12
    assert host_lib.mpcq_fma_host_f64(ptr(x), ptr(out), x.numel(), 3, 4, 1) != 0


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_source_on_host_matches_plain(host_lib, name):
    _, plain, _ = PROBES[name]
    B, nz, reps = 6, 40, 4
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, nz, nz)))
    entry = getattr(host_lib, f"mpcq_{name}_host_f64")

    def run(inp):
        out = torch.empty_like(inp)
        assert entry(ptr(inp), ptr(out), B, nz, reps) == 0
        return out

    out = run(x)
    assert _rel(out.numpy(), plain(x, reps).numpy()) <= 1e-14
    bad = 2
    x_bad = x.clone()
    x_bad[bad, 7, 3] = float("nan")     # strict lower: both probes carry it
    out_bad = run(x_bad)
    keep = torch.arange(B) != bad
    assert torch.isnan(out_bad[bad]).any()
    assert torch.equal(out_bad[keep], out[keep])


def test_cpu_tensors_take_the_plain_versions():
    phases.fma_chains.launches = 0
    probe_hybrid.mirror_probe.launches = probe_hybrid.elem_probe.launches = 0
    x = torch.from_numpy(_fma_input())
    assert torch.equal(phases.fma_chains(x, 2, 3, resident=False), phases.fma_chains_plain(x, 2, 3))
    h = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 6, 6)))
    for _, plain, wrapper in PROBES.values():
        assert torch.equal(wrapper(h, 3), plain(h, 3))
    assert phases.fma_chains.launches == 0
    assert probe_hybrid.mirror_probe.launches == probe_hybrid.elem_probe.launches == 0


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
    _, plain, wrapper = PROBES[name]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((256, 40, 40)))
    out = wrapper(x.float().to(dev), 4)
    # one multiply-add a repetition per entry: f32 rounding, relative
    assert _rel(out.double().cpu().numpy(), plain(x, 4).numpy()) < 1e-6
