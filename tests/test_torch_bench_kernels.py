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
  versions, with NaN isolation between scenarios for H and I.  The host
  entries of H and I run the card's scenario walk: four persistent warps,
  each a serial lane or 32 threads, at the card's stride, with the next
  scenario's quads loaded ahead; B = 1, 5 and 33 leave warps without a
  scenario in the last round; on 32 lanes nz = 40 and 44 read slots of the
  schedule past those held in registers, and nz = 44 loads a tile in two
  rounds.
- On a CUDA device (skipped here): the kernels against their plain versions
  in f32 and in f64, and the probe's wrappers refusing what the kernels do
  not take."""

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


# persistent warps of the host entries of kernels H and I (PROBE_WARPS)
HOST_WARPS = 4


def _probe_entry(host_lib, name, lanes):
    return getattr(host_lib, f"mpcq_{name}_host{'' if lanes == 1 else lanes}_f64")


def _run_probe_entry(entry, x, reps):
    out = torch.full_like(x, float("nan"))
    assert entry(ptr(x), ptr(out), x.shape[0], x.shape[-1], reps) == 0
    return out


@pytest.mark.parametrize("nz", [8, 40, 44])
@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_host_walk_matches_plain(host_lib, name, lanes, B, nz):
    _, plain, _ = PROBES[name]
    reps = 4
    x = torch.from_numpy(np.random.default_rng(B * nz).standard_normal((B, nz, nz)))
    out = _run_probe_entry(_probe_entry(host_lib, name, lanes), x, reps)
    assert _rel(out.numpy(), plain(x, reps).numpy()) <= 1e-14


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_host_nan_spares_the_warps_next_scenario(host_lib, name, lanes):
    """Warp 1 of four walks scenarios 1, 5 and 9: a NaN in 1 reaches no
    other scenario, 5 and 9 included, whose quads it loads while 1 runs."""
    entry = _probe_entry(host_lib, name, lanes)
    B, nz, reps, bad = 11, 40, 4, 1
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((B, nz, nz)))
    out = _run_probe_entry(entry, x, reps)
    x_bad = x.clone()
    x_bad[bad, 7, 3] = float("nan")     # strict lower: both probes carry it
    out_bad = _run_probe_entry(entry, x_bad, reps)
    keep = torch.arange(B) != bad
    assert torch.isnan(out_bad[bad]).any()
    assert torch.equal(out_bad[keep], out[keep])
    assert torch.equal(out_bad[bad + HOST_WARPS], out[bad + HOST_WARPS])


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_host_refuses_widths_not_multiple_of_4(host_lib, name):
    x = torch.zeros((2, 6, 6), dtype=torch.float64)
    out = torch.empty_like(x)
    for lanes in (1, 32):
        assert _probe_entry(host_lib, name, lanes)(ptr(x), ptr(out), 2, 6, 4) != 0


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


@pytest.mark.parametrize("name", sorted(PROBES))
def test_cuda_probe_refuses_odd_widths_and_unaligned_views(name):
    dev = require_cuda()
    _, _, wrapper = PROBES[name]
    launches = wrapper.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        wrapper(torch.zeros((8, 6, 6), device=dev), 4)
    flat = torch.zeros(8 * 40 * 40 + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wrapper(flat[1:].view(8, 40, 40), 4)
    assert wrapper.launches == launches
