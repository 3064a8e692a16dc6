"""Kernels D and J's layout (``csrc/condense.cuh::condense_full``,
``csrc/condense_kernel.cu``) on the CPU, float64.

- The kernels' own source built with g++ for the host, run by one serial
  lane and by the card team's lanes: kernel D's warp of 32
  (``common.cuh::ThreadTeam<32>``: the warp's partition of the packed
  triangle and of the maps, its syncs, J streamed through the two slots),
  kernel J's block of 256 (``ThreadTeam<256>``), against the plain
  versions at N = 5, 10 and 40,
  B = 6: H, g, M and d to 1e-9, relative to each array's largest entry past
  1 (the same sums in another order; H reaches ~1.6e8 at N = 40).
- Kernel J's host output (A and B transposed into J's layout as each stage
  is streamed) bitwise equal to kernel D's on the J they came from, team by
  team (J's block against D's warp too: each element's chain keeps its
  order, whatever lane runs it).
- Both against the JAX package's Pallas kernels in interpret mode at N = 5
  on one 128-lane tile (``condense_cost_from_J_tiled``, kernel D's, and
  ``condense_cost_pallas``, kernel J's): 1e-12 of each array's largest
  entry, as the plain versions are held (``test_torch_condense_kernel.py``).
- NaN isolation: one scenario's input poisoned leaves every other
  scenario's outputs bitwise unchanged, with every team.
- The pins of the layout: 2 x 13 nz + nz (nz + 1) / 2 + nz + 39 + 442 floats
  of shared memory a block (9,524 B at N = 10, 70,724 B at N = 40), and the
  one-warp blocks of kernel D that fit an H100 SM with them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.ops.pallas.condense_kernel import (condense_cost_from_J_tiled,
                                                          condense_cost_pallas)
from mpc_quad_ros_tpu_torch.ops.cuda import condense_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import split_AB

from test_torch_common import gn_step_inputs, host_library, ptr, tiled, untiled

B, BAD = 6, 2
HORIZONS = (5, 10, 40)
ARGS = ("J", "r", "dx0", "ex0")
# team -> (kernel D's entry suffix, kernel J's); J's block runs beside D's warp
D_TEAMS = {"serial": "", "lanes32": "32"}
J_TEAMS = {"serial": ("", ""), "lanes256": ("256", "32")}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


@pytest.fixture(scope="module", params=HORIZONS, ids=lambda N: f"N{N}")
def step(request):
    N = request.param
    inp = gn_step_inputs(B, seed=700 + N, N=N)
    return [inp[k] for k in ARGS], inp["solver"].cfg.weight_tuples()


def _ab(args):
    J, *tail = args
    return [a.contiguous() for a in split_AB(J)] + tail


def _host(lib, entry, args, w):
    Bn, N = args[0].shape[:2]
    nz = 4 * N
    f64 = dict(dtype=torch.float64)
    out = (torch.empty(Bn, nz, nz, **f64), torch.empty(Bn, nz, **f64),
           torch.empty(Bn, N + 1, 13, nz, **f64), torch.empty(Bn, N + 1, 13, **f64))
    weights = torch.tensor([v for part in w for v in part], **f64)
    assert getattr(lib, entry)(*map(ptr, args), ptr(weights), *map(ptr, out), Bn, N) == 0
    return out


def _d(lib, team, args, w):
    return _host(lib, f"mpcq_condense_host{team}_f64", args, w)


def _j(lib, team, args, w):
    return _host(lib, f"mpcq_condense_ab_host{team}_f64", _ab(args), w)


def _assert_close(out, ref, tol):
    """Each array within tol of the plain version's, relative to its largest
    entry where that passes 1 (H reaches ~1.6e8 at N = 40)."""
    for name, a, b in zip("HgMd", out, ref):
        err = (a - b).abs().max().item()
        assert err <= tol * max(1.0, b.abs().max().item()), f"{name}: {err}"


@pytest.mark.parametrize("team", D_TEAMS)
def test_kernel_d_host_team_matches_plain(host_lib, step, team):
    args, w = step
    out = _d(host_lib, D_TEAMS[team], args, w)
    _assert_close(out, condense_kernel.condense_cost_from_J_plain(*args, *w), 1e-9)
    assert torch.equal(out[0], out[0].mT)                      # mirrored, exactly symmetric


@pytest.mark.parametrize("team", J_TEAMS)
def test_kernel_j_host_team_matches_plain_and_kernel_d(host_lib, step, team):
    args, w = step
    j_team, d_team = J_TEAMS[team]
    out = _j(host_lib, j_team, args, w)
    _assert_close(out, condense_kernel.condense_cost_from_AB_plain(*_ab(args), *w), 1e-9)
    for a, b in zip(out, _d(host_lib, d_team, args, w)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("team", J_TEAMS)
def test_host_teams_nan_isolated(host_lib, step, team):
    args, w = step
    j_team, d_team = J_TEAMS[team]
    bad = [a.clone() for a in args]
    bad[0][BAD, args[0].shape[1] // 2, 5, 8] = float("nan")
    keep = torch.arange(B) != BAD
    for run, tm in ((_d, d_team), (_j, j_team)):
        out, out_bad = run(host_lib, tm, args, w), run(host_lib, tm, bad, w)
        assert torch.isnan(out_bad[0][BAD]).any()
        for a, b in zip(out_bad, out):
            assert torch.equal(a[keep], b[keep])


@pytest.fixture(scope="module")
def tile():
    """One 128-lane tile of N=5 inputs and the two Pallas kernels' outputs."""
    inp = gn_step_inputs(128, seed=71, N=5)
    args, (q, p, rw) = [inp[k] for k in ARGS], inp["solver"].cfg.weight_tuples()
    ref_d = condense_cost_from_J_tiled(*(jnp.asarray(tiled(a)) for a in args), q=q, p=p, rw=rw,
                                       interpret=True)
    ref_j = condense_cost_pallas(*(jnp.asarray(a.numpy()) for a in _ab(args)), q=q, p=p, rw=rw,
                                 interpret=True)
    return args, (q, p, rw), [untiled(a) for a in ref_d], [np.asarray(a) for a in ref_j]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("team", J_TEAMS)
def test_host_teams_match_jax_pallas(host_lib, tile, team):
    args, w, ref_d, ref_j = tile
    j_team, d_team = J_TEAMS[team]
    for ours, ref in zip(_d(host_lib, d_team, args, w), ref_d):
        assert _rel(ours.numpy(), ref) <= 1e-12
    for ours, ref in zip(_j(host_lib, j_team, args, w), ref_j):
        assert _rel(ours.numpy(), ref) <= 1e-12


def test_workspace_pins(host_lib):
    """M_k's two buffers (2 x 13 nz), H's packed lower triangle and g as its
    row nz, d's two 13-vectors, ex + d (13) and J's two stream slots
    (2 x 221), in floats."""
    ws = host_lib.mpcq_condense_ws_bytes
    size = lambda nz: 2 * 13 * nz + nz * (nz + 1) // 2 + nz + 3 * 13 + 2 * 221
    assert [ws(N) for N in (10, 40)] == [4 * size(40), 4 * size(160)] == [9_524, 70_724]
    # an H100 SM's 233,472 bytes hold 21 one-warp blocks at N = 10 and 3 at
    # N = 40: each takes its workspace rounded up to 256 B, and 1 KB of the
    # SM's own
    per_block = lambda n: -(-ws(n) // 256) * 256 + 1024
    assert [233_472 // per_block(N) for N in (10, 40)] == [21, 3]
