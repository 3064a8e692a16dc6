"""Kernel C's layout (``csrc/riccati_ipm.cu``) on the CPU, float64.

- The kernel's own source built with g++ for the host, run by one serial
  lane and by a team of 32 threads (``common.cuh::ThreadTeam``: the warp's
  lane split and syncs, J and [K | kff] streamed through the two shared
  slots, K written to the scratch in the sweep and read back in the forward
  pass, the rollout's dX in the dX output), against the plain version at
  N = 12 and 40, B = 6: du and dX to 1e-9 (the same operations in the same
  order; measured ~1e-15).
- The same host builds against the JAX package's Riccati oracle
  (``ops/riccati.solve_ocp_box_riccati_ipm``, vmapped; LU where the kernel
  runs Cholesky on the 4x4 systems), with J formed from A and B as
  ``tests/test_riccati_kernel.py`` forms it: 1e-9.
- NaN isolation: one scenario's J poisoned leaves every other scenario's du
  and dX bitwise unchanged, with either team.
- The pins of the layout: 24 N + 1128 floats of shared memory a block
  (8,352 B at N = 40, 19,584 B when K and kff lay there too) and 56 N floats
  of device scratch a scenario."""

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch.ops.cuda import riccati_kernel

from test_torch_common import host_library, ptr
from test_torch_riccati import PT, Q, RD, jax_ipm, random_ocp
from test_torch_riccati_kernel import ITERS, kernel_inputs

B, BAD = 6, 2
HORIZONS = (12, 40)
TEAMS = {"serial": "", "lanes32": "32"}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


@pytest.fixture(scope="module", params=HORIZONS, ids=lambda N: f"N{N}")
def ocp(request):
    return random_ocp(B, request.param, seed=600 + request.param)


def _host(lib, team, args):
    N = args[0].shape[1]
    du = torch.empty((B, N, 4), dtype=torch.float64)
    dX = torch.empty((B, N + 1, 13), dtype=torch.float64)
    w = torch.tensor(list(Q) + list(PT) + list(RD), dtype=torch.float64)
    rc = getattr(lib, f"mpcq_riccati_ipm_host{team}_f64")(*map(ptr, args), ptr(w), ptr(du),
                                                           ptr(dX), B, N, ITERS)
    assert rc == 0
    return du, dX


@pytest.mark.parametrize("team", TEAMS)
def test_host_team_matches_plain(host_lib, ocp, team):
    args = kernel_inputs(ocp)
    ref = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, Q, PT, RD, ITERS)
    for name, a, b in zip(("du", "dX"), _host(host_lib, TEAMS[team], args), ref):
        err = (a - b).abs().max().item()
        assert err <= 1e-9, f"{name}: {err}"


@pytest.mark.parametrize("team", TEAMS)
def test_host_team_matches_jax_oracle(host_lib, ocp, team):
    du, dX = _host(host_lib, TEAMS[team], kernel_inputs(ocp))
    ref = jax_ipm(ocp, ITERS)
    np.testing.assert_allclose(du.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dX.numpy(), np.asarray(ref[1]), rtol=0, atol=1e-9)


@pytest.mark.parametrize("team", TEAMS)
def test_host_team_nan_isolated(host_lib, ocp, team):
    args = kernel_inputs(ocp)
    out = _host(host_lib, TEAMS[team], args)
    J_bad = args[0].clone()
    J_bad[BAD, args[0].shape[1] // 2, 5, 8] = float("nan")
    out_bad = _host(host_lib, TEAMS[team], [J_bad] + args[1:])
    keep = torch.arange(B) != BAD
    assert torch.isnan(out_bad[0][BAD]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


def test_workspace_and_scratch_sizes(host_lib):
    """Per stage du, sl, su, zl, zu, ddu (24 floats) in shared memory; per
    block P and A^T P (2 x 169), B^T P, G, S, rhs2, dbar, A^T p, p, two
    recurrence vectors, the stage's [K | kff] (56) and two stream slots of
    221 + 56: 1128.  K and kff of every stage (56 N) in the scratch."""
    ws, scr = host_lib.mpcq_riccati_ws_bytes, host_lib.mpcq_riccati_scratch_bytes
    assert 2 * 169 + 52 + 16 + 52 + 4 + 4 + 13 + 13 + 26 + 56 + 2 * (221 + 56) == 1128
    assert [ws(N) for N in (10, 40)] == [4 * (24 * 10 + 1128), 4 * (24 * 40 + 1128)] == [5_472, 8_352]
    assert [scr(N) for N in (10, 40)] == [4 * 56 * 10, 4 * 56 * 40] == [2_240, 8_960]
    # 24 blocks of one warp (and 1 KB of the SM's own a block) fit an H100
    # SM's 233,472 bytes at N = 40
    assert 24 * (ws(40) + 1024) <= 233_472
