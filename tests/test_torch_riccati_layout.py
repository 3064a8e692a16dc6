"""Kernel C's layout (``csrc/riccati_ipm.cu``) on the CPU, float64.

- The kernel's own source built with g++ for the host, run by one serial
  lane and by a team of 32 threads (``common.cuh::ThreadTeam``: the warp's
  lane split and syncs, J and [K | kff] streamed through the two shared
  slots, the sweep's register tiles, K written to the scratch in the sweep
  and read back in the forward pass, dX rolled out again in the forward
  pass and moved by alpha ddx, rolled out at the end), against the plain
  version at N = 12, 40 and 80, B = 6: du and dX to 1e-9 (the same sums in
  the same order, rsqrt pivots: rounding only; measured ~1e-15 to 2e-14).
- The same host builds against the JAX package's Riccati oracle
  (``ops/riccati.solve_ocp_box_riccati_ipm``, vmapped; LU where the kernel
  runs Cholesky on the 4x4 systems), with J formed from A and B as
  ``tests/test_riccati_kernel.py`` forms it: 1e-9.
- NaN isolation: one scenario's J poisoned leaves every other scenario's du
  and dX bitwise unchanged, with either team.
- The pins of the layout: 24 N + 1312 floats of shared memory a block
  (9,088 B at N = 40, 20,608 B at N = 160) and 89 N floats of device
  scratch a scenario, rounded up to a multiple of 4."""

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch.ops.cuda import riccati_kernel

from test_torch_common import host_library, ptr
from test_torch_riccati import PT, Q, RD, jax_ipm, random_ocp
from test_torch_riccati_kernel import ITERS, kernel_inputs

B, BAD = 6, 2
HORIZONS = (12, 40, 80)
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
    """Per stage du, sl, su, zl, zu and ddu (rhat in the sweep): 24 floats in
    shared memory; per block [P | p] (13 rows of 16), W^T (16 rows of 20,
    row 13 J p; S^T and K^T in its place), two stream slots of 360 (J_k's
    quads, 224, and [K_k | kff_k]'s, 60; or the products' 17 rows of 20 and
    a stage's rd + dbar_k, q dX_k + qlin_k, 20), the weights (32) and the
    lanes' codes of P's entries (32 words): 1312;
    the passes' third slot and their two vectors of 16 where [P | p] and W^T
    are.  In the scratch, per stage: -K^T and -kff (56), rd + dbar_k and
    q dX_k + qlin_k (17, in records of 20) and the forward pass's ddx (13),
    rounded up to whole quads a scenario."""
    ws, scr = host_lib.mpcq_riccati_ws_bytes, host_lib.mpcq_riccati_scratch_bytes
    assert 17 * 20 + 20 <= 360 and 224 + 60 <= 360 and 4 * ((6 + 221) // 4) == 224
    assert 2 * 52 <= 13 * 20 and 360 + 2 * 16 <= 13 * 16 + 16 * 20
    assert 13 * 16 + 16 * 20 + 2 * 360 + 32 + 32 == 1312
    assert ([ws(N) for N in (10, 40, 160)]
            == [4 * (24 * 10 + 1312), 4 * (24 * 40 + 1312), 4 * (24 * 160 + 1312)]
            == [6_208, 9_088, 20_608])
    assert [scr(N) for N in (10, 40)] == [4 * 892, 4 * 89 * 40] == [3_568, 14_240]
    # 23 blocks of one warp (each rounded up to 128 bytes, and 1 KB of the
    # SM's own a block) fit an H100 SM's 233,472 bytes at N = 40, 24 do not
    block = -(-ws(40) // 128) * 128 + 1024
    assert 23 * block <= 233_472 < 24 * block
