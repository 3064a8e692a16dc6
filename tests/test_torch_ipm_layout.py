"""The packed-matrix box-QP interior point (``csrc/ipm_box.cuh``) of kernels
B, E and F on the CPU, float64, at every register-slot count the card uses.

- Each kernel's own source built with g++ for the host, run by one serial
  lane and by a team of 32 threads (``common.cuh::ThreadTeam``: the card's
  lane split, syncs, reductions and broadcasts), against its plain version,
  cold and warm-started from the plain cold solve's duals, at nz = 12, 40,
  68 and 160 (N = 3, 10, 17, 40: one to five slots a lane), B = 4 with one
  scenario poisoned by a NaN, which must leave the other three bitwise
  unchanged.
- Tolerances: z, zl, zu to 1e-9; dX to 1e-8, as the other tests of kernels
  B and F hold it (the condensing maps carry z's rounding through N stages
  of up to |dX| ~ 10); the KKT residual to 1e-9 of max |H| max |z|, the size
  of the terms that H z + g cancels.  The operating point is hover with y_ref = x0 and a
  control weight of 100: there two Cholesky codes (LAPACK's in the plain
  version, the kernel's) agree to these bounds up to N = 40.  At the
  perturbed trajectories of ``gn_step_inputs`` the condensed H at N = 40 is
  ill-conditioned enough that they differ by ~1e-6 in f64 (12 iterations
  amplify the rounding), whichever team runs the kernel.
- Kernel B's block walk (``mpcq_sqp_fused_host_block_f64``): as many
  32-thread teams side by side as the card's block has warps, each on its
  slice of one block's workspace, which starts as NaN; against the plain
  version and bitwise against the one-warp walk, and a NaN in one warp's
  scenario (the first warp's or the second's) leaves its block-mate bitwise
  unchanged.  Only at nz = 12 and 40: past nz = 64 a block is one warp, the
  one-warp walk above.  Two scenarios, one block.
- Kernel E keeps the bits of that IPM (``ipm_box_solve``, which B and F
  run): its 32-thread team bitwise the shared IPM's 32-thread team on the
  same QPs (``mpcq_box_qp_shared_ipm_host32_f64``), cold and warm, at every
  horizon; in f64 on the host each operation rounds once as on the card, so
  equal bits here mean the same operations in the same order.  Its paired
  block walk (``mpcq_box_qp_host_block_f64``: eight 16-thread teams side by
  side on one block workspace, NaN-filled, its strip table built once) at
  nz = 12 and 40, where the card pairs scenarios: three blocks' worth of
  scenarios (the case's four, tiled), bitwise the 32-thread team, and a NaN
  in one scenario leaves every other one, its block-mates included, bitwise
  unchanged.
- Kernel F's block walk (``mpcq_sqp_step_host_block_f64``: eight 16-thread
  teams on one NaN-filled block, its strip table built once, each team on
  its slice of a NaN-filled scratch) at N = 3 and 10, bitwise its 32-thread
  team, with a NaN in one scenario leaving its block-mates unchanged; and
  kernel F's host builds bitwise kernel A's host build then kernel B's, at
  every horizon (the fused and hybrid pipelines' bits).
- Kernel E at an nz that is not a multiple of four (its last Cholesky
  panel and the last quad of its strips partial; the condensed QPs have
  nz = 4 N): random positive definite QPs, its three host walks against
  the shared IPM (bitwise for the teams of 32 and 16 threads) and the plain
  version (1e-9).
- The shared-memory sizes of the layout: one packed matrix and one
  condensing map a scenario; kernel E's blocks."""

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops import sqp
from mpc_quad_ros_tpu_torch.ops.cuda import qp_kernel, sqp_fused_kernel
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import condense_from_J
from mpc_quad_ros_tpu_torch.ops.cuda.lin_kernel import linearize_plain, model_constants
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver

from test_torch_common import host_library, jax_params, port_params, ptr, rgp_batch, t

B, ITERS, BAD = 4, 12, 2
BLOCK_B = 2
HORIZONS = (3, 10, 17, 40)
# the horizons at which kernel B's block holds two warps and kernel E pairs
# scenarios (nz <= 40)
BLOCK_HORIZONS = (3, 10)
# kernel E's paired block: scenarios a block, and the tiling of the case's
# scenarios that fills one block and part of the next
E_PAIR_TEAMS, E_TILE = 8, 3
TEAMS = {"serial": "", "lanes32": "32"}
STEP = ("dx0", "ex0", "gu", "lb", "ub")
f64 = dict(dtype=torch.float64)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("csrc_host"))


def hover_inputs(N: int, seed: int) -> dict:
    """One Gauss-Newton step near hover at 3 m (velocities U(-0.5, 0.5) m/s,
    the trajectory the start state plus 1e-3 noise, U the hover input plus
    1e-2 noise), y_ref = x0, the RGP drag with a zero posterior mean, control
    weight 100: the step's inputs and the plain cold step's duals."""
    rng = np.random.default_rng(seed)
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(jax_params().hover_input),
                    r_cost=(100.0,) * 4)
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    x0 = np.zeros((B, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7:10] = rng.uniform(-0.5, 0.5, (B, 3))
    X = np.repeat(x0[:, None], N + 1, axis=1) + 1e-3 * rng.standard_normal((B, N + 1, 13))
    U = cfg.u_ref + 1e-2 * rng.standard_normal((B, N, 4))
    y_ref = np.repeat(x0[:, None], N, axis=1)
    aug = fold_drag(interop.rgp_state_from_numpy(rgp_batch(B, rng, mu_scale=0.0)))
    aug = aug.map(lambda a: a.contiguous())
    X, U, x0, y_ref = map(t, (X, U, x0, y_ref))
    xp, J = linearize_plain(solver.f, X, U, aug, cfg.dt)
    keys = ("r",) + STEP
    inp = {k: v.contiguous() for k, v in
           zip(keys, solver.qp_inputs(X, U, x0, y_ref, y_ref[:, -1], xp))}
    inp.update(N=N, solver=solver, X=X, U=U, aug=aug, J=J.contiguous(),
               w=cfg.weight_tuples())
    H, g = condense_from_J(inp["J"], inp["r"], inp["dx0"], inp["ex0"], *inp["w"])
    inp["box"] = (H.contiguous(), (g + inp["gu"]).contiguous(), inp["lb"], inp["ub"])
    inp["duals"] = sqp_fused_kernel.fused_sqp_from_J_plain(*_b_args(inp), *inp["w"], ITERS)[3:]
    return inp


@pytest.fixture(scope="module", params=HORIZONS, ids=lambda N: f"N{N}")
def case(request):
    return hover_inputs(request.param, seed=900 + request.param)


def _b_args(inp):
    return [inp[k] for k in ("J", "r") + STEP]


def _empty(shape, n=1):
    return [torch.empty(shape, **f64) for _ in range(n)]


def _step_out(N, b=B):
    nz = 4 * N
    return _empty((b, nz)) + _empty((b, N + 1, 13)) + _empty((b,)) + _empty((b, nz), 2)


def _weights(inp):
    return torch.tensor([v for ws in inp["w"] for v in ws], **f64)


def _run_b(lib, team, inp, duals, J, b=B):
    """Kernel B's host entry on the first b scenarios."""
    out, w = _step_out(inp["N"], b), _weights(inp)      # alive through the call
    rc = getattr(lib, f"mpcq_sqp_fused_host{team}_f64")(
        ptr(J), *map(ptr, _b_args(inp)[1:]), *map(ptr, duals or (None, None)), ptr(w),
        *map(ptr, out), b, inp["N"], ITERS)
    assert rc == 0
    return out


def _consts(inp):
    solver = inp["solver"]
    return torch.tensor(model_constants(solver.f.params, solver.cfg.dt), **f64)


def _run_f(lib, team, inp, duals, X):
    """Kernel F's host entry on the scenarios of X (the case's, or tiled)."""
    aug, b = inp["aug"], X.shape[0]
    consts, out, w = _consts(inp), _step_out(inp["N"], b), _weights(inp)
    rc = getattr(lib, f"mpcq_sqp_step_host{team}_f64")(
        ptr(X), ptr(inp["U"]), ptr(aug.X), ptr(aug.w), ptr(aug.L), ptr(aug.sigma_f),
        aug.X.shape[-1], *(ptr(inp[k]) for k in STEP), *map(ptr, duals or (None, None)),
        ptr(consts), ptr(w), *map(ptr, out), b, inp["N"], ITERS)
    assert rc == 0
    return out


def _tiled(case, n):
    """Kernel F's inputs and the warm duals of the case's scenarios, repeated
    n times."""
    rep = lambda a: a.repeat((n,) + (1,) * (a.dim() - 1)).contiguous()
    return dict(case, X=rep(case["X"]), U=rep(case["U"]), aug=case["aug"].map(rep),
                duals=[rep(d) for d in case["duals"]], **{k: rep(case[k]) for k in STEP})


def _run_e(lib, team, inp, duals, H, entry="mpcq_box_qp_host{}_f64", box=None):
    """Kernel E's host entry (or `entry`) on H and the case's (or `box`'s)
    g, lb, ub."""
    b, nz = H.shape[:2]
    out = _empty((b, nz), 3)
    rc = getattr(lib, entry.format(team))(
        ptr(H), *map(ptr, (box or inp["box"])[1:]), *map(ptr, duals or (None, None)),
        *map(ptr, out), b, nz, ITERS)
    assert rc == 0
    return out


def _same(outs, refs):
    return all(torch.equal(a, b) for a, b in zip(outs, refs))


def _check_step(inp, out, ref):
    """z, dX, kkt, zl, zu against the plain step, at the stated bounds."""
    H, _, _, _ = inp["box"]
    kkt_scale = max(1.0, H.abs().max().item() * ref[0].abs().max().item())
    tols = (1e-9, 1e-8, 1e-9 * kkt_scale, 1e-9, 1e-9)
    for name, a, b, tol in zip(("z", "dX", "kkt", "zl", "zu"), out, ref, tols):
        err = (a - b).abs().max().item()
        assert err <= tol, f"{name}: {err} > {tol}"


def _isolated(out, out_bad):
    keep = torch.arange(B) != BAD
    assert torch.isnan(out_bad[0][BAD]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[keep], b[keep])


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("team", TEAMS)
def test_kernel_b_host_matches_plain(case, host_lib, team, warm):
    duals = case["duals"] if warm else None
    ref = sqp_fused_kernel.fused_sqp_from_J_plain(*_b_args(case), *case["w"], ITERS, duals)
    out = _run_b(host_lib, TEAMS[team], case, duals, case["J"])
    _check_step(case, out, ref)
    J_bad = case["J"].clone()
    J_bad[BAD, case["N"] // 2, 5, 8] = float("nan")
    _isolated(out, _run_b(host_lib, TEAMS[team], case, duals, J_bad))


@pytest.mark.parametrize("bad", [0, 1], ids=["nan_warp0", "nan_warp1"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", BLOCK_HORIZONS, indirect=True, ids=lambda N: f"N{N}")
def test_kernel_b_block_walk(case, host_lib, warm, bad):
    """The card's block of kernel B on the host: two warps' teams, one
    condensing map a scenario, J read where it lies."""
    N = case["N"]
    assert host_lib.mpcq_sqp_block_warps(N) == BLOCK_B
    duals = [d[:BLOCK_B].contiguous() for d in case["duals"]] if warm else None
    inp = dict(case, **{k: case[k][:BLOCK_B].contiguous() for k in ("J", "r") + STEP})
    ref = sqp_fused_kernel.fused_sqp_from_J_plain(*_b_args(inp), *case["w"], ITERS, duals)
    out = _run_b(host_lib, "_block", inp, duals, inp["J"], BLOCK_B)
    _check_step(case, out, ref)
    for a, b in zip(out, _run_b(host_lib, "32", inp, duals, inp["J"], BLOCK_B)):
        assert torch.equal(a, b)
    # a NaN in warp `bad`'s scenario; its block-mate's outputs unchanged
    J_bad = inp["J"].clone()
    J_bad[bad, N // 2, 5, 8] = float("nan")
    out_bad = _run_b(host_lib, "_block", inp, duals, J_bad, BLOCK_B)
    assert torch.isnan(out_bad[0][bad]).any()
    for a, b in zip(out_bad, out):
        assert torch.equal(a[1 - bad], b[1 - bad])


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("team", TEAMS)
def test_kernel_e_host_matches_plain(case, host_lib, team, warm):
    duals = case["duals"] if warm else None
    ref = qp_kernel.ipm_box_solve(*case["box"], ITERS, *(duals or (None, None)))
    out = _run_e(host_lib, TEAMS[team], case, duals, case["box"][0])
    for name, a, b in zip(("z", "zl", "zu"), out, ref):
        err = (a - b).abs().max().item()
        assert err <= 1e-9, f"{name}: {err}"
    H_bad = case["box"][0].clone()
    H_bad[BAD, 1, 3] = float("nan")          # the upper triangle, which the kernel reads
    _isolated(out, _run_e(host_lib, TEAMS[team], case, duals, H_bad))
    if team == "lanes32":
        # the arithmetic of the shared IPM, bit for bit
        shared = _run_e(host_lib, "", case, duals, case["box"][0],
                        entry="mpcq_box_qp_shared_ipm_host32_f64")
        assert _same(out, shared)


@pytest.mark.parametrize("bad", [1, 9], ids=["nan_block0", "nan_block1"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", BLOCK_HORIZONS, indirect=True, ids=lambda N: f"N{N}")
def test_kernel_e_block_walk(case, host_lib, warm, bad):
    """The card's paired block of kernel E on the host: eight 16-thread
    teams, one table a block, on 12 scenarios (a full block and part of the
    next)."""
    nz = 4 * case["N"]
    assert host_lib.mpcq_box_qp_block_scenarios(16, nz) == E_PAIR_TEAMS
    assert host_lib.mpcq_box_qp_lanes(65536, nz) == 16 and host_lib.mpcq_box_qp_lanes(127, nz) == 32
    box = tuple(a.repeat((E_TILE,) + (1,) * (a.dim() - 1)).contiguous() for a in case["box"])
    duals = [d.repeat(E_TILE, 1).contiguous() for d in case["duals"]] if warm else None
    out = _run_e(host_lib, "_block", case, duals, box[0], box=box)
    ref = qp_kernel.ipm_box_solve(*box, ITERS, *(duals or (None, None)))
    for name, a, b in zip(("z", "zl", "zu"), out, ref):
        err = (a - b).abs().max().item()
        assert err <= 1e-9, f"{name}: {err}"
    assert _same(out, _run_e(host_lib, "32", case, duals, box[0], box=box))
    # a NaN in scenario `bad`; every other scenario's outputs unchanged
    H_bad = box[0].clone()
    H_bad[bad, 1, 3] = float("nan")
    out_bad = _run_e(host_lib, "_block", case, duals, H_bad, box=box)
    keep = torch.arange(E_TILE * B) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    assert all(torch.equal(a[keep], b[keep]) for a, b in zip(out_bad, out))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("team", TEAMS)
def test_kernel_f_host_matches_plain(case, host_lib, team, warm):
    duals = case["duals"] if warm else None
    solver = case["solver"]
    ref = sqp_fused_kernel.fused_sqp_step_plain(
        case["X"], case["U"], *(case[k] for k in STEP), case["aug"], solver.f, solver.cfg.dt,
        *case["w"], ITERS, duals)
    out = _run_f(host_lib, TEAMS[team], case, duals, case["X"])
    _check_step(case, out, ref)
    X_bad = case["X"].clone()
    X_bad[BAD, 1, 8] = float("nan")
    _isolated(out, _run_f(host_lib, TEAMS[team], case, duals, X_bad))


@pytest.mark.parametrize("bad", [1, 9], ids=["nan_block0", "nan_block1"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("case", BLOCK_HORIZONS, indirect=True, ids=lambda N: f"N{N}")
def test_kernel_f_block_walk(case, host_lib, warm, bad):
    """The card's block of kernel F on the host: eight 16-thread teams, one
    strip table a block, each team on its region of the NaN-filled block
    and its slice of the scratch, on 12 scenarios (a full block and part of
    the next)."""
    N, solver = case["N"], case["solver"]
    assert host_lib.mpcq_sqp_step_block_scenarios(16, N) == E_PAIR_TEAMS
    assert host_lib.mpcq_sqp_step_lanes(65536, N) == 16 and host_lib.mpcq_sqp_step_lanes(127, N) == 32
    inp = _tiled(case, E_TILE)
    duals = inp["duals"] if warm else None
    ref = sqp_fused_kernel.fused_sqp_step_plain(
        inp["X"], inp["U"], *(inp[k] for k in STEP), inp["aug"], solver.f, solver.cfg.dt,
        *case["w"], ITERS, duals)
    out = _run_f(host_lib, "_block", inp, duals, inp["X"])
    _check_step(case, out, ref)
    assert _same(out, _run_f(host_lib, "32", inp, duals, inp["X"]))
    # a NaN in scenario `bad`; every other scenario's outputs unchanged
    X_bad = inp["X"].clone()
    X_bad[bad, 1, 8] = float("nan")
    out_bad = _run_f(host_lib, "_block", inp, duals, X_bad)
    keep = torch.arange(E_TILE * B) != bad
    assert torch.isnan(out_bad[0][bad]).any()
    assert all(torch.equal(a[keep], b[keep]) for a, b in zip(out_bad, out))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("team", TEAMS)
def test_kernel_f_host_is_kernel_a_then_b(case, host_lib, team, warm):
    """Kernel F's bits are kernel A's linearisation (x+ and J, r = x+ -
    X_{k+1}) fed to kernel B: the "fused" and "hybrid" pipelines agree
    bitwise, whatever F's schedule (its IPM kernel E's, B's ipm_box.cuh's
    bits)."""
    N, aug = case["N"], case["aug"]
    xp, J = torch.empty(B, N, 13, **f64), torch.empty(B, N, 17, 13, **f64)
    consts = _consts(case)
    rc = host_lib.mpcq_lin_host_f64(ptr(case["X"]), ptr(case["U"]), ptr(aug.X), ptr(aug.w),
                                    ptr(aug.L), ptr(aug.sigma_f), aug.X.shape[-1], ptr(xp), ptr(J),
                                    B, N, ptr(consts))
    assert rc == 0
    inp = dict(case, J=J, r=(xp - case["X"][:, 1:]).contiguous())
    duals = case["duals"] if warm else None
    assert _same(_run_f(host_lib, TEAMS[team], case, duals, case["X"]),
                 _run_b(host_lib, TEAMS[team], inp, duals, J))


@pytest.mark.parametrize("nz", [10, 23, 37])
def test_kernel_e_odd_nz_matches_shared_ipm(host_lib, nz):
    rng = np.random.default_rng(nz)
    M = rng.standard_normal((E_TILE, nz, nz))
    H = M @ M.transpose(0, 2, 1) / nz + 0.1 * np.eye(nz)
    box = tuple(torch.tensor(a).contiguous() for a in
                (H, rng.standard_normal((E_TILE, nz)), -rng.uniform(0.1, 1.0, (E_TILE, nz)),
                 rng.uniform(0.1, 1.0, (E_TILE, nz))))
    ref = qp_kernel.ipm_box_solve(*box, ITERS)
    shared = _run_e(host_lib, "", None, None, box[0], entry="mpcq_box_qp_shared_ipm_host32_f64",
                    box=box)
    for team in ("", "32", "_block"):
        out = _run_e(host_lib, team, None, None, box[0], box=box)
        for name, a, b in zip(("z", "zl", "zu"), out, ref):
            err = (a - b).abs().max().item()
            assert err <= 1e-9, f"{team} {name}: {err}"
        if team:
            assert _same(out, shared), team


def test_packed_layout_sizes(host_lib):
    """One nz x (nz + 1) matrix a scenario: kernel B 8,904 B a scenario at
    N = 10 (packed matrix, g, one 13 x nz map, two d vectors; 12,752 B with
    two maps and J's stream buffer, 36,144 B with three matrices and J
    staged), two scenarios a block there; kernel E (8,440 B a scenario
    before, the triangle table in each) a 40 x 44 matrix a scenario (s and z
    in its last two columns) and one table of 220 strips a block: 56,768 B
    for its paired block of eight at nz = 40, which four times fill an SM's
    233,472 B with the 1 KB the card keeps a block; both kernels fit an H100
    block at FUSED_N_MAX = 40."""
    limit = 232_448
    assert host_lib.mpcq_sqp_block_warps(10) == 2
    # two warps a block up to nz = 64 (R = 2 register slots a lane), one past it
    assert (host_lib.mpcq_sqp_block_warps(16), host_lib.mpcq_sqp_block_warps(17)) == (2, 1)
    assert host_lib.mpcq_sqp_ws_bytes(10) == 2 * 4 * (40 * 41 + 40 + 13 * 40 + 26) == 2 * 8_904
    # kernel F at N = 10 (and B >= 3072): eight half-warp teams a block on
    # kernel E's table (112 floats), each team's region the 40 x 44 slot, g,
    # one 13 x 40 map and two d vectors (2,346 floats, rounded up to four);
    # J and the defects in the device scratch (10 x (221 + 13) floats a
    # team, and a spare slice a block)
    assert host_lib.mpcq_sqp_step_lanes(65536, 10) == 16 and host_lib.mpcq_sqp_step_lanes(127, 10) == 32
    assert host_lib.mpcq_sqp_step_block_scenarios(16, 10) == 8
    assert host_lib.mpcq_sqp_step_ws_bytes(10) == 4 * (112 + 8 * (40 * 44 + 40 + 13 * 40 + 26 + 2)) == 75_584
    assert 3 * (75_584 + 1024) <= 233_472 < 4 * (75_584 + 1024)
    assert host_lib.mpcq_sqp_step_scratch_bytes(16, 10) == 9 * 4 * 10 * (221 + 13)
    assert host_lib.mpcq_sqp_step_block_bytes(32, 10) == 4 * (112 + 2_348)
    # kernel E: ld = 44 (a multiple of 4 past nz + 2 with ld / 4 odd), the
    # table 220 strips (columns of four, 40 + 36 + ... + 4 rows) of 16 bits
    # in 28 quads of floats
    table, slot = 4 * 28, 40 * 44
    assert 2 * (40 + 36 + 32 + 28 + 24 + 20 + 16 + 12 + 8 + 4) == 440 <= 4 * table
    assert host_lib.mpcq_box_qp_block_bytes(16, 40) == 4 * (table + 8 * slot) == 56_768
    assert host_lib.mpcq_box_qp_block_bytes(32, 40) == 4 * (table + slot) == 7_488
    assert host_lib.mpcq_box_qp_ws_bytes(40) == 56_768
    assert 4 * (56_768 + 1024) <= 233_472 < 5 * (56_768 + 1024)
    # one warp a scenario past nz = 40, and 16-lane teams refused there
    assert host_lib.mpcq_box_qp_block_scenarios(16, 44) == 0
    assert host_lib.mpcq_box_qp_ws_bytes(68) == host_lib.mpcq_box_qp_block_bytes(32, 68)
    assert host_lib.mpcq_sqp_ws_bytes(10) // 2 <= 9 * 1024
    # at N = 40 one scenario a block, its map region the IPM's vectors and table
    # (2 * 160 + 12,720 // 2) and the solution (160), past the 13 x 160 map
    n = sqp.FUSED_N_MAX
    assert host_lib.mpcq_sqp_block_warps(n) == 1
    assert host_lib.mpcq_sqp_ws_bytes(n) == 4 * (160 * 161 + 160 + (2 * 160 + 6_360 + 160) + 26) == 131_144
    assert host_lib.mpcq_sqp_step_ws_bytes(n) == 4 * (1_640 + 160 * 164 + 160 + 13 * 160 + 26 + 2) == 120_592
    assert host_lib.mpcq_sqp_step_ws_bytes(n) <= limit
    # kernel E's own ceiling, nz = 214 before: nz = 229 (232 rows of ld = 236
    # and 6,670 strips), one warp a block
    assert host_lib.mpcq_box_qp_ws_bytes(214) <= limit
    assert host_lib.mpcq_box_qp_ws_bytes(229) == 4 * 232 * 236 + 13_344 <= limit
    assert host_lib.mpcq_box_qp_ws_bytes(230) > limit
