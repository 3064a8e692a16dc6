"""The port's paths on a CUDA device (each test skips without one): the
solves through each pipeline and backend with their launch counts, the
loops in gp2 and gp1, the per-scenario solve, the GP fit, the node's ticks
and the takeoff-and-land demo, each in f32 on the card against the CPU's
f64; two ranks of the multi-process farm sharing the card; and, where there is no card, the entry points
refusing to run and ``chip_smoke.py`` failing.  JAX-free, so that it
collects on the GPU host:

    python -m pytest tests/test_torch_cuda_*.py -q

Each test keeps the checks and tolerances it had beside the path's CPU tests,
on the same seeds; the inputs come from the port's own parameters and RGP
(``test_torch_cuda_common``)."""

import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.hello_world import hello_world
from mpc_quad_ros_tpu_torch.io import Logger, save_dict
from mpc_quad_ros_tpu_torch.loop import (EpisodeConfig, run_episode, run_episode_batch,
                                         run_episode_batch_fused)
from mpc_quad_ros_tpu_torch.models import GPEnsemble, make_mpc_dynamics, params
from mpc_quad_ros_tpu_torch.models import gp as tgp
from mpc_quad_ros_tpu_torch.models import train as ttrain
from mpc_quad_ros_tpu_torch.models.gp import gp_init
from mpc_quad_ros_tpu_torch.node import ControllerNode, SimLoop, TrajectoryServer
from mpc_quad_ros_tpu_torch.ops import qp
from mpc_quad_ros_tpu_torch.ops.cuda import (condense_kernel, lin_kernel, qp_kernel,
                                             riccati_kernel, sqp_fused_kernel)
from mpc_quad_ros_tpu_torch.ops.sqp import (FUSED_N_MAX, SMALL_BATCH, MPCConfig, SQPSolver,
                                            init_carry)
from mpc_quad_ros_tpu_torch.utils.containers import stack_records

from test_torch_cuda_common import (box_qp, circle, fleet_params, hover_input, params_numpy,
                                    port_params, require_cuda, rgp_batch, solve_inputs, t)

REPO = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = (lin_kernel.linearize, sqp_fused_kernel.fused_sqp_from_J,
            riccati_kernel.riccati_ipm_from_J, condense_kernel.condense_cost_from_J,
            qp_kernel.solve_box_qp_pdip_batch, sqp_fused_kernel.fused_sqp_step,
            condense_kernel.condense_cost_from_AB)


def _solve(inp, carry=None, params=None, **cfg_kw):
    """One port solve of `inp` (carry from init_carry unless given)."""
    params = port_params() if params is None else params
    kw = dict(dtype=params.mass.dtype, device=params.mass.device)
    cfg = MPCConfig(u_ref=float(params.hover_input.flatten()[0]), **cfg_kw)
    solver = SQPSolver(cfg, make_mpc_dynamics(params))
    x0, y_ref = t(inp["x0"]).to(**kw), t(inp["y_ref"]).to(**kw)
    rgp = interop.rgp_state_from_numpy(inp["rgp"], **kw)
    carry = init_carry(solver.cfg, x0) if carry is None else carry
    return solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)


# ---------------------------------------------------------------- solves

def test_cuda_solve_runs_both_kernels():
    dev = require_cuda()
    lin_kernel.linearize.launches = 0
    sqp_fused_kernel.fused_sqp_from_J.launches = 0
    inp = solve_inputs(SMALL_BATCH, seed=32)     # smaller batches take kernels A, J, E
    p = port_params().map(lambda a: a.float().to(dev))
    cfg = MPCConfig(u_ref=float(p.hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    x0, y_ref = t(inp["x0"]).float().to(dev), t(inp["y_ref"]).float().to(dev)
    rgp = interop.rgp_state_from_numpy(inp["rgp"], device=dev, dtype=torch.float32)
    _, sol = solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1], rgp)
    torch.cuda.synchronize()
    assert torch.isfinite(sol.U).all()
    assert lin_kernel.linearize.launches == 1 and sqp_fused_kernel.fused_sqp_from_J.launches == 1


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("pipeline, batch, launched", [
    ("split", SMALL_BATCH, [1, 0, 0, 1, 1, 0, 0]),
    ("fused", SMALL_BATCH, [0, 0, 0, 0, 0, 1, 0]),
    ("hybrid", 64, [1, 0, 0, 0, 1, 0, 1])])
def test_cuda_pipeline_launches_its_kernels(pipeline, batch, launched, warm):
    dev = require_cuda()
    inp = solve_inputs(batch, seed=87)
    p32 = port_params().map(lambda a: a.float().to(dev))
    for fn in COUNTERS:
        fn.launches = 0
    kw = dict(pipeline=pipeline, warm_start_duals=warm)
    carry, sol = _solve(inp, params=p32, **kw)
    _, sol = _solve(inp, carry, params=p32, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in COUNTERS] == [2 * n for n in launched]
    # U + z in f32 may pass the box by an ulp: z = clip(z', lb/s, ub/s) s
    # rounds, in every pipeline and in the JAX kernels alike
    assert torch.isfinite(sol.U).all() and -1e-6 <= sol.U.min() and sol.U.max() <= 1 + 1e-6
    # the f32 card's first solve against the f64 plain versions on the CPU
    _, ref = _solve(inp, **kw)
    _, first = _solve(inp, params=p32, **kw)
    assert (first.U.double().cpu() - ref.U).abs().max() < 4e-2


@pytest.mark.parametrize("N", [FUSED_N_MAX + 1, 80, 160])
def test_cuda_solve_batch_riccati_runs_kernels_a_and_c(N):
    dev = require_cuda()
    inp = solve_inputs(64, seed=43, N=N)
    p = port_params().map(lambda a: a.float().to(dev))
    counters = (lin_kernel.linearize, sqp_fused_kernel.fused_sqp_from_J,
                riccati_kernel.riccati_ipm_from_J)
    for fn in counters:
        fn.launches = 0
    cfg = MPCConfig(n_nodes=N, t_horizon=0.1 * N, u_ref=float(p.hover_input), qp_method="pdip")
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    x0, y_ref = t(inp["x0"]).float().to(dev), t(inp["y_ref"]).float().to(dev)
    rgp = interop.rgp_state_from_numpy(inp["rgp"], device=dev, dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, sol = solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1], rgp)
    torch.cuda.synchronize()
    assert torch.isfinite(sol.U).all() and torch.isfinite(sol.kkt_residual).all()
    assert bool(((sol.U >= 0) & (sol.U <= 1)).all())
    # kernel A twice (the step and the KKT's adjoint), kernel C once, B never
    assert [fn.launches for fn in counters] == [2, 0, 1]


def test_solve_on_cuda_matches_cpu_f64():
    """The card's f32 solve (kernels A and J, the unscaled IPM in tensor
    code) against the CPU's f64 solve, at the bound of the card's checks."""
    dev = require_cuda()
    inp = solve_inputs(4, seed=39)
    sols = {}
    for device, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        p = params.hummingbird_params(torch.float32).map(lambda a: a.to(device, dtype))
        cfg = MPCConfig(u_ref=float(p.hover_input))
        solver = SQPSolver(cfg, make_mpc_dynamics(p))
        cast = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device, dtype)
        x0, y_ref = cast(inp["x0"]), cast(inp["y_ref"])
        rgp = interop.rgp_state_from_numpy(inp["rgp"]).map(lambda a: a.float().to(device, dtype))
        _, sols[device] = solver.solve(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1], rgp)
    assert (sols[dev].U.double().cpu() - sols["cpu"].U).abs().max().item() < 4e-2


def test_pdip_on_cuda_matches_cpu_f64():
    """The unscaled IPM in f32 on the card against f64 on the CPU."""
    dev = require_cuda()
    p = box_qp(40, seed=70)
    args = [p[k] for k in ("H", "g", "lb", "ub")]
    z = qp.solve_box_qp_pdip(*(t(a).float().to(dev) for a in args), 12)
    z_d = qp.solve_box_qp_pdip(*map(t, args), 12)
    assert (z.double().cpu() - z_d).abs().max().item() < 4e-2


# ---------------------------------------------------------------- loops

def _hetero_inputs():
    """Three episodes at v_max 4, 8, 12 m/s whose circles last 1.6, 1.0 and
    0.7 s at 0.1 s samples (17, 11, 8 samples), padded to 17 with the last
    sample; per-episode randomised drag, hover at 3 m, the RGP prior."""
    lens = (17, 11, 8)
    trajs = [circle(v, t_max=(n - 0.5) * 0.1) for v, n in zip((4.0, 8.0, 12.0), lens)]
    trajs = np.stack([np.concatenate([c, np.repeat(c[-1:], 17 - len(c), 0)]) for c in trajs])
    rng = np.random.default_rng(7)
    pb = fleet_params(3, rng, params_numpy())
    x0 = np.zeros((3, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    return dict(params=pb, x0=x0, rgp=rgp_batch(3, rng, mu_scale=0.0)), trajs, torch.tensor(lens)


@pytest.mark.parametrize("path", ["episode", "episode_batch", "hetero"])
def test_loops_on_cuda_match_cpu_f64(path):
    """Five ticks of each card path in f32 against the CPU's f64, within
    1e-2.  The heterogeneous fused batch is held to the larger of 1e-2 and
    twice the f32 plain version's own error against f64 on the CPU: its
    12-iteration Jacobi-scaled IPM has an f32 floor on the body rates above
    1e-2 on these inputs (kernel A's rule at the fitted GP)."""
    dev = require_cuda()
    inp, traj, lens = _hetero_inputs()
    runs = [("cpu", torch.float64), (dev, torch.float32)]
    if path == "hetero":
        runs.append(("cpu", torch.float32))
    outs = {}
    for device, dtype in runs:
        to = lambda a: a.to(device, dtype)
        p = interop.quad_params_from_numpy(inp["params"]).map(to)
        rgp = interop.rgp_state_from_numpy(inp["rgp"]).map(to)
        solver = SQPSolver(MPCConfig(u_ref=hover_input()), make_mpc_dynamics(port_params().map(to)))
        cfg = EpisodeConfig(mpc=solver.cfg)
        x0, tr = to(t(inp["x0"])), to(t(traj))
        if path == "episode":
            _, outs[device, dtype] = run_episode(cfg, solver, p.map(lambda a: a[0]), x0[0],
                                                 tr[0], 5, rgp.map(lambda a: a[0]))
        elif path == "episode_batch":
            _, outs[device, dtype] = run_episode_batch(cfg, solver, p, x0, tr, 5, rgp)
        else:
            _, outs[device, dtype] = run_episode_batch_fused(cfg, solver, p, x0, tr, 5, rgp,
                                                             traj_len=lens,
                                                             episode_ticks=torch.tensor((5, 3, 2)))
    err = lambda key: (outs[key].x_odom.double().cpu() - outs["cpu", torch.float64].x_odom
                       ).abs().max().item()
    bound = 1e-2
    if path == "hetero":
        bound = max(bound, 2 * err(("cpu", torch.float32)))
    assert err((dev, torch.float32)) < bound


def _gp1_state():
    """The GP of each axis on ten samples over +-8 m/s of the plant's body
    drag a = -(aero v|v| + rotor v) / m, theta (5, 4, 0.01)."""
    p = params_numpy()
    X = np.random.default_rng(11).uniform(-8.0, 8.0, (3, 10))
    y = -(p["aero_drag"] * X * np.abs(X) + p["rotor_drag"][:, None] * X) / p["mass"]
    theta = torch.tensor((5.0, 4.0, 0.01), dtype=torch.float64)
    return stack_records([gp_init(t(X[d]), t(y[d]), theta) for d in range(3)])


@pytest.mark.parametrize("path", ["episode_batch", "fused"])
def test_gp1_loops_on_cuda_match_cpu_f64(path):
    """Five ticks of each gp1 loop on the card in f32 (the GP folded in f64,
    then cast) against the CPU's f64."""
    dev = require_cuda()
    rng = np.random.default_rng(5)
    pb = fleet_params(4, rng, params_numpy())
    x0 = np.zeros((4, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    traj = np.broadcast_to(circle(8.0), (4, 100, 13)).copy()
    outs = {}
    for device, dtype in (("cpu", torch.float64), (dev, torch.float32)):
        to = lambda a: a.to(device, dtype)
        p = interop.quad_params_from_numpy(pb).map(to)
        gp = _gp1_state().map(lambda a: a.to(device))
        solver = SQPSolver(MPCConfig(u_ref=hover_input()), make_mpc_dynamics(port_params().map(to)))
        loop = run_episode_batch if path == "episode_batch" else run_episode_batch_fused
        _, outs[device] = loop(EpisodeConfig(mpc=solver.cfg), solver, p, to(t(x0)), to(t(traj)), 5,
                               gp_aug=gp)
    err = (outs[dev].x_odom.double().cpu() - outs["cpu"].x_odom).abs().max().item()
    assert err < 1e-2


# ---------------------------------------------------------------- the node

def _node_flight(device, dtype, ticks: int) -> ControllerNode:
    """`ticks` odometry ticks of the gp2 node at the ROS shapes (hummingbird,
    N=5, 20 basis vectors, 100 Hz) from hover on the default circle."""
    p = port_params()
    node = ControllerNode(p, TrajectoryServer(), use_gp=2, dtype=dtype, device=device)
    x_hover = np.array([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)
    SimLoop(node, p, x_hover).run(max_ticks=ticks)
    return node


def test_node_ticks_on_cuda_match_cpu_f64():
    """Five node ticks on the card in f32 (kernels A and J, once a tick)
    against the CPU's f64, within 1e-2 (the loops' rule)."""
    dev = require_cuda()
    for fn in COUNTERS:
        fn.launches = 0
    card = _node_flight(dev, torch.float32, 5)
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in COUNTERS if fn.launches}
    assert launched == {"linearize": 5, "condense_cost_from_AB": 5}
    assert card.rgp_state.mu_g.device.type == "cuda"
    cpu = _node_flight("cpu", torch.float64, 5)
    a, b = (np.asarray(n.logger.dictionary["x_odom"]) for n in (card, cpu))
    assert a.shape == b.shape == (5, 13)
    assert np.abs(a - b).max() < 1e-2


def test_hello_world_on_cuda():
    """The takeoff and landing on the card: both within 0.05 m."""
    res = hello_world(device=require_cuda(), verbose=False)
    assert res["takeoff"]["error_m"] < 0.05 and res["land"]["error_m"] < 0.05


# ---------------------------------------------------------------- the GP fit

def test_gp_fit_on_cuda_matches_cpu():
    """The fit on the card (float64, one host transfer an evaluation)
    against the CPU's."""
    dev = require_cuda()
    rng = np.random.default_rng(0)
    X = rng.uniform(-8.0, 8.0, (3, 10))
    y = -0.42 * X * np.abs(X) + 0.1 * rng.standard_normal((3, 10))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    for d in range(3):
        cpu = tgp.gp_fit(t(X[d]), t(y[d]))
        card = tgp.gp_fit(t(X[d]).to(dev), t(y[d]).to(dev))
        assert card.theta.device.type == "cuda"
        assert rel(card.theta.cpu(), cpu.theta) <= 1e-6


# ---------------------------------------------------------------- two ranks

def test_two_ranks_on_one_card():
    """The multi-process farm's two ranks on ``cuda:0`` over gloo (NCCL
    refuses two ranks on one card), global batch 256 (128 a rank: kernels A
    and B; the episode leg A and D), 2 chained solves and 1 tick: each
    rank's rows against the single-process card run of the same scenarios
    within kernel B's 4e-2 and the routing discriminator, the reduced sums
    the same on both ranks and within 1e-5 of the single-process sums."""
    from mpc_quad_ros_tpu_torch.parallel import mp_worker
    from mpc_quad_ros_tpu_torch.parallel.launch import launch_workers

    dev = require_cuda()
    B = 256
    res = launch_workers(nproc=2, global_batch=B, qp_iters=12, chain=2, ticks=1, device="cuda")
    p, cfg, solver, rgp1 = mp_worker.solver_setup(12, dev)
    x0, y_ref, ref = (t(a).to(dev) for a in mp_worker.build_inputs(B, cfg.n_nodes))
    rgp = mp_worker.batch_rgp(rgp1, B)
    carry = init_carry(cfg, x0)
    for _ in range(2):
        carry, sol = solver.solve_batch(carry, x0, y_ref, ref, rgp)
    U = sol.U.cpu().numpy()
    for rank, r in enumerate(res):
        assert str(r["backend"]) == "gloo" and str(r["device"]) == "cuda:0"
        assert int(r["launches_solve_lin_kernel"]) > 0 and int(r["launches_solve_sqp_fused_kernel"]) > 0
        assert int(r["launches_episode_lin_kernel"]) > 0 and int(r["launches_episode_condense_kernel"]) > 0
        rows = U[rank * B // 2:(rank + 1) * B // 2]
        gap = float(np.abs(r["U_local"] - rows).max())
        assert gap <= 4e-2, gap
        shifted = float(np.abs(r["U_local"] - np.roll(rows, 1, axis=0)).mean())
        assert shifted > 10 * max(float(np.abs(r["U_local"] - rows).mean()), 1e-7)
        assert np.isfinite(r["ep_x_local"]).all()
    for k in ("kkt_sum", "cost_sum", "n", "ep_sq_err_sum", "ep_n"):
        assert float(res[0][k]) == float(res[1][k]), k
    np.testing.assert_allclose(float(res[0]["cost_sum"]), float(sol.cost.sum()), rtol=1e-5)


# ---------------------------------------------------------------- without a card

@pytest.fixture
def log_path(tmp_path):
    """A five-tick gp2 flight of one hummingbird, logged."""
    solver = SQPSolver(MPCConfig(u_ref=hover_input()), make_mpc_dynamics(port_params()))
    x0 = torch.zeros(13, dtype=torch.float64)
    x0[3], x0[2] = 1.0, 3.0
    rgp = interop.rgp_state_from_numpy(rgp_batch(1, np.random.default_rng(0), mu_scale=0.0))
    _, outs = run_episode(EpisodeConfig(mpc=solver.cfg), solver, port_params(), x0,
                          t(circle(8.0)), 5, rgp.map(lambda a: a[0]))
    path = str(tmp_path / "flight.pkl")
    t_odom = torch.arange(5, dtype=torch.float64) * solver.cfg.dt
    save_dict(Logger.from_episode(outs, t_odom=t_odom).dictionary, path)
    return path


def test_entry_points_default_to_the_card(log_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPEnsemble.fromrange([(-1.0, 1.0)] * 3, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_gp(log_path, str(tmp_path / "c"), 4, plot=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_rgp(log_path, str(tmp_path / "c"), 4, plot=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["gp", "--data", log_path, "--save_dir", str(tmp_path / "c"), "--no_plot"])


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
