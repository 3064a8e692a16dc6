"""Entry points: one solve of the flagship model, and the multi-device dry run.

Counterpart of the root ``__graft_entry__.py`` (``entry``, ``dryrun_multichip``).

- ``entry()`` returns ``(fn, example_args)``: one warm-started per-scenario
  MPC solve with the online-RGP drag (``SQPSolver.solve`` on one scenario:
  kernels A and J and the unscaled IPM on the card).
- ``dryrun_multichip(n)`` runs the closed-loop learning step and the
  batched solves over an n-shard mesh (``parallel/mesh.py``), then the
  multi-process farm's production configuration (``parallel/launch.py``):
  the tiny episode step, the fused ``solve_batch`` at 128 scenarios a
  shard (kernels A and B), the Riccati ``solve_batch`` at N=12 (kernels A
  and C), and 2 ranks at qp_iters=12 with a warm chain and an episode leg.
  The mesh takes at most the host's cards; where n exceeds them, the n
  shards' work runs on the cards there are and the multi-process phase
  starts n ranks that share the cards over gloo.  It prints what it does,
  and its result with this process's launches (the mesh phases'; the
  ranks count their own).

Both run on the card unless given ``device="cpu"``.

    python -m mpc_quad_ros_tpu_torch.entry [--dryrun N] [--cpu]
"""

from __future__ import annotations

import dataclasses
import json

import torch

from .utils.device import resolve_device


def _build(dtype=torch.float32, device="cuda"):
    from .models import hummingbird_params, make_mpc_dynamics, rgp_init
    from .ops.sqp import MPCConfig, SQPSolver

    dev = resolve_device(device)
    p = hummingbird_params(dtype=dtype, device=dev)
    cfg = MPCConfig(u_ref=float(p.hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(p))
    rgp1 = rgp_init(torch.linspace(-10, 10, 10, dtype=dtype, device=dev), theta=(3.0, 0.1, 0.01))
    rgp = rgp1.map(lambda a: a.expand((3,) + a.shape).contiguous())
    return p, cfg, solver, rgp


def entry(device="cuda", dtype=torch.float32):
    """(fn, example_args): one warm-started MPC solve with RGP drag; fn
    returns (U, X, cost)."""
    from .ops.sqp import SolverCarry, init_carry

    _, cfg, solver, rgp = _build(dtype, device)
    kw = dict(dtype=dtype, device=resolve_device(device))
    x0 = torch.tensor([0, 0, 3, 1, 0, 0, 0, 2, 0, 0, 0, 0, 0], **kw)
    carry = init_carry(cfg, x0)
    y_ref = torch.tensor([1, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], **kw).expand(cfg.n_nodes, 13)

    def fn(carry_X, carry_U, carry_zl, carry_zu, x0, y_ref, rgp_state):
        _, sol = solver.solve(SolverCarry(carry_X, carry_U, carry_zl, carry_zu),
                              x0, y_ref, y_ref[-1], rgp_state)
        return sol.U, sol.X, sol.cost

    return fn, (carry.X, carry.U, carry.zl, carry.zu, x0, y_ref, rgp)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded closed-loop learning step and the batched solves over an
    n-shard mesh, then the 2-process production configuration; returns the
    phases' figures."""
    from .loop import EpisodeConfig, run_episode
    from .models import hummingbird_params, make_mpc_dynamics, rgp_init
    from .ops.sqp import MPCConfig, SQPSolver, init_carry
    from .parallel import make_mesh, shard_episode_batch, sharded_step_fn
    from .parallel.launch import launch_workers
    from .parallel.mp_worker import kernel_counters

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else n_devices
    n_mesh = min(n_devices, cards)
    if n_mesh < n_devices:
        print(f"dryrun_multichip({n_devices}): {cards} card(s): the mesh phases run on "
              f"{n_mesh} shard(s) with the work of {n_devices}; the multi-process phase "
              f"shares the cards between {n_devices} ranks over gloo", flush=True)
    mesh = make_mesh(n_mesh, device=dev.type)
    out = {"n_devices": n_devices, "mesh_shards": n_mesh}
    params = {d: hummingbird_params(dtype=torch.float32, device=d) for d in set(mesh.devices)}
    solvers = {}

    def solver_on(d, cfg: MPCConfig) -> SQPSolver:
        if (d, cfg) not in solvers:
            solvers[d, cfg] = SQPSolver(cfg, make_mpc_dynamics(params[d]))
        return solvers[d, cfg]

    cfg_mpc = MPCConfig(u_ref=float(params[mesh.devices[0]].hover_input))
    rgp1 = rgp_init(torch.linspace(-10, 10, 10), theta=(3.0, 0.1, 0.01))

    # phase 1: the closed-loop learning step, two episodes a shard, 2 ticks
    cfg = EpisodeConfig(mpc=dataclasses.replace(cfg_mpc, qp_iters=4))
    B = n_devices * 2
    T_traj, T_ticks = 6, 2
    x0 = torch.zeros(B, 13)
    x0[:, 3], x0[:, 2] = 1.0, 3.0
    x_traj = x0[:, None].expand(B, T_traj, 13).clone()
    x_traj[:, :, 0] = torch.linspace(0, 1, T_traj)[None, :]
    rgp = rgp1.map(lambda a: a.expand((B, 3) + a.shape).contiguous())

    def step(batch):
        x0, traj, rgp = batch
        d = x0.device
        _, outs = run_episode(cfg, solver_on(d, cfg.mpc), params[d], x0, traj, T_ticks, rgp0=rgp)
        err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
        return outs, {"sq_err_sum": (err**2).sum(), "kkt_max_sum": outs.kkt_residual.sum(),
                      "episodes": torch.tensor(float(x0.shape[0]), device=d)}

    outs, m = sharded_step_fn(mesh, step)(shard_episode_batch(mesh, (x0, x_traj, rgp)))
    if int(m["episodes"]) != B or not bool(torch.isfinite(outs.x_odom).all()):
        raise RuntimeError(f"dryrun_multichip: episode step {m}")
    out["sq_err_sum"] = float(m["sq_err_sum"])
    print(f"dryrun_multichip({n_devices}) OK: {B} episodes x {T_ticks} ticks, "
          f"sq_err_sum={out['sq_err_sum']:.4f}", flush=True)

    # phase 2: the fused throughput path, 128 scenarios a shard, and phase
    # 2b: the Riccati backend at N=12
    Bf = n_devices * 128
    x0f = torch.zeros(Bf, 13)
    x0f[:, 3], x0f[:, 2] = 1.0, 3.0
    x0f[:, 7] += torch.linspace(-2, 2, Bf)
    rgpf = rgp1.map(lambda a: a.expand((Bf, 3) + a.shape).contiguous())
    for name, changes in (("fused", {"qp_iters": 2}),
                          ("riccati", {"n_nodes": 12, "t_horizon": 1.2, "qp_iters": 2,
                                       "qp_method": "riccati"})):
        cfg_s = dataclasses.replace(cfg_mpc, **changes)
        y_ref = x0f[:, None].expand(Bf, cfg_s.n_nodes, 13).contiguous()

        def solve_step(batch, cfg_s=cfg_s):
            c, x, yr, r = batch
            _, sol = solver_on(x.device, cfg_s).solve_batch(c, x, yr, yr[:, -1], r)
            return sol.U, {"kkt_sum": sol.kkt_residual.sum(),
                           "n": torch.tensor(float(x.shape[0]), device=x.device)}

        U, ms = sharded_step_fn(mesh, solve_step)(shard_episode_batch(
            mesh, (init_carry(cfg_s, x0f), x0f, y_ref, rgpf)))
        if int(ms["n"]) != Bf or not bool(torch.isfinite(U).all()):
            raise RuntimeError(f"dryrun_multichip: {name} solve_batch {ms}")
        out[f"{name}_kkt_sum"] = float(ms["kkt_sum"])
        print(f"dryrun_multichip({n_devices}) {name} solve_batch OK: B={Bf} "
              f"({Bf // n_mesh} a shard), N={cfg_s.n_nodes}, kkt_sum={float(ms['kkt_sum']):.3e}",
              flush=True)

    out["launches"] = {k: int(f.launches) for k, f in kernel_counters().items() if f.launches}

    # phase 3: the multi-process farm's production configuration
    if n_devices >= 2 and n_devices % 2 == 0:
        nproc = n_devices if n_devices > cards else 2
        res = launch_workers(nproc=nproc, global_batch=128 * n_devices, qp_iters=12, chain=2,
                             ticks=2, device=dev.type)
        r0 = res[0]
        for r in res[1:]:
            if float(r["kkt_sum"]) != float(r0["kkt_sum"]) or \
                    float(r["ep_sq_err_sum"]) != float(r0["ep_sq_err_sum"]):
                raise RuntimeError("dryrun_multichip: the ranks' reduced sums differ")
        if float(r0["n"]) != 128 * n_devices or float(r0["ep_n"]) != 128 * n_devices:
            raise RuntimeError(f"dryrun_multichip: rank 0 counted {float(r0['n'])} scenarios")
        out.update(processes=nproc, backend=str(r0["backend"]), mp_kkt_sum=float(r0["kkt_sum"]))
        print(f"dryrun_multichip({n_devices}) {nproc}-process OK (qp_iters=12, hybrid, warm "
              f"chain=2 + episode leg) over {out['backend']}: global kkt_sum="
              f"{out['mp_kkt_sum']:.3e} (the same on every rank)", flush=True)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run dryrun_multichip(N) instead of entry()")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    if a.dryrun is not None:
        print(json.dumps(dryrun_multichip(a.dryrun, device=device)), flush=True)
        return 0
    fn, args = entry(device=device)
    outs = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in outs])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
