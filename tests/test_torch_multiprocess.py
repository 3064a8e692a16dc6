"""The port's multi-process scenario farm (``parallel/{distributed,mp_worker,
launch}.py``) on the CPU: two gloo processes against the port's
single-process run of the same ``build_inputs`` scenarios.

The global batch is 256, so each rank's 128 scenarios take the hybrid route
(kernels A and B from ``SMALL_BATCH`` = 128; their plain versions here),
12 IPM iterations, a chain of 3 warm-started solves, and 2 ticks of the
closed-loop RGP-learning leg (``run_episode`` on the rank's batch).  No
kernel and no plain version reduces across scenarios, and the CPU's
products round alike at 128 and 256 rows: each rank's rows equal the
single-process rows bitwise (measured gap 0 in U, cost and the leg's
states), checked with ``tests/test_multiprocess.py``'s routing
discriminator on top.  The all-reduced sums are identical on both ranks and
within f32 summation order (rtol 1e-6; measured 8e-8) of the single-process
sums.  The worker on ``--device cuda`` without a card raises.

The slow tier holds the port's 2-process run at the JAX test's own size
(global batch 1024, 3 ticks) against that test's single-process JAX oracle
with its tolerances (3e-2 on U, 6e-2 on the leg's states, 1e-3 on the cost
sum)."""

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch.bench import suite
from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode
from mpc_quad_ros_tpu_torch.ops.sqp import init_carry
from mpc_quad_ros_tpu_torch.parallel import mp_worker
from mpc_quad_ros_tpu_torch.parallel.launch import launch_workers, summary

GLOBAL_B, QP_ITERS, CHAIN, TICKS = 256, 12, 3, 2
SUM_RTOL = 1e-6


def _assert_rows_match(a, ref, slack, label):
    """``tests/test_multiprocess.py``'s check: closeness at `slack`, and each
    row nearer its own oracle row than a shifted assignment."""
    np.testing.assert_allclose(a, ref, rtol=0, atol=slack, err_msg=label)
    direct = float(np.abs(a - ref).mean())
    shifted = float(np.abs(a - np.roll(ref, 1, axis=0)).mean())
    assert shifted > 10 * max(direct, 1e-7), (label, direct, shifted)


def single_process(global_B: int, ticks: int):
    """The same computation in this process: the chained solves and the
    episode leg over the whole batch."""
    dev = torch.device("cpu")
    p, cfg, solver, rgp1 = mp_worker.solver_setup(QP_ITERS, dev)
    x0, y_ref, ref = (torch.as_tensor(a) for a in mp_worker.build_inputs(global_B, cfg.n_nodes))
    rgp = mp_worker.batch_rgp(rgp1, global_B)
    carry = init_carry(cfg, x0)
    for _ in range(CHAIN):
        carry, sol = solver.solve_batch(carry, x0, y_ref, ref, rgp)
    _, outs = run_episode(EpisodeConfig(mpc=cfg), solver, p, x0,
                          torch.as_tensor(mp_worker.episode_inputs(global_B)), ticks, rgp0=rgp)
    return sol, outs


@pytest.fixture(scope="module")
def runs():
    res = launch_workers(nproc=2, global_batch=GLOBAL_B, qp_iters=QP_ITERS, chain=CHAIN,
                         ticks=TICKS, device="cpu")
    return res, single_process(GLOBAL_B, TICKS)


def test_two_process_rows_match_single_process(runs):
    res, (sol, outs) = runs
    half = GLOBAL_B // 2
    for rank, r in enumerate(res):
        assert int(r["process_id"]) == rank and int(r["slice_start"]) == rank * half
        assert str(r["backend"]) == "gloo" and str(r["device"]) == "cpu"
        rows = slice(rank * half, (rank + 1) * half)
        assert r["U_local"].shape == (half, 10, 4)
        np.testing.assert_array_equal(r["U_local"], sol.U[rows].numpy())
        np.testing.assert_array_equal(r["cost_local"], sol.cost[rows].numpy())
        _assert_rows_match(r["U_local"].reshape(half, -1), sol.U[rows].numpy().reshape(half, -1),
                           0.0, f"rank {rank} U")
        # CPU tensors take the plain versions: no launch
        assert not any(int(v) for k, v in r.items() if k.startswith("launches_"))


def test_reduced_sums_agree_across_ranks_and_with_single_process(runs):
    (r0, r1), (sol, _) = runs
    for k in ("kkt_sum", "cost_sum", "n", "ep_sq_err_sum", "ep_n"):
        assert float(r0[k]) == float(r1[k]), k
    assert float(r0["n"]) == GLOBAL_B and float(r0["ep_n"]) == GLOBAL_B
    np.testing.assert_allclose(float(r0["cost_sum"]), float(sol.cost.sum()), rtol=SUM_RTOL)
    np.testing.assert_allclose(float(r0["kkt_sum"]), float(sol.kkt_residual.sum()),
                               rtol=SUM_RTOL)
    assert summary([r0, r1])["backend"] == "gloo"


def test_episode_leg_matches_single_process(runs):
    (r0, r1), (_, outs) = runs
    x = np.concatenate([r0["ep_x_local"], r1["ep_x_local"]])
    assert x.shape == (GLOBAL_B, TICKS, 13) and np.isfinite(x).all()
    np.testing.assert_array_equal(x, outs.x_odom.numpy())
    _assert_rows_match(x.reshape(GLOBAL_B, -1), outs.x_odom.numpy().reshape(GLOBAL_B, -1), 0.0,
                       "episode states")
    err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
    np.testing.assert_allclose(float(r0["ep_sq_err_sum"]), float((err**2).sum()), rtol=SUM_RTOL)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_worker_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        mp_worker.main(["--init-method", (tmp_path / "rdv").as_uri(), "--num-processes", "1",
                        "--process-id", "0", "--global-batch", "8", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_workers(nproc=2, global_batch=8, device="cuda")


def test_scaling_multiprocess_rows_on_cpu():
    res = suite.scaling_multiprocess(nproc=2, batch_per_rank=4, qp_iters=2, repeats=2,
                                     device="cpu")
    rows = res["rows"]
    assert [r["processes"] for r in rows] == [1, 2]
    assert [r["global_batch"] for r in rows] == [4, 8]
    assert all(r["solves_per_s"] > 0 and r["backend"] == "gloo" for r in rows)
    assert "contention" in res["note"]


@pytest.mark.slow
def test_two_process_run_against_the_jax_oracle():
    """The JAX test's size (global batch 1024, 3 ticks) against its
    single-process JAX oracle, with its tolerances."""
    import jax
    import jax.numpy as jnp

    import test_multiprocess as jax_mp
    from mpc_quad_ros_tpu.loop import EpisodeConfig as JaxEpisodeConfig
    from mpc_quad_ros_tpu.loop import run_episode as jax_run_episode

    B = jax_mp.GLOBAL_B
    r0, r1 = launch_workers(nproc=2, global_batch=B, qp_iters=jax_mp.QP_ITERS,
                            chain=jax_mp.CHAIN, ticks=jax_mp.TICKS, device="cpu")
    _, p, cfg, sol, _ = jax_mp._oracle()
    U_ref = np.asarray(sol.U)
    jax_mp._assert_rows_match(r0["U_local"], U_ref[: B // 2], 3e-2, "shard 0")
    jax_mp._assert_rows_match(r1["U_local"], U_ref[B // 2:], 3e-2, "shard 1")
    for r in (r0, r1):
        np.testing.assert_allclose(float(r["cost_sum"]), float(jnp.sum(sol.cost)), rtol=1e-3)
        np.testing.assert_allclose(float(r["kkt_sum"]), float(jnp.sum(sol.kkt_residual)),
                                   rtol=0.5)

    p, cfg, solver, rgp1 = jax_mp._build()
    x0_g, _, _ = mp_worker.build_inputs(B, cfg.n_nodes)
    rgp = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, 3) + a.shape), rgp1)
    ecfg = JaxEpisodeConfig(mpc=cfg)
    _, outs = jax.jit(jax.vmap(
        lambda a, t, r: jax_run_episode(ecfg, solver, p, a, t, jax_mp.TICKS, rgp0=r)
    ))(jnp.asarray(x0_g), jnp.asarray(mp_worker.episode_inputs(B)), rgp)
    x_mp = np.concatenate([r0["ep_x_local"], r1["ep_x_local"]])
    jax_mp._assert_rows_match(x_mp.reshape(B, -1), np.asarray(outs.x_odom).reshape(B, -1),
                              6e-2, "episode states")
