"""The port's data-parallel mesh (``parallel/mesh.py``) on the CPU against the
JAX package's, float64.

- ``build_inputs`` of the port's worker is bitwise the JAX worker's;
- an 8-shard CPU mesh's closed-loop episode step (``tests/test_parallel.py::
  make_batch``'s inputs: RGP on, hover at 3 m to random targets; 16
  episodes, two a shard, cut to 3 ticks of its 12) equals the port's
  unsharded step bitwise (the per-scenario solve reduces across no
  scenario; at one episode a shard the CPU's batch-1 products in the IPM's
  tensor code round differently, 3.7e-12 to 9.8e-12 in U, measured) and
  the JAX ``sharded_step_fn`` on its 8 virtual devices within 1e-9 (states)
  and 1e-9 relative (the summed metric, whose order of summation differs);
- a batch the mesh does not divide raises, and so does a mesh of cards
  where there is none;
- ``bench/suite.py::scaling`` runs its rows on CPU shards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu.loop import run_episode as jax_run_episode
from mpc_quad_ros_tpu.parallel import make_mesh as jax_make_mesh
from mpc_quad_ros_tpu.parallel import shard_episode_batch as jax_shard
from mpc_quad_ros_tpu.parallel import sharded_step_fn as jax_sharded_step_fn
from mpc_quad_ros_tpu.parallel.mp_worker import build_inputs as jax_build_inputs
from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.bench import suite
from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode
from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
from mpc_quad_ros_tpu_torch.parallel import (make_mesh, shard_episode_batch, sharded_step_fn)
from mpc_quad_ros_tpu_torch.parallel.mp_worker import build_inputs

from test_parallel import make_batch
from test_torch_common import as_numpy, port_params

B, TICKS = 16, 3
X_TOL = 1e-9


@pytest.mark.parametrize("global_B,n_nodes", [(1024, 10), (37, 5)])
def test_build_inputs_bitwise_the_jax_workers(global_B, n_nodes):
    for ours, ref in zip(build_inputs(global_B, n_nodes), jax_build_inputs(global_B, n_nodes)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


def port_step(batch):
    """The port's twin of test_parallel's episode step, cut to TICKS."""
    p = port_params()
    cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(p.hover_input)))
    solver = SQPSolver(cfg.mpc, make_mpc_dynamics(p))
    x0, traj, rgp = batch
    _, outs = run_episode(cfg, solver, p, x0, traj, TICKS, rgp0=rgp)
    err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
    return outs, {"sq_err_sum": (err**2).sum(),
                  "count": torch.tensor(float(x0.shape[0]), dtype=torch.float64)}


@pytest.fixture(scope="module")
def episode_batches():
    cfg, solver, p, x0, x_traj, rgp, _ = make_batch(B)

    def jax_step(batch):
        x0, traj, rgp = batch
        _, outs = jax.vmap(lambda a, b, r: jax_run_episode(cfg, solver, p, a, b, TICKS, rgp0=r))(
            x0, traj, rgp)
        err = outs.x_odom[..., :3] - outs.x_ref[..., :3]
        return outs, {"sq_err_sum": jnp.sum(err**2), "count": jnp.asarray(float(x0.shape[0]))}

    mesh = jax_make_mesh(8)
    jax_outs, jax_metrics = jax.jit(jax_sharded_step_fn(mesh, jax_step))(
        jax_shard(mesh, (x0, x_traj, rgp)))
    ours = (torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(x_traj)),
            interop.rgp_state_from_numpy(as_numpy(rgp)))
    return ours, jax_outs, jax_metrics


def test_sharded_episode_step_matches_unsharded_and_jax(episode_batches):
    batch, jax_outs, jax_metrics = episode_batches
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and all(d.type == "cpu" for d in mesh.devices)
    outs, metrics = sharded_step_fn(mesh, port_step)(shard_episode_batch(mesh, batch))
    ref, ref_metrics = port_step(batch)

    for k in ("x_odom", "w_odom", "x_pred_odom", "rgp_mu_g_t"):
        assert torch.equal(getattr(outs, k), getattr(ref, k)), k
    assert float(metrics["count"]) == B
    np.testing.assert_allclose(float(metrics["sq_err_sum"]), float(ref_metrics["sq_err_sum"]),
                               rtol=1e-12)

    assert outs.x_odom.shape == (B, TICKS, 13)
    np.testing.assert_allclose(outs.x_odom.numpy(), np.asarray(jax_outs.x_odom), rtol=0,
                               atol=X_TOL)
    np.testing.assert_allclose(float(metrics["sq_err_sum"]), float(jax_metrics["sq_err_sum"]),
                               rtol=X_TOL)
    assert float(jax_metrics["count"]) == B


def test_uneven_batch_raises():
    mesh = make_mesh(8, device="cpu")
    x0 = torch.zeros(4, 13)
    step = sharded_step_fn(mesh, lambda b: (b[0], {"n": torch.tensor(float(b[0].shape[0]))}))
    with pytest.raises(ValueError, match="does not divide"):
        step((x0,))
    with pytest.raises(ValueError, match="does not divide"):
        shard_episode_batch(mesh, (x0,))


def test_even_batch_shards_are_contiguous_blocks():
    mesh = make_mesh(4, device="cpu")
    x = torch.arange(8.0)[:, None]
    sb = shard_episode_batch(mesh, {"x": x})
    assert sb.rows == 8
    assert [s["x"][:, 0].tolist() for s in sb.shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    out, m = sharded_step_fn(mesh, lambda b: (b["x"] * 2, {"n": b["x"].sum()}))(sb)
    assert torch.equal(out, x * 2) and float(m["n"]) == 28.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        make_mesh(2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        suite.scaling(2)


def test_scaling_rows_on_cpu_shards():
    rows = suite.scaling(2, episodes_per_device=2, ticks=2, device="cpu", reps=1)
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["episodes"] for r in rows] == [2, 4]
    for r in rows:
        assert r["tick_solves_per_s"] > 0 and np.isfinite(r["sq_err_sum"])
    assert rows[0]["weak_scaling_efficiency"] == 1.0
