"""Package-level properties of the PyTorch port: it imports with JAX and the
JAX package blocked (every module, the run CLI's and the multi-process
farm's by name), one rank of the farm runs with them blocked, and the
CUDA-gated test modules import so; CPU tensors take the plain versions (no kernel
launch), parameters cross over from the JAX package intact, and
``chip_smoke.py`` fails alone.  The CUDA wrappers' checks and the run
without a GPU are in ``test_torch_cuda_kernels.py`` and
``test_torch_cuda_paths.py``."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.models import fold_drag, make_mpc_dynamics
from mpc_quad_ros_tpu_torch.ops.cuda import lin_kernel, sqp_fused_kernel
from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver, init_carry

from test_torch_common import as_numpy, jax_params, jax_rgp, port_params, rgp_batch, solve_inputs, t

REPO = pathlib.Path(__file__).resolve().parents[1]


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


# a meta-path finder that refuses JAX and the JAX package, installed before
# anything else is imported
BLOCK_JAX = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'mpc_quad_ros_tpu'):\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n")
# the run CLI's modules, imported by name besides the walk of the package
ENTRY_MODULES = ("run", "compare", "explore", "explorer", "traj", "traj.native_minsnap",
                 "io.viz", "io.profiling", "io.config", "utils.metrics", "node", "hello_world",
                 "scripts", "scripts_viz_parity", "io.transport", "parallel", "parallel.mesh",
                 "parallel.distributed", "parallel.launch", "parallel.mp_worker", "entry",
                 "bench.parity", "bench.parity_matrix", "bench.comparison_artifact")


def _run_blocked(code: str, cwd=REPO):
    out = subprocess.run([sys.executable, "-c", BLOCK_JAX + code], cwd=cwd, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil\n"
            "import mpc_quad_ros_tpu_torch as p\n"
            f"for m in {ENTRY_MODULES!r}:\n"
            "    importlib.import_module(p.__name__ + '.' + m)\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'mpc_quad_ros_tpu.')))\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    assert _run_blocked(code).strip().endswith("CLEAN")


def test_worker_rank_runs_with_jax_blocked(tmp_path):
    """One rank of the multi-process farm (a world of one, on the CPU) runs
    its solve and episode leg with JAX and the JAX package blocked."""
    code = ("from mpc_quad_ros_tpu_torch.parallel import mp_worker\n"
            f"mp_worker.main(['--init-method', {(tmp_path / 'rdv').as_uri()!r}, "
            "'--num-processes', '1', '--process-id', '0', '--global-batch', '4', "
            "'--qp-iters', '2', '--ticks', '1', '--device', 'cpu'])\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'mpc_quad_ros_tpu.')))\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    out = _run_blocked(code)
    assert "backend gloo" in out and out.strip().endswith("CLEAN")


def test_cuda_test_modules_import_without_jax():
    """The CUDA-gated test modules collect where JAX is absent."""
    code = ("import importlib\n"
            "sys.path.insert(0, 'tests')\n"
            "for m in ('test_torch_cuda_common', 'test_torch_cuda_kernels', 'test_torch_cuda_paths'):\n"
            "    importlib.import_module(m)\n"
            "print('CLEAN')\n")
    assert _run_blocked(code).strip().endswith("CLEAN")
    with pytest.raises(AssertionError, match="blocked"):
        _run_blocked("import sys; sys.path.insert(0, 'tests'); import test_torch_common\n")


def test_cpu_tensors_take_the_plain_versions():
    lin_kernel.linearize.launches = 0
    sqp_fused_kernel.fused_sqp_from_J.launches = 0
    inp = solve_inputs(2, seed=31)
    cfg = MPCConfig(u_ref=float(jax_params().hover_input))
    solver = SQPSolver(cfg, make_mpc_dynamics(port_params()))
    x0, y_ref = t(inp["x0"]), t(inp["y_ref"])
    _, sol = solver.solve_batch(init_carry(cfg, x0), x0, y_ref, y_ref[:, -1],
                                interop.rgp_state_from_numpy(inp["rgp"]))
    assert torch.isfinite(sol.U).all() and sol.U.shape == (2, 10, 4)
    assert lin_kernel.linearize.launches == 0
    assert sqp_fused_kernel.fused_sqp_from_J.launches == 0


@pytest.mark.parametrize("batched", [False, True])
def test_interop_round_trip(batched):
    import jax.numpy as jnp

    from mpc_quad_ros_tpu.models.augmented import fold_drag as jax_fold_drag

    rng = np.random.default_rng(0)
    jp = as_numpy(jax_params())
    rgp = rgp_batch(3, rng)
    if not batched:
        rgp = {k: v[0, 0] for k, v in rgp.items()}
    else:
        jp = {k: np.broadcast_to(v, (3,) + v.shape).copy() for k, v in jp.items()}
    p = interop.quad_params_from_numpy(jp)
    r = interop.rgp_state_from_numpy(rgp)
    for src, rec in ((jp, p), (rgp, r)):
        back = interop.to_numpy(rec)
        assert back.keys() == src.keys()
        for k in src:
            np.testing.assert_array_equal(back[k], src[k])
            assert back[k].dtype == np.float64
    ref = jax_fold_drag(jax_rgp(rgp))
    ours = fold_drag(r)
    for k in ("X", "w", "L", "sigma_f"):
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)), rtol=1e-12)
    assert float(p.hover_input.flatten()[0]) == float(jnp.asarray(jax_params().hover_input))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_clean_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
