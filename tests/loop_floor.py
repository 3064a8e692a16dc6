"""Where the f32 error of ``run_episode_batch`` against the CPU's f64 lies, on
the inputs of ``test_torch_cuda_paths.py::test_loops_on_cuda_match_cpu_f64``
(three episodes, five ticks, N=10): its largest |x_odom - x_odom_f64| and
its (episode, tick, state), then the largest by tick and by state.

    python tests/loop_floor.py            # the port: CPU f32, and the card's f32 where there is one
    python tests/loop_floor.py --jax      # the JAX package's run_episode_batch, CPU f32 (imports JAX)

One JSON line per run.  The port's part imports no JAX, so it runs on the
GPU host; ``--jax`` runs the JAX package on the CPU only, as its own tests
run it.
"""

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

TICKS = 5


def breakdown(x: np.ndarray, ref: np.ndarray) -> dict:
    """The error of x_odom (episodes, ticks, 13) against the f64 run's."""
    err = np.abs(x.astype(np.float64) - ref)
    ep, tick, state = np.unravel_index(int(err.argmax()), err.shape)
    return {"max_abs_err": float(err.max()), "episode": int(ep), "tick": int(tick),
            "state": int(state), "by_episode": err.max(axis=(1, 2)).tolist(),
            "at_tick_state_by_episode": err[:, tick, state].tolist(),
            "by_tick": err.max(axis=(0, 2)).tolist(),
            "by_state": err.max(axis=(0, 1)).tolist()}


def port_runs() -> list[dict]:
    import torch

    from mpc_quad_ros_tpu_torch import interop
    from mpc_quad_ros_tpu_torch.loop import EpisodeConfig, run_episode_batch
    from mpc_quad_ros_tpu_torch.models import make_mpc_dynamics
    from mpc_quad_ros_tpu_torch.ops.sqp import MPCConfig, SQPSolver
    from test_torch_cuda_common import hover_input, port_params, t
    from test_torch_cuda_paths import _hetero_inputs

    inp, traj, _ = _hetero_inputs()
    runs = [("cpu", torch.float64), ("cpu", torch.float32)]
    if torch.cuda.is_available():
        runs.append(("cuda", torch.float32))
    outs = {}
    for device, dtype in runs:
        to = lambda a: a.to(device, dtype)
        p = interop.quad_params_from_numpy(inp["params"]).map(to)
        rgp = interop.rgp_state_from_numpy(inp["rgp"]).map(to)
        solver = SQPSolver(MPCConfig(u_ref=hover_input()), make_mpc_dynamics(port_params().map(to)))
        _, out = run_episode_batch(EpisodeConfig(mpc=solver.cfg), solver, p, to(t(inp["x0"])),
                                   to(t(traj)), TICKS, rgp)
        outs[device, dtype] = out.x_odom.double().cpu().numpy()
    ref = outs["cpu", torch.float64]
    rows = []
    for (device, dtype), x in outs.items():
        if dtype == torch.float32:
            kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
            rows.append({"run": f"port_{device}_f32", "device": kind, **breakdown(x, ref)})
    return rows


def jax_runs() -> list[dict]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mpc_quad_ros_tpu.loop import EpisodeConfig, run_episode_batch
    from mpc_quad_ros_tpu.models.augmented import make_mpc_dynamics
    from mpc_quad_ros_tpu.models.params import hummingbird_params
    from mpc_quad_ros_tpu.models.rgp import RGPState
    from mpc_quad_ros_tpu.ops import MPCConfig, SQPSolver
    from test_torch_cuda_paths import _hetero_inputs

    inp, traj, _ = _hetero_inputs()
    outs = {}
    for dtype in (jnp.float64, jnp.float32):
        base = hummingbird_params(dtype=dtype)
        cfg = EpisodeConfig(mpc=MPCConfig(u_ref=float(base.hover_input)))
        solver = SQPSolver(cfg.mpc, make_mpc_dynamics(base))
        p = base._replace(**{k: jnp.asarray(v, dtype) for k, v in inp["params"].items()})
        rgp = RGPState(**{k: jnp.asarray(v, dtype) for k, v in inp["rgp"].items()})
        fn = jax.jit(lambda p, x, tr, r: run_episode_batch(cfg, solver, p, x, tr, TICKS, r))
        out = fn(p, jnp.asarray(inp["x0"], dtype), jnp.asarray(traj, dtype), rgp)[1]
        outs[dtype] = np.asarray(out.x_odom)
    return [{"run": "jax_cpu_f32", "device": "cpu", "x_odom_dtype": str(outs[jnp.float32].dtype),
             **breakdown(outs[jnp.float32], outs[jnp.float64])}]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", action="store_true", help="the JAX package's run on the CPU")
    args = ap.parse_args()
    for row in (jax_runs() if args.jax else port_runs()):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
