"""The port's figures (``io/viz.py``) on the CPU: each plot and animation
writes its file from a synthetic log; the posterior helpers
(``_basis_per_axis``, ``_posterior_sigma``) against the JAX package's within
1e-12 on both log layouts; ``LiveFlightView`` fed by the port's node;
``run.main(["--cpu", "-p", ...])`` writes the report; and with matplotlib
blocked, ``io.viz`` and ``node`` still import and the metric half works."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpc_quad_ros_tpu_torch.run as trun
from mpc_quad_ros_tpu.io.viz import Visualiser as JaxVisualiser
from mpc_quad_ros_tpu_torch.io.viz import LiveFlightView, Visualiser
from mpc_quad_ros_tpu_torch.models.params import hummingbird_params
from mpc_quad_ros_tpu_torch.node import (ControllerNode, LiveFrame, SimLoop, TrajectoryRequest,
                                         TrajectoryServer)

from test_torch_cuda_common import circle

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
T, NB = 24, 8


def synthetic_log(stacked_basis: bool = True) -> dict:
    """A gp2-shaped log of T ticks: states, references, controls, costs,
    per-tick solve times and the RGP posterior (basis per tick or once)."""
    rng = np.random.default_rng(0)
    x = np.zeros((T, 13))
    x[:, 3] = 1.0
    x[:, :3] = np.cumsum(rng.normal(0.0, 0.05, (T, 3)), 0) + [0.0, 0.0, 3.0]
    x[:, 7:10] = rng.normal(0.0, 1.0, (T, 3))
    ref = x + rng.normal(0.0, 0.02, (T, 13))
    basis = np.tile(np.linspace(-3.0, 3.0, NB), (3, 1))
    G = rng.normal(size=(T, 3, NB, NB))
    return {"x_odom": x, "x_ref": ref, "w_odom": rng.uniform(0.2, 0.6, (T, 4)),
            "t_odom": np.arange(T) * 0.1, "cost_solution": rng.uniform(1.0, 2.0, T),
            "t_cpu": rng.uniform(1e-3, 2e-3, T),
            "rgp_mu_g_t": rng.normal(size=(T, 3, NB)) * 0.1, "v_body": rng.normal(size=(T, 3)),
            "a_drag": rng.normal(size=(T, 3)) * 0.5,
            "rgp_basis_vectors": np.broadcast_to(basis, (T, 3, NB)).copy() if stacked_basis
            else basis,
            "rgp_C_g_t": G @ G.transpose(0, 1, 3, 2) * 0.01}


@pytest.mark.parametrize("figure", ["plot_data", "plot_3d", "plot_rgp_evolution",
                                    "compare_covariance", "create_animation",
                                    "create_rgp_animation", "create_rgp_full_animation"])
def test_figure_writes_its_file(figure, tmp_path):
    viz = Visualiser(synthetic_log())
    if figure.startswith("create_"):
        out = tmp_path / f"{figure}.gif"
        assert getattr(viz, figure)(str(out), fps=5, stride=8) == str(out)
    elif figure == "compare_covariance":
        out = tmp_path / "cov.png"
        Visualiser.compare_covariance({"a": viz, "b": Visualiser(synthetic_log(False))},
                                      save_path=str(out))
    else:
        out = tmp_path / "sub" / f"{figure}.png"
        assert getattr(viz, figure)(save_path=str(out)) == str(out)
    assert out.exists() and out.stat().st_size > 0


@pytest.mark.parametrize("stacked_basis", [True, False])
def test_posterior_helpers_match_jax(stacked_basis):
    log = synthetic_log(stacked_basis)
    ours, ref = Visualiser(log), JaxVisualiser(log)
    np.testing.assert_allclose(ours._basis_per_axis(), np.asarray(ref._basis_per_axis()),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours._posterior_sigma(), np.asarray(ref._posterior_sigma()),
                               rtol=0, atol=1e-12)
    assert ours._posterior_sigma().shape == (T, 3, NB)
    del log["rgp_basis_vectors"], log["rgp_C_g_t"]
    assert Visualiser(log)._basis_per_axis() is None and Visualiser(log)._posterior_sigma() is None


def test_live_view_streams_the_node(tmp_path):
    """Every control tick hands the view a LiveFrame with the reference
    chunk, the MPC horizon and the target; the view renders a frame and an
    animation."""
    view = LiveFlightView(stride=10)
    p = hummingbird_params(dtype=torch.float64)
    base = TrajectoryServer(sample_dt=0.01)

    class ShortLine(TrajectoryServer):
        def handle(self, req):
            return base.handle(TrajectoryRequest("line", np.array([0, 0, 3.0]),
                                                 np.array([0.1, 0, 3.0]), v_max=4.0, a_max=4.0))

    node = ControllerNode(p, ShortLine(), dtype=torch.float64, device="cpu", v_max=4.0,
                          a_max=4.0, live_callback=view)
    x_hover = np.array([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)
    SimLoop(node, p, x_hover).run(max_ticks=2000)

    assert node.finished and view._n == node.idx_traj and len(view.frames) >= 3
    f = view.frames[-1]
    assert isinstance(f, LiveFrame)
    assert f.x_ref_chunk.shape == (node.cfg.n_nodes, 13)
    assert f.x_horizon.shape == (node.cfg.n_nodes + 1, 13)
    np.testing.assert_array_equal(f.target, node.x_trajectory[-1, :3])
    view.save_frame(str(tmp_path / "live.png"))
    assert (tmp_path / "live.png").stat().st_size > 0
    view.frames = view.frames[:3]
    view.to_animation(str(tmp_path / "live.gif"), fps=5)
    assert (tmp_path / "live.gif").stat().st_size > 0


def test_run_main_writes_the_report(monkeypatch, tmp_path):
    """``-p`` writes the tracking report of the run (a 1 s circle, gp0)."""
    def build(cfg, x0_pos, mpc_dt):
        tr = circle(cfg.v_max, dt=mpc_dt, t_max=1.0)
        return tr, np.arange(len(tr)) * mpc_dt

    monkeypatch.setattr(trun, "build_trajectory", build)
    out = tmp_path / "img" / "report.png"
    assert trun.main(["--gpe", "0", "--trajectory", "2", "--v_max", "6", "--a_max", "6", "--cpu",
                      "-p", str(out)]) == 0
    assert out.exists() and out.stat().st_size > 0


BLOCK_MPL = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] == 'matplotlib':\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n")


def test_metric_half_and_node_import_without_matplotlib():
    code = ("import numpy as np\n"
            "import mpc_quad_ros_tpu_torch.node\n"
            "from mpc_quad_ros_tpu_torch.io.viz import Visualiser\n"
            "x = np.zeros((5, 13)); r = x.copy(); r[:, 0] = 0.1\n"
            "v = Visualiser({'x_odom': x, 'x_ref': r})\n"
            "print(round(float(v.rms_errors()['rms_pos_mm']), 6))\n"
            "try:\n"
            "    v.plot_3d()\n"
            "except ImportError as e:\n"
            "    print('PLOT', e)\n"
            "print('MPL', any(k.startswith('matplotlib') for k in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", BLOCK_MPL + code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["100.0", "PLOT", "matplotlib", "is", "blocked", "MPL", "False"]
