"""The port's script farm (``scripts.py``) and figure check
(``scripts_viz_parity.py``) on the CPU: the same script matrix as the JAX
package's, its exit codes (0 done, 2 unknown or no log) and figures from an
explicit log; the parity check without a reference checkout (skipped with
its message, exit code 0) and ``render_ours`` on any log pickle."""

import numpy as np
import pytest

from mpc_quad_ros_tpu.scripts import list_scripts as jax_list_scripts
from mpc_quad_ros_tpu_torch import scripts, scripts_viz_parity
from mpc_quad_ros_tpu_torch.io.logger import save_dict


def _log(tmp_path, name="log.pkl", rgp=False) -> str:
    T = 30
    rng = np.random.default_rng(0)
    log = {"x_odom": rng.normal(size=(T, 13)), "x_ref": np.zeros((T, 13)),
           "w_odom": np.full((T, 4), 0.3), "t_odom": np.arange(T) * 0.1}
    if rgp:
        log.update(rgp_mu_g_t=rng.normal(size=(T, 3, 6)), v_body=rng.normal(size=(T, 3)),
                   a_drag=rng.normal(size=(T, 3)))
    path = tmp_path / name
    save_dict(log, str(path))
    return str(path)


def test_script_matrix_is_the_jax_packages():
    assert scripts.list_scripts() == jax_list_scripts()
    assert "run_traj0_gp2" in scripts.list_scripts() and "viz_cov" in scripts.list_scripts()


def test_list_unknown_and_missing_log(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(scripts, "OUTPUT_ROOT", str(tmp_path))
    assert scripts.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == scripts.list_scripts()
    assert scripts.main([]) == 0
    assert scripts.main(["no_such_script"]) == 2
    assert scripts.main(["viz_plot_python_traj9_gp0", "--v_max", "99"]) == 2
    assert scripts.main(["viz_cov"]) == 2


@pytest.mark.parametrize("name, suffix", [("viz_plot_python_traj0_gp0", "report.png"),
                                          ("viz_3dplot_gazebo_traj1_gp2", "3d.png"),
                                          ("viz_rgp_python", "rgp.png")])
def test_figure_scripts_write_from_an_explicit_log(name, suffix, tmp_path):
    pkl = _log(tmp_path, rgp=True)
    out = tmp_path / suffix
    assert scripts.main([name, "--data", pkl, "--output", str(out)]) == 0
    assert out.exists() and out.stat().st_size > 0


def test_viz_cov_reads_every_log(tmp_path, monkeypatch):
    monkeypatch.setattr(scripts, "OUTPUT_ROOT", str(tmp_path))
    for env, name in (("python", "a.pkl"), ("gazebo", "b.pkl")):
        (tmp_path / f"{env}_simulation" / "data").mkdir(parents=True)
        _log(tmp_path / f"{env}_simulation" / "data", name)
    assert scripts.main(["viz_cov"]) == 0
    assert (tmp_path / "covariance_comparison.png").stat().st_size > 0


def test_viz_parity_skips_without_a_reference_checkout(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("MPCQUAD_REFERENCE", raising=False)
    assert scripts_viz_parity.main(["--out", str(tmp_path / "a")]) == 0
    assert "skipped" in capsys.readouterr().out
    missing = str(tmp_path / "no_checkout")
    assert scripts_viz_parity.main(["--reference", missing, "--out", str(tmp_path / "b")]) == 0
    assert "skipped" in capsys.readouterr().out
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


def test_viz_parity_renders_ours_from_any_log(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("MPCQUAD_REFERENCE", raising=False)
    pkl = _log(tmp_path, rgp=True)
    out = tmp_path / "parity"
    assert scripts_viz_parity.main(["--pkl", pkl, "--out", str(out)]) == 0
    assert "reference half skipped" in capsys.readouterr().out
    for name in ("ours_report.png", "ours_3d.png", "ours_rgp_evolution.png"):
        assert (out / name).stat().st_size > 0
    assert scripts_viz_parity.render_ours(_log(tmp_path, "gp0.pkl"), str(out)) == [
        str(out / "ours_report.png"), str(out / "ours_3d.png")]
