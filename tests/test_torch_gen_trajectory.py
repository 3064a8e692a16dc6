"""The port's ``gen_trajectory`` command line (``traj/native/gen_trajectory.cpp``
with the port's ``minsnap.cpp``, built by ``traj/native_minsnap.py::
gen_trajectory_path``), following ``tests/test_native_minsnap.py``'s CLI
tests: the CSV of random waypoints equal to the native library's durations
and coefficients printed at the CSV's 6 decimals, the JAX package's CLI on
the same file byte for byte, the polynomial through its waypoints (0.05 m)
within its speed limit (10 %), and the error exits (2 on bad arguments, 1
on fewer than two waypoints)."""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from mpc_quad_ros_tpu_torch.traj import random_waypoints
from mpc_quad_ros_tpu_torch.traj.native_minsnap import (BUILD_ROOT, gen_trajectory_path,
                                                        native_available,
                                                        native_min_snap_trajectory)
from mpc_quad_ros_tpu_torch.traj.polynomial import PiecewisePolynomial4D

JAX_NATIVE = pathlib.Path(__file__).resolve().parents[1] / "mpc_quad_ros_tpu" / "traj" / "native"

pytestmark = pytest.mark.skipif(not native_available(), reason="g++ unavailable")


def run_cli(*args, exe=None):
    exe = str(gen_trajectory_path()) if exe is None else exe
    return subprocess.run([exe, *map(str, args)], capture_output=True, timeout=60)


def test_gen_trajectory_builds_under_build_minsnap():
    path = gen_trajectory_path()
    assert path.name == "gen_trajectory" and path.parent.parent == BUILD_ROOT
    assert path.exists()


def test_gen_trajectory_cli(tmp_path):
    wp = random_waypoints(hsize=8.0, num_waypoints=5, seed=2)
    wp_csv = tmp_path / "waypoints.csv"
    np.savetxt(wp_csv, wp, fmt="%.6f", delimiter=",")
    out_csv = tmp_path / "poly.csv"
    res = run_cli("-i", wp_csv, "-o", out_csv, "--v_max", 7, "--a_max", 5)
    assert res.returncode == 0, res.stderr.decode()

    poly = PiecewisePolynomial4D.loadcsv(str(out_csv))
    assert len(poly.durations) == len(wp) - 1
    nat = native_min_snap_trajectory(np.loadtxt(wp_csv, delimiter=","), 7.0, 5.0)
    six = np.vectorize(lambda v: float(f"{v:.6f}"))
    np.testing.assert_array_equal(poly.durations, six(nat.durations))
    np.testing.assert_array_equal(poly.coeffs, six(nat.coeffs))

    # the JAX package's CLI, built from its own sources into tmp_path
    jax_exe = tmp_path / "gen_trajectory_jax"
    subprocess.run([shutil.which("g++"), "-O2", "-std=c++17", "-o", str(jax_exe),
                    str(JAX_NATIVE / "gen_trajectory.cpp"), str(JAX_NATIVE / "minsnap.cpp")],
                   check=True, capture_output=True, timeout=120)
    jax_csv = tmp_path / "poly_jax.csv"
    res = run_cli("-i", wp_csv, "-o", jax_csv, "--v_max", 7, "--a_max", 5, exe=str(jax_exe))
    assert res.returncode == 0 and jax_csv.read_bytes() == out_csv.read_bytes()

    knots = np.concatenate([[0.0], np.cumsum(poly.durations)])
    f = poly.eval_flat(np.clip(knots, 0, poly.duration - 1e-9))
    np.testing.assert_allclose(f["pos"], wp, atol=0.05)
    ff = poly.eval_flat(np.arange(0, poly.duration, 0.01))
    assert np.linalg.norm(ff["vel"], axis=1).max() <= 7 * 1.1


def test_gen_trajectory_cli_errors(tmp_path):
    res = run_cli()
    assert res.returncode == 2 and b"usage" in res.stderr
    res = run_cli("--bogus")
    assert res.returncode == 2 and b"unknown argument" in res.stderr
    wp_csv = tmp_path / "one.csv"
    wp_csv.write_text("0,0,0\n")
    res = run_cli("-i", wp_csv, "-o", tmp_path / "o.csv", "--v_max", 5, "--a_max", 5)
    assert res.returncode == 1 and b"waypoints" in res.stderr
    assert run_cli("--help").returncode == 0
