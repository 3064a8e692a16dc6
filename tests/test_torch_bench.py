"""The port's measurement harness (``mpc_quad_ros_tpu_torch/bench/``) on the
CPU: its copies of the JAX package's operation counts equal the originals,
the new bounds count what the kernels do, and the timing entry points run
end to end through the plain versions and answer under the JAX key names,
and ``bench/riccati_parts.py``'s emptied copies of kernel C,
``bench/ipm_parts.py``'s of kernels B and E and ``bench/step_parts.py``'s of
kernel F apply to their sources (E's and F's also build).  The card's numbers come from ``chip_smoke.py``."""

import math
import shutil
import subprocess

import pytest

from mpc_quad_ros_tpu.bench import phases as jax_phases
from mpc_quad_ros_tpu.bench import probe_hybrid as jax_probe
from mpc_quad_ros_tpu_torch.bench import (bounds, ipm_parts, phases, probe_hybrid, riccati_parts,
                                          step_parts, suite)
from mpc_quad_ros_tpu_torch.bench.ipm_parts import PACKAGE, variant_checkout
from mpc_quad_ros_tpu_torch.ops.cuda import _build


@pytest.mark.parametrize("N", [5, 10, 20, 40])
@pytest.mark.parametrize("qp_iters", [6, 12])
def test_flop_counts_equal_the_jax_counts(N, qp_iters):
    assert phases.analytic_vpu_flops(N=N, qp_iters=qp_iters) == \
        jax_phases.analytic_vpu_flops(N=N, qp_iters=qp_iters)
    assert phases.executed_vpu_flops(N=N, qp_iters=qp_iters) == \
        jax_phases.executed_vpu_flops(N=N, qp_iters=qp_iters)
    assert probe_hybrid.executed_riccati_flops(N=N, iters=qp_iters) == \
        jax_probe.executed_riccati_flops(N=N, iters=qp_iters)


def test_bounds_of_the_bench_kernels():
    # kernel G at the JAX register shape: 2**21 elements, operations-bound
    g = bounds.fma_work(2048 * 8 * 128, 16, 256)
    assert g["bytes"] == 8 * 2 ** 21 and g["flops"] == 2 ** 21 * (2 * 16 * 256 + 32)
    assert g["bound_by"] == "operations"
    # kernels H and I at the probe's shape: 105 MB each way, bytes-bound
    t = bounds.transpose_work(16384, 40, 4)
    assert t["bytes"] == 2 * 4 * 16384 * 1600 and t["bound_by"] == "bytes"
    # the step's phases add up to kernel F's count
    s = bounds.step_flops(10, 10, 12)
    assert s["ipm_total"] == s["ipm_setup"] + 12 * s["ipm_per_iter"]
    assert bounds.sqp_step_work(1, 10, 10, 12)["flops"] == s["total"]


def _finite(d):
    return all(math.isfinite(v) for v in d.values() if isinstance(v, float))


def test_throughput_runs_on_cpu():
    rows = suite.throughput(batches=(4,), iters=1, device="cpu", reps=1)
    assert [r["batch"] for r in rows] == [4]
    assert rows[0]["solves_per_s"] > 0 and _finite(rows[0]) and rows[0]["device_kind"] == "cpu"


def test_fused_phase_split_runs_on_cpu():
    out = phases.fused_phase_split(B=4, device="cpu", chained=1, reps=1)
    assert set(out["per_iters_seconds"]) == {"4", "8", "12"}
    for key in ("ipm_per_iteration_s", "non_ipm_intercept_s", "ipm_fraction_at_12",
                "us_per_solve_at_12", "lin_kernel_s", "condense_kernel_s", "qp_kernel_12it_s"):
        assert math.isfinite(out[key]), key
    assert out["device_kind"] == "cpu"


def test_latency_runs_on_cpu():
    out = suite.latency(iters=2, device="cpu", chained=2)
    for key in ("p50_ms", "p99_ms", "mean_ms", "device_ms_per_solve"):
        assert math.isfinite(out[key]) and out[key] > 0, key


def test_hybrid_breakdown_runs_on_cpu():
    out = probe_hybrid.hybrid_breakdown(B=4, device="cpu", chained=1, reps=1)
    for key in ("full_hybrid_s", "lin_standalone_s", "jfed_standalone_12it_s", "glue_s"):
        assert math.isfinite(out[key]), key


def test_riccati_profile_runs_on_cpu():
    peak = {"smem_streaming_f32_flops_per_s": 1e12}
    out = probe_hybrid.riccati_profile(Ns=(5,), B=2, device="cpu", peak=peak, reps=1)
    row = out["5"]
    assert set(row["per_iters_seconds"]) == {"2", "6", "12"}
    assert math.isfinite(row["sweep_slope_s"]) and math.isfinite(row["intercept_s"])
    per_iter = bounds.riccati_work(1, 5, 1)["flops"] - bounds.riccati_work(1, 5, 0)["flops"]
    assert row["port_flops_per_iter"] == per_iter


def test_riccati_breakdown_runs_on_cpu():
    out = probe_hybrid.riccati_breakdown(B=2, N=5, device="cpu", reps=1)
    for key in ("lin_kernel_s", "glue_s", "riccati_kernel_s", "riccati_finish_s", "step_s"):
        assert math.isfinite(out[key]) and out[key] > 0, key


@pytest.mark.parametrize("variant", sorted(riccati_parts.VARIANTS))
def test_riccati_parts_edits_match_the_source(variant, tmp_path):
    """Each of ``bench/riccati_parts.py``'s emptied copies of kernel C
    applies to this checkout's source (each edit found exactly once) and
    the copy still builds for the host."""
    root = variant_checkout(variant, riccati_parts.VARIANTS[variant], tmp_path,
                            riccati_parts.SOURCE, PACKAGE)
    src = (root / PACKAGE.name / "csrc" / riccati_parts.SOURCE).read_text()
    assert src.count(riccati_parts.NEVER) == len(riccati_parts.VARIANTS[variant])
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the kernels' host version")
    subprocess.run(["g++", *_build.HOST_FLAGS, "-c", str(root / PACKAGE.name / "csrc" /
                    riccati_parts.SOURCE), "-o", str(tmp_path / "variant.o")], check=True)


@pytest.mark.parametrize("variant", sorted(ipm_parts.VARIANTS) + sorted(ipm_parts.E_VARIANTS))
def test_ipm_parts_edits_match_the_source(variant, tmp_path):
    """Each of ``bench/ipm_parts.py``'s copies applies to this checkout's
    source (``variant_checkout`` refuses an edit found other than once);
    kernel E's emptied copies also build for the host."""
    edits, source = ((ipm_parts.E_VARIANTS[variant], ipm_parts.E_SOURCE)
                     if variant in ipm_parts.E_VARIANTS
                     else (ipm_parts.VARIANTS[variant], "ipm_box.cuh"))
    root = variant_checkout(variant, edits, tmp_path, source, PACKAGE)
    src = (root / PACKAGE.name / "csrc" / source).read_text()
    assert all(src.count(new) >= 1 for _, new in edits)
    if source == "ipm_box.cuh":
        return
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the kernels' host version")
    subprocess.run(["g++", *_build.HOST_FLAGS, "-c", str(root / PACKAGE.name / "csrc" /
                    "qp_kernel.cu"), "-o", str(tmp_path / "variant.o")], check=True)


@pytest.mark.parametrize("variant", sorted(step_parts.DESIGNS["teams_scratch_j"][1]))
def test_step_parts_edits_match_the_source(variant, tmp_path):
    """Each of ``bench/step_parts.py``'s emptied copies of kernel F applies
    to this checkout's source (its design is the teams', each edit found
    exactly once) and the copy still builds for the host."""
    design, variants = step_parts.design_of(PACKAGE)
    assert design == "teams_scratch_j"
    root = variant_checkout(variant, variants[variant], tmp_path, step_parts.SOURCE, PACKAGE)
    src = (root / PACKAGE.name / "csrc" / step_parts.SOURCE).read_text()
    assert src.count(step_parts.NEVER) == len(variants[variant])
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available to build the kernels' host version")
    subprocess.run(["g++", *_build.HOST_FLAGS, "-c", str(root / PACKAGE.name / "csrc" /
                    step_parts.SOURCE), "-o", str(tmp_path / "variant.o")], check=True)
