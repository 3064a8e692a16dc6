"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device -> exit 1 (there is no CPU fallback);
2. build: nvcc compiles ``mpc_quad_ros_tpu_torch/csrc/*.cu`` (timed); then
   one line per kernel B, E and F at N = 10 and 40 (nz = 40 and 160), kernel
   A at N = 10 and kernels C, D and J at N = 10 and 40: shared memory per
   block, registers and spills (the build log's ``-Xptxas -v``), resident
   blocks and warps per SM (the occupancy API), and the same for kernels H
   and I at nz = 40 (blocks of up to four warps, a tile each); kernel B must
   keep at least 12 warps resident per SM at N = 10, kernel C more than 11
   at N = 40, kernel D more than 11 at N = 10;
3. kernel A (RK4 linearisation) against its plain PyTorch version, in f32
   and against the f64 plain version, at the main-path shapes, and NaN
   isolation between scenarios;
4. kernel B (condense + IPM + KKT + dX) against the f64 plain version, the
   KKT floor, and NaN isolation between scenarios;
5. kernel C (the Riccati-factorised box IPM) at B=65536, N=40 against its
   f32 and f64 plain versions, dX against the rollout of dU, NaN isolation;
6. kernels D (condensing: H, g, M, d), E (the standalone box-QP IPM) and F
   (the whole Gauss-Newton step) at B=65536, N=10 against their f32 and f64
   plain versions, NaN isolation; kernel J (condensing fed A and B, the
   small-batch step's) at B=1 and B=127 against its plain versions, NaN
   isolation and bitwise against kernel D; then kernels B and E
   warm-started with the duals of a previous solve against the f64 plain
   warm IPM; then kernels B and D at N=40 (B=512; a 1 s horizon at 25 ms
   nodes, hover with velocities U(-0.5, 0.5) m/s and y_ref = x0, where the
   f32 plain version loses no scenario) against their f32 and f64 plain
   versions;
7. the card's solves against the f64 solves on the CPU, N=10 (each
   pipeline) and N=40, and the three pipelines against each other at
   B=65536 (U bitwise equal); then the per-scenario ``SQPSolver.solve`` at
   B=1024 ("pdip" and "projected_newton" at N=10, "riccati" at N=40) and
   ``solve_batch`` at the ROS shapes (N=5; 20 basis vectors a axis) against
   their f64 CPU solves, with NaN isolation; the per-scenario f32 IPM's lost
   scenarios from N=16 to 31 (B=16384); kernels A and J on the ROS node's
   own tick inputs (B=1: the gp2 node at N=5 with 20 basis vectors a axis,
   and hello_world's crazyflie node at N=10 with no drag model, each 40
   ticks into its flight) against their f32 and f64 plain versions, by
   kernel A's and kernel J's rules; one episode on the CPU in f64 (50
   ticks), the reference of phase 9's episode, and the ROS node's first 170
   ticks on the CPU in f64, the reference of its card flight; then the gp1
   workflow
   (``bench/gp1_workflow.py``): the gp0 training flight of the closed loop's
   fleet (16384 x 100 ticks, fused loop), episode 0's log, ``DataLoaderGP``,
   the fit (``train_gp``, float64 on the card) saved and read back bitwise,
   the offline RGP (``train_rgp``, 50 samples of ``rgp_learn``) against its
   float64 run on the CPU, and ``solve_batch`` with the fitted GP at the solve
   cell's operating point (B=1024) against the f64 solve on the CPU (kernel
   B's rules, NaN isolation, kernel A's rule; the float32 fold's drag error
   reported);
8. the N=10 slice: ``SQPSolver.solve_batch`` at B=65536, 20 chained
   warm-started solves (solves/s), one-scenario latency through the
   small-batch step, kernels A, J and E (p50/p99 of 20 runs of 50 chained
   solves, CUDA events);
9. the closed learning loop: 16384 episodes x 100 ticks on the accelerating
   circle at 8 m/s (tick-solves/s, tracking error from tick 30 on); then the
   per-scenario paths: ``run_episode`` for one hummingbird, 50 ticks, each
   tick timed (p50/p99), and one scenario's ``solve`` alone (kernels A and
   J); ``run_episode_batch`` on the closed loop's scenario (kernels A and
   D); the fused loop on a heterogeneous batch of 16384 (v_max 4, 8, 12
   m/s; ``traj_len``, ``episode_ticks``: finished episodes stay bitwise
   frozen) and 10 ticks with ``control_skip`` = 10 on a trajectory sampled
   10x finer (bitwise the run on its every tenth sample); then the fitted
   GP (gp1) through the fused loop on the closed loop's fleet at 16384 x 100
   ticks (kernels A and B; the fitted drone's error below ERR_MEAN_TOL, the
   fleet's below the gp0 flight's) and through ``run_episode_batch`` at
   B=1024, 20 ticks (kernels A and D; its error within 10 % of the fused
   loop's on the same episodes);
   then the paper's learning metric off the gp0 training flight and the gp2
   closed loop (the same fleet): each episode's cov(v, e) per axis
   (``Visualiser.velocity_error_covariance``), the ratio |gp0| / |gp2| of
   episode 0 and the fleet's median, above 1.5 on x and y; then the
   simulation entry point: ``run.main`` with the reference's own command at the
   closed loop's fleet width (``--gpe 2 --trajectory 2 --v_max 10 --a_max
   10 --batch 16384 -o``: 300 ticks of the fused loop, kernels A and B;
   tick-solves/s, the RMSE's mean, min and max, the log's keys); trajectory
   1 (random waypoints through min-snap) by ``run.build_trajectory``, the
   native min-snap against the numpy one, and its first 50 ticks through
   the fused loop at B=1024 (kernels A and B); ``compare.run_matrix_batched``
   on gpe 0, 1, 2 at v_max 4, 8, 12 m/s, 30 ticks (gpe 1 the gp1
   workflow's model; three batches of 3, the small-batch step: kernels A, J,
   E); ``io/profiling.py::profile_solver_phases`` at B=65536, N=10 with RGP
   drag (kernels A, D, E and the hybrid solve, A and B); then the ROS node
   (``node.py``, each path kernels A and J): ``ControllerNode`` at the
   reference's ROS shapes (hummingbird, gp2 with 20 basis vectors a axis,
   N=5, 100 Hz) flown by ``SimLoop`` from the ground (the bootstrap line to
   hover, then the circle) for 500 ticks, each tick's wall time, the
   compute's, the tracking error, the line-to-circle passage, held to the
   same flight on the CPU in f64 (its first 170 ticks, flown before the
   card paths: the first 5 logged states within 1e-2, the mean tracking
   error within 10 %); the crazyflie's cmdPosition climb with the onboard
   controller's stand-in and the plant on the card (finished in the 1 m
   ball); the trajectory service and the commands over localhost sockets
   (within 0.5 m of the line's end, one command received a control tick);
   ``hello_world`` (both phases within 0.05 m); then ``entry()``'s solve
   (``entry.py``: one scenario, RGP drag; kernels A and J) against its f64
   CPU solve within 1e-2; the multi-process farm (``parallel/launch.py``):
   two ranks over gloo sharing the card, each at the solve cell's width
   (global batch 131072, 3 chained solves a step, the step timed 5 times,
   then 3 ticks of the RGP episode leg; kernels A and B, the leg A and D),
   each rank's rows against the single-process card run of the same
   scenarios (bitwise expected; else kernel B's rules against an f64 CPU
   oracle of 256 rows a rank), the reduced sums equal on both ranks and
   within 1e-5 of the single process's, the backend, the ranks' launches
   and the step's solves/s (a contention figure: the ranks time-share one
   card); ``bench/parity.py`` replaying the one-drone episode's log (gp2,
   N=10, skip=1, the logged posterior; kernels A and J a tick) on the card,
   held after the card paths to the CPU's f64 replay within 1e-2, du
   against the logged commands reported; the ``gen_trajectory`` CLI on the
   minsnap path's waypoints against the native library at the CSV's 6
   decimals, and its usage exit;
10. the "split" and "fused" slices: the N=10 slice's chained solves through
    kernels A, D, E and through kernel F alone;
11. the warm-dual regulation chain (``bench/regulation.py``) at B=65536, 40
    ticks: cold at 12 IPM iterations, warm at 6 and at 12 (hybrid), then one
    warm tick through "split" and one through "fused";
12. the Riccati slice: ``solve_batch(qp_method="auto")`` at N=40, B=65536,
    10 chained solves (solves/s, honest KKT), then "pdip" at N=41, past
    FUSED_N_MAX, which must warn and take kernel C;
13. the backend crossover (``bench/crossover.py``) at B=16384, N = 10, 16,
    20, 30 (condensed and Riccati) and 80 (Riccati only), 2 chained solves
    per row;
14. kernel G (f32 multiply-add chains) against its f32 and f64 plain
    versions in both accumulator homes, at the JAX shapes and at a small one
    that runs the remainder trip, its SASS's FFMA count per instantiation (5
    per chain: four steps a trip plus the remainder's one), then the card's
    f32 rate at the JAX shapes (``bench/phases.py::vpu_peak``, which gives
    kernel G's time; the register-resident rate must not pass 1.05 x 67
    TFLOP/s, the shared-memory one must read below it);
15. kernels H and I (the transpose probe) at B=16384, nz=40 against their
    f32 and f64 plain versions with NaN isolation, then
    ``bench/probe_hybrid.py::transpose_probe`` at reps = 4 and 32, which
    gives their times (CUDA events, and the profiler's device time of one
    launch, which the kernels line takes) beside the device time of
    ``Tensor.copy_`` on the same tiles, a yardstick that moves the same
    bytes;
16. ``bench/phases.py::phase_table`` at B=16384 (kernel F's time per IPM
    iteration, kernels A, D, E alone, utilisations against the rate of 14);
17. ``bench/probe_hybrid.py::hybrid_breakdown`` and ``jfed_standalone`` at
    B=16384 (kernel B alone, the hybrid step's glue);
18. ``bench/suite.py::throughput`` over B = 1024, 4096, 16384, 65536;
19. ``bench/probe_hybrid.py::riccati_profile``: kernel C alone, N = 10, 20,
    40 at B=1024, 2, 6 and 12 IPM iterations; then ``riccati_breakdown``:
    one step of the Riccati slice (N=40, B=65536) by part (kernel A, the
    glue, kernel C, ``_riccati_finish``) and whole;
20. ``bench/headline.py::measure`` without the closed loop (phase 9 runs it).

The launch counters are reset just before each path (the gp1 workflow's
training path in 7, phases 8-9 with the episode, the episode batch, the
heterogeneous batch, the two gp1 flights, the run CLI, min-snap, the matrix,
the profile, the node, its cmdPosition climb, its sockets, hello_world, the
entry point, the farm, the replay and gen_trajectory each a path of its own,
10 split, 10 fused, 11, 12, and the measured parts of 14-20) and read just
after; each path must have launched its kernels and no other.  The farm's
kernels launch in its two rank processes, which start with every count at
0 and report their counts with their results; the path's counts are their
sum.  Every chained solve is
timed by ``bench/phases.py::time_solves``.  The plain versions are
fenced off on those paths.  The line before the last lists every kernel with
its launches, its time, its plain version's and its bound
(``bench/bounds.py``); the last line is the device summary.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time
import warnings
from io import StringIO

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mpc_quad_ros_tpu_torch import compare, run  # noqa: E402
from mpc_quad_ros_tpu_torch import entry as entry_mod  # noqa: E402
from mpc_quad_ros_tpu_torch import hello_world as hello  # noqa: E402
from mpc_quad_ros_tpu_torch import node as ros  # noqa: E402
from mpc_quad_ros_tpu_torch.bench import (bounds, gp1_workflow, headline,  # noqa: E402
                                           parity, per_scenario, phases, probe_hybrid, suite)
from mpc_quad_ros_tpu_torch.bench.closed_loop import (closed_loop, hetero_closed_loop,  # noqa: E402
                                                      setup, skip_closed_loop,
                                                      velocity_error_covariances)
from mpc_quad_ros_tpu_torch.bench.crossover import crossover_row, per_scenario_row  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.operating_point import N_BASIS, operating_point  # noqa: E402
from mpc_quad_ros_tpu_torch.bench.regulation import regulation_chain, regulation_setup  # noqa: E402
from mpc_quad_ros_tpu_torch.io import SimConfig, load_dict  # noqa: E402
from mpc_quad_ros_tpu_torch.io.profiling import profile_solver_phases  # noqa: E402
from mpc_quad_ros_tpu_torch.io.transport import (TcpPublisher, TcpRpcClient,  # noqa: E402
                                                 TcpRpcServer, TcpSubscriber)
from mpc_quad_ros_tpu_torch.loop import run_episode_batch_fused  # noqa: E402
from mpc_quad_ros_tpu_torch.models import (crazyflie_params, fold_drag,  # noqa: E402
                                           gp_mean_world, hummingbird_params,
                                           make_mpc_dynamics, rgp_init)
from mpc_quad_ros_tpu_torch.ops import qp_kkt_residual, sqp  # noqa: E402
from mpc_quad_ros_tpu_torch.ops.cuda import (_build, condense_kernel, lin_kernel,  # noqa: E402
                                             qp_kernel, riccati_kernel, sqp_fused_kernel)
from mpc_quad_ros_tpu_torch.ops.cuda.condense_common import split_AB  # noqa: E402
from mpc_quad_ros_tpu_torch.parallel import mp_worker  # noqa: E402
from mpc_quad_ros_tpu_torch.parallel.launch import launch_workers  # noqa: E402
from mpc_quad_ros_tpu_torch.traj import min_snap_trajectory, random_waypoints  # noqa: E402
from mpc_quad_ros_tpu_torch.traj.native_minsnap import (gen_trajectory_path,  # noqa: E402
                                                        native_available,
                                                        native_min_snap_trajectory)
from mpc_quad_ros_tpu_torch.traj.polynomial import PiecewisePolynomial4D  # noqa: E402

SOLVE_B = 65536
CLOSED_B = 16384
CROSS_B = 16384
N_LONG = 40
# Kernel A against its plain version: xp holds positions up to ~20 m, where
# one f32 ulp is ~2e-6, and four RK4 stages add a few ulps -> 1e-5.  J entries
# reach ~15, with the 13-term chain-rule sums of 4 stages behind each -> 1e-4.
LIN_XP_TOL, LIN_J_TOL = 1e-5, 1e-4
# Kernel B against the f64 oracle: the measured 12-iteration f32 IPM floor of
# the JAX package (tests/test_pipeline_equivalence.py) on z, and its f32 KKT
# floor of ~1e-3 on the KKT distribution.  At this operating point the
# 12-iteration Jacobi-scaled IPM (the JAX kernel's algorithm) leaves about a
# quarter of the scenarios above KKT 1e-3 even in f64 (max ~1.6e-2), and the
# terms of Hz + g reach ~1e4, where one f32 ulp is ~1e-3.  So the kernel's
# max KKT may exceed the oracle's max by the floor, and its share of scenarios
# at KKT <= 1e-3 may trail the oracle's by one point — statistics of each run
# against the oracle, not one run against another element by element.
QP_Z_TOL, QP_KKT_TOL = 4e-2, 1e-3
# Kernel C against the f64 plain version of the same 12 iterations: the JAX
# package pins its f32 Riccati kernel at 1e-3 of the f64 oracle
# (tests/test_riccati_kernel.py:91; measured 2.4e-4 there); on random OCPs
# the port's kernel sits at 1.6e-6 of its f64 plain version (CUDA test).
RIC_DU_TOL = 1e-3
# dX against the f64 affine rollout of the kernel's own dU: f32 rounding of a
# 40-stage recurrence of 17-term sums, relative to the largest |dX|.
RIC_DX_REL_TOL = 1e-4
# The Riccati solve on the card (f32) against the CPU's (f64), N=40: the
# same bound as the condensed path's, 4e-2.
RIC_VS_CPU_TOL = QP_Z_TOL
# Kernel D against its f64 plain version, each of H, g, M and d relative to
# its largest entry: f32 keeps 6e-8 of an entry; each is a sum of at most
# 13 (N+1) products formed through an N-stage recurrence of 13-term sums, and
# the kernel's first card run read 5e-7 at B=4096 -> 1e-5.
COND_REL_TOL = 1e-5
# The controls' box in the new paths' checks: U + z in f32 may pass it by an
# ulp of 1 (z = clip(z', lb/s, ub/s) s rounds, in every pipeline and in the
# JAX kernels alike).
U_BOX_SLACK = 1e-6
# The closed loop's tracking error: about twice the physics figure of the
# JAX benchmark's run of the same scenario (0.022 m).
ERR_MEAN_TOL = 0.05
# The single episode on the card (f32) against the same episode on the CPU
# (f64): its tracking error within this share of the f64 run's.
EPISODE_ERR_REL_TOL = 0.10
# The heterogeneous batch's masked tracking error (v_max 4, 8, 12 m/s over
# 40 m from each circle's start): about twice this scenario's figure in f32
# on the CPU (bench/closed_loop.py::hetero_closed_loop, B=6: 0.094 m).
HETERO_ERR_TOL = 0.2
# The per-scenario solve against the f64 CPU solve, and the batched solve at
# the ROS shapes (N=5; N=10 with 20 basis vectors a axis) against its f64
# plain version: B.
PER_SCENARIO_B = 1024
# The horizons from the port's "auto" switch (AUTO_RICCATI_MIN_N = 16) to the
# JAX package's per-scenario one (32), where the per-scenario solve's f32
# unscaled IPM is counted for lost scenarios: the measurement behind taking
# 16 on that path too.
AUTO_RANGE_N = (16, 20, 24, 28, 31)


def fma_rel_tol(chains: int, steps: int) -> float:
    """Kernel G against its f32 and f64 plain versions, relative to the
    largest output: per step the kernel rounds once (FFMA) and the plain f32
    version twice, and summing the chains adds one rounding each, so the
    first-order bound is 3 (steps + chains) ulps of 2**-24.  At the JAX
    shapes (256 steps; 16 and 8 chains) that is 4.9e-5 and 4.7e-5; on an
    H100 the kernel read 1.1e-5 against f64 and 3.7e-6 against the plain f32
    version at both."""
    return 3 * (steps + chains) * 2.0 ** -24


# The register-resident rate above this is impossible on an H100 (the data
# sheet's 67 TFLOP/s f32 and 5 %): the count or the kernel would be wrong.
FMA_RATE_CEILING = 1.05 * bounds.F32_FLOP_PER_S
# Kernels H and I against their plain versions, relative to the largest
# entry: one multiply-add per entry and repetition (FFMA against two
# roundings), 4 repetitions.
PROBE_REL_TOL = 1e-6
BENCH_B = 16384
# The transpose probe's width (the Hessian's at N = 10) and its repetitions:
# the JAX default, and enough passes to outweigh the tiles' bytes.
PROBE_NZ = 40
PROBE_REPS = (4, 32)
# Kernel B's resident warps per SM at N = 10: its block was cut to one
# packed matrix so that at least this many reside (6 with three matrices
# and J staged).
RESIDENT_WARPS_MIN = 12
# Kernel C's resident warps per SM at N = 40 must pass the 11 that its
# workspace allowed with K and kff in shared memory (19,584 B a block).
RICCATI_WARPS_BEFORE = 11
# Kernel D's resident warps per SM at N = 10 must pass the ~11 that J staged
# whole and H as a full nz x (nz + 1) matrix allowed (19,824 B a block).
CONDENSE_WARPS_BEFORE = 11
# The gp1 workflow: the offline RGP's float64 run on the card against the
# CPU's, relative to the largest entry (the same algorithm; cuSOLVER's
# inverses and eigendecompositions against LAPACK's, over 99 and 50 steps).
OFFLINE_REL_TOL = 1e-9
# gp1 through run_episode_batch: B scenarios for T seconds (20 ticks; 30
# until the run CLI's phases joined the script, cut to keep its time), the
# error from tick 10 on, held against the fused loop's on the same episodes.
GP1_EPISODE_B, GP1_EPISODE_T, GP1_ERR_FROM = 1024, 2.0, 10
# the one drone's episode, on the card and its CPU f64 reference: 5 s (50
# ticks, the error from tick 30 on)
EPISODE_T_MAX = 5.0
GP1_DIR = pathlib.Path(__file__).resolve().parent / "build" / "gp1_workflow"
# The run CLI's command (``run.py``), the reference's primary benchmark, at the
# closed loop's fleet width: 300 ticks of the 30 s circle at 10 m/s, gp2.
CLI_DIR = pathlib.Path(__file__).resolve().parent / "build" / "cli"
CLI_ARGS = ("--gpe", "2", "--trajectory", "2", "--v_max", "10", "--a_max", "10",
            "--batch", str(CLOSED_B))
# Its tracking RMSE over all 300 ticks, the descent from hover at 3 m to the
# circle's plane included: the JAX package's run of the same command for one
# drone (f32, CPU) read 0.4105 m; the fleet's mean is held to that + 10 %.
CLI_RMSE_TOL = 0.45
# the fleet's line that ``run_sim`` prints
CLI_REPORT = re.compile(r"(?P<episodes>\d+) episodes x (?P<ticks>\d+) ticks in (?P<seconds>\S+)s "
                        r".*rmse mean=(?P<mean>\S+) m min=(?P<min>\S+) max=(?P<max>\S+)$")
# The random-waypoint trajectory (hsize 30 m, 10 waypoints, seed 0) through
# min-snap at 10 m/s and 10 m/s^2: the native optimiser against the numpy one
# at tests/test_native_minsnap.py's tolerances, then its first 50 ticks
# through the fused loop at B=1024 (gp2).
MINSNAP_B, MINSNAP_TICKS = 1024, 50
MINSNAP_DUR_RTOL, MINSNAP_POS_TOL = 1e-8, 1e-6
# The comparison matrix: gpe 0, 1, 2 at v_max 4, 8, 12 m/s on the circle,
# max_ticks 30, one heterogeneous fused batch a gpe mode.
MATRIX_DIR = pathlib.Path(__file__).resolve().parent / "build" / "matrix"
MATRIX_V, MATRIX_TICKS = (4, 8, 12), 30
# The paper's learning metric: |cov(v, e)| of gp0 over gp2's, per axis, the
# JAX package's bound on x and y (tests/test_paper_metrics.py).
PAPER_RATIO_MIN = 1.5
# The ROS node (node.py) at the reference's ROS shapes: the hummingbird, gp2
# (the online RGP, 20 basis vectors a axis), N=5 over 1 s, 100 Hz odometry,
# v_max and a_max 10.  It starts on the ground at the origin, so the
# bootstrap line to hover (150 ticks) runs first, then the default circle,
# cut at NODE_TICKS odometry ticks (~20 s on the card).  Its reference is the
# same flight on the CPU in float64 (the plain versions) through
# NODE_CPU_TICKS: the card's first 5 logged states within 1e-2 of it (the
# loops' rule) and its mean tracking error over the CPU run's logged ticks
# within EPISODE_ERR_REL_TOL of the CPU run's (the one-drone rule).
NODE_TICKS, NODE_CPU_TICKS = 500, 170
# kernels A and J are held to their plain versions on the tick after this
# many of a node's (phase_node_kernels)
NODE_KERNEL_TICKS = 40
NODE_X_TOL = 1e-2
NODE_X0 = np.array([0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)
NODE_HOVER = np.array([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)
# the cmdPosition climb (the crazyflie, the onboard controller's stand-in
# against the plant) and the line flown over sockets: the JAX package's tests'
# (tests/test_node.py, tests/test_transport.py)
CLIMB_END, SOCKET_END = np.array([0.0, 0.0, 3.8]), np.array([1.5, 0.0, 3.0])
SOCKET_TOL = 0.5
# hello_world's phases must end within this of their targets
# (tests/test_hello_world.py)
HELLO_TOL = 0.05
# The multi-process farm (parallel/launch.py): two ranks over gloo sharing the
# one card (NCCL refuses two ranks on one GPU), each at the solve cell's full
# width (65536 scenarios, N=10, RGP with 10 basis vectors, 12 IPM
# iterations), 3 chained warm-started solves a step, the step timed 5 times,
# then 3 ticks of the closed-loop RGP leg on each rank's batch.  Each rank's
# rows against the single-process card run of the same build_inputs
# scenarios (bitwise expected: no kernel reduces across scenarios; else
# kernel B's rules against the f64 oracle of MP_REF_ROWS rows a rank), the
# reduced sums equal on both ranks and within MP_SUM_RTOL of the single
# process's (f32 sums of 131072 terms in another order: log2(n) 2^-24 is
# 1.0e-6).
MP_NPROC, MP_B, MP_CHAIN, MP_TICKS, MP_REPEATS = 2, 131072, 3, 3, 5
MP_REF_ROWS, MP_SUM_RTOL = 256, 1e-5
# The parity harness on the episode path's log (one hummingbird, gp2, N=10,
# 50 ticks), as the parity matrix replays a python-sim log (N=10, skip=1,
# drop_tail 15, the logged posterior); the card's replay against the CPU's
# f64 replay within the one-drone rule.
PARITY_LOG = pathlib.Path(__file__).resolve().parent / "build" / "parity" / "episode.pkl"
PARITY_REPLAY = dict(n_nodes=10, skip=1, drop_tail=15, rgp_from_log=True, params="hummingbird")
PARITY_TOL = 1e-2
# gen_trajectory on the minsnap path's waypoints: the CSV equals the native
# library's durations and coefficients printed at its 6 decimals
GEN_DIR = pathlib.Path(__file__).resolve().parent / "build" / "gen_trajectory"
T0 = time.perf_counter()


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(phase: str, **kw) -> None:
    """One phase's JSON line; t_s is the script's elapsed wall time."""
    print(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - T0}), flush=True)


def timed_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after a warm-up)."""
    return phases.device_seconds(fn, reps, "cuda") * 1e3


def kernel_inputs(B: int, device, **kw):
    """The kernels' inputs as the path forms them: one warm-up solve, then
    the next Gauss-Newton step's (X, U) and folded drag (and, with
    warm_start_duals, the warm-up solve's duals in the carry)."""
    solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, **kw)
    carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    return solver, carry, x0, y_ref, aug


def step_args(solver, carry, x0, y_ref, aug):
    """Kernel B's arguments besides the weights: J from kernel A, then the
    glue."""
    xp, J = lin_kernel.linearize(carry.X, carry.U, aug, solver.f, solver.cfg.dt)
    return [J, *solver.qp_inputs(carry.X, carry.U, x0, y_ref, y_ref[:, -1], xp)]


def qp_stats(z, kkt, z_d, kkt_d) -> dict:
    """A run's z and KKT against the f64 oracle's (kernel B's rules)."""
    return {"z_vs_f64": (z.double() - z_d).abs().max().item(),
            "kkt_max": kkt.max().item(), "kkt_f64_max": kkt_d.max().item(),
            "kkt_share_le_1e-3": (kkt <= QP_KKT_TOL).double().mean().item(),
            "kkt_f64_share_le_1e-3": (kkt_d <= QP_KKT_TOL).double().mean().item()}


def check_qp(name: str, st: dict) -> None:
    check(st["z_vs_f64"] < QP_Z_TOL, f"{name} z: {st}")
    check(st["kkt_max"] <= st["kkt_f64_max"] + QP_KKT_TOL,
          f"{name} max KKT beyond the f32 floor over the oracle's: {st}")
    check(st["kkt_share_le_1e-3"] >= st["kkt_f64_share_le_1e-3"] - 0.01,
          f"{name} converges in fewer scenarios than the f64 oracle: {st}")


def isolated(bad: int, outs, outs_bad) -> bool:
    """Scenario `bad` went NaN and every other scenario's outputs are bitwise
    unchanged."""
    keep = torch.arange(outs[0].shape[0], device=outs[0].device) != bad
    return (bool(torch.isnan(outs_bad[0][bad]).any())
            and all(torch.equal(a[keep], b[keep]) for a, b in zip(outs, outs_bad)))


def phase_environment() -> None:
    card = phases.card()
    print(card, flush=True)
    emit("environment", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kernel_key(mangled: str) -> str:
    """A kernel's short name from its mangled one, with a template's
    arguments: "fma<16,1>" for mpcq_fma_kernel<16, true>."""
    key = mangled.split("mpcq_")[1].split("_kernel")[0]
    targs = re.search(r"_kernelI(.*?)EEv", mangled)
    if targs is None:
        return key
    return key + "<" + ",".join(re.findall(r"L[a-z](\d+)E", targs[1] + "E")) + ">"


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    # registers and spills of each kernel, from ptxas -v in the build log
    regs, mangled, props = {}, None, None
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            regs[kernel_key(mangled)] = entry = {}
        elif "Function properties for" in line:
            props = line.split("for ")[1].strip()
        elif mangled and props == mangled and "spill stores" in line:
            entry["spill_stores_bytes"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif mangled and "Used" in line and "registers" in line:
            entry["registers"] = int(line.split("Used")[1].split("registers")[0])
    emit("build", seconds=time.perf_counter() - t0, registers=regs,
         library=str(lib.relative_to(_build.BUILD_ROOT.parents[1])))
    return regs


def phase_residency(regs: dict) -> None:
    """Kernels B, E and F at N = 10 and 40: shared memory per block, the
    registers and spills of the instantiation that runs there (R register
    slots a lane, nz <= 32 R), resident one-warp blocks per SM; kernel A
    (blocks of 128 threads) at N = 10, kernel C (one warp a block) at N = 10
    and 40; kernels D (one warp a block) and J (one block of
    ``mpcq_condense_ab_threads()`` a scenario) at N = 10 and 40."""
    lib = _build.load_library()
    rows = {}
    blocks = lib.mpcq_lin_occupancy(10)
    row = {"kernel": "lin_kernel", "instantiation": "lin", "N": 10,
           "smem_bytes": lib.mpcq_lin_ws_bytes(10), **regs.get("lin", {}),
           "resident_blocks_per_sm": blocks, "resident_warps_per_sm": 4 * blocks}
    emit("residency", **row)
    check(blocks > 0, f"residency: kernel A does not launch: {row}")
    for N in (10, N_LONG):
        blocks = lib.mpcq_riccati_occupancy(N)
        row = {"kernel": "riccati_ipm", "instantiation": "riccati", "N": N,
               "smem_bytes": lib.mpcq_riccati_ws_bytes(N),
               "scratch_bytes_per_scenario": lib.mpcq_riccati_scratch_bytes(N),
               **regs.get("riccati", {}), "resident_blocks_per_sm": blocks,
               "resident_warps_per_sm": blocks}
        rows[("riccati_ipm", N)] = row
        emit("residency", **row)
    c40 = rows[("riccati_ipm", N_LONG)]["resident_warps_per_sm"]
    check(c40 > RICCATI_WARPS_BEFORE,
          f"residency: kernel C keeps {c40} warps per SM at N={N_LONG}, not more than "
          f"{RICCATI_WARPS_BEFORE}")
    for N in (10, N_LONG):
        nz = 4 * N
        slots = -(-nz // 32)
        for name, key, smem, blocks in (
                ("sqp_fused_kernel", f"sqp_fused<{slots}>", lib.mpcq_sqp_ws_bytes(N),
                 lib.mpcq_sqp_occupancy(0, N)),
                ("qp_kernel", f"box_qp<{slots}>", lib.mpcq_box_qp_ws_bytes(nz),
                 lib.mpcq_box_qp_occupancy(nz)),
                ("sqp_step_kernel", f"sqp_step<{slots}>", lib.mpcq_sqp_step_ws_bytes(N),
                 lib.mpcq_sqp_occupancy(1, N))):
            row = {"kernel": name, "instantiation": key, "N": N, "nz": nz, "smem_bytes": smem,
                   **regs.get(key, {}), "resident_blocks_per_sm": blocks,
                   "resident_warps_per_sm": blocks}
            rows[(name, N)] = row
            emit("residency", **row)
            check(blocks > 0, f"residency: {name} at N={N} does not launch: {row}")
    b10 = rows[("sqp_fused_kernel", 10)]["resident_warps_per_sm"]
    check(b10 >= RESIDENT_WARPS_MIN,
          f"residency: kernel B keeps {b10} warps per SM at N=10, fewer than {RESIDENT_WARPS_MIN}")
    nt = lib.mpcq_condense_ab_threads()
    for N in (10, N_LONG):
        for name, key, threads, blocks in (
                ("condense_kernel", "condense", 32, lib.mpcq_condense_occupancy(N)),
                ("condense_ab_kernel", "condense_ab", nt, lib.mpcq_condense_ab_occupancy(N))):
            row = {"kernel": name, "instantiation": key, "N": N, "threads_per_block": threads,
                   "smem_bytes": lib.mpcq_condense_ws_bytes(N), **regs.get(key, {}),
                   "resident_blocks_per_sm": blocks,
                   "resident_warps_per_sm": blocks * threads // 32}
            rows[(name, N)] = row
            emit("residency", **row)
            check(blocks > 0, f"residency: {name} at N={N} does not launch: {row}")
    d10 = rows[("condense_kernel", 10)]["resident_warps_per_sm"]
    check(d10 > CONDENSE_WARPS_BEFORE,
          f"residency: kernel D keeps {d10} warps per SM at N=10, not more than "
          f"{CONDENSE_WARPS_BEFORE}")
    warps = lib.mpcq_transpose_block_warps(PROBE_NZ)
    for name, key, mirror in (("mirror_probe", "mirror", 1), ("elem_probe", "elem", 0)):
        blocks = lib.mpcq_transpose_occupancy(mirror, PROBE_NZ)
        row = {"kernel": name, "instantiation": key, "nz": PROBE_NZ, "warps_per_block": warps,
               "smem_bytes": warps * lib.mpcq_transpose_ws_bytes(PROBE_NZ), **regs.get(key, {}),
               "resident_blocks_per_sm": blocks, "resident_warps_per_sm": blocks * warps}
        emit("residency", **row)
        check(warps > 0 and blocks > 0, f"residency: {name} at nz={PROBE_NZ} does not launch: {row}")


def phase_kernel_a(device) -> dict:
    solver, carry, _, _, aug = kernel_inputs(SOLVE_B, device)
    f, dt = solver.f, solver.cfg.dt
    X, U = carry.X, carry.U
    xp, J = lin_kernel.linearize(X, U, aug, f, dt)
    xp_p, J_p = lin_kernel.linearize_plain(f, X, U, aug, dt)
    f64 = make_mpc_dynamics(solver.f.params.map(lambda a: a.double()))
    xp_d, J_d = lin_kernel.linearize_plain(f64, X.double(), U.double(),
                                           aug.map(lambda a: a.double()), dt)
    err = {"xp_vs_plain": (xp - xp_p).abs().max().item(),
           "J_vs_plain": (J - J_p).abs().max().item(),
           "xp_vs_f64": (xp.double() - xp_d).abs().max().item(),
           "J_vs_f64": (J.double() - J_d).abs().max().item()}
    del xp_p, J_p, xp_d, J_d

    # NaN isolation: poison one scenario's trajectory (a quaternion entry,
    # which every tangent depends on); every other scenario's xp and J must
    # be bitwise unchanged
    bad = 7
    X_bad = X.clone()
    X_bad[bad, 3, 4] = float("nan")
    nan_isolated = isolated(bad, (xp, J), lin_kernel.linearize(X_bad, U, aug, f, dt))
    del X_bad

    ms = timed_ms(lambda: lin_kernel.linearize(X, U, aug, f, dt), reps=10)
    plain_ms = timed_ms(lambda: lin_kernel.linearize_plain(f, X, U, aug, dt), reps=2)
    work = bounds.lin_work(SOLVE_B, solver.cfg.n_nodes, N_BASIS)
    emit("kernel_a", B=SOLVE_B, **err, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_lin_ws_bytes(solver.cfg.n_nodes), **work,
         tol_xp=LIN_XP_TOL, tol_J=LIN_J_TOL)
    check(torch.isfinite(J).all() and torch.isfinite(xp).all(), "kernel A: non-finite output")
    check(err["xp_vs_plain"] <= LIN_XP_TOL and err["xp_vs_f64"] <= LIN_XP_TOL, f"kernel A xp: {err}")
    check(err["J_vs_plain"] <= LIN_J_TOL and err["J_vs_f64"] <= LIN_J_TOL, f"kernel A J: {err}")
    check(nan_isolated, "kernel A: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": max(err["xp_vs_plain"], err["J_vs_plain"]), "ms": ms, "plain_ms": plain_ms,
            **work}


def phase_kernel_b(device) -> dict:
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    q, p, rw = cfg.weight_tuples()
    args = step_args(solver, carry, x0, y_ref, aug)
    z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_from_J(*args, q, p, rw, cfg.qp_iters)
    z_p, _, kkt_p, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, cfg.qp_iters)
    z_d, dX_d, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(
        *[a.double() for a in args], q, p, rw, cfg.qp_iters)
    err = {"z_kernel_vs_f64": (z.double() - z_d).abs().max().item(),
           "z_plain_vs_f64": (z_p.double() - z_d).abs().max().item(),
           "dX_kernel_vs_f64": (dX.double() - dX_d).abs().max().item(),
           "kkt_kernel_max": kkt.max().item(), "kkt_plain_max": kkt_p.max().item(),
           "kkt_f64_max": kkt_d.max().item(),
           "kkt_kernel_max_where_f64_converged": kkt[kkt_d <= 1e-4].max().item(),
           "f64_converged_share": (kkt_d <= 1e-4).double().mean().item(),
           "kkt_kernel_share_le_1e-3": (kkt <= QP_KKT_TOL).double().mean().item(),
           "kkt_f64_share_le_1e-3": (kkt_d <= QP_KKT_TOL).double().mean().item()}

    # NaN isolation: poison one scenario's J; every other scenario's outputs
    # must be bitwise unchanged
    bad = 7
    J_bad = args[0].clone()
    J_bad[bad, 3, 5, 8] = float("nan")
    out_b = sqp_fused_kernel.fused_sqp_from_J(J_bad, *args[1:], q, p, rw, cfg.qp_iters)
    nan_isolated = isolated(bad, (z, dX, kkt, zl, zu), out_b)

    ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J(*args, q, p, rw, cfg.qp_iters), reps=5)
    plain_ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J_plain(*args, q, p, rw, cfg.qp_iters),
                        reps=2)
    work = bounds.sqp_from_J_work(SOLVE_B, cfg.n_nodes, cfg.qp_iters)
    emit("kernel_b", B=SOLVE_B, **err, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_sqp_ws_bytes(cfg.n_nodes), **work,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(torch.isfinite(z).all() and torch.isfinite(dX).all(), "kernel B: non-finite output")
    check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
          "kernel B: duals not finite and positive")
    check(err["z_kernel_vs_f64"] < QP_Z_TOL and err["z_plain_vs_f64"] < QP_Z_TOL, f"kernel B z: {err}")
    check(err["kkt_kernel_max"] <= err["kkt_f64_max"] + QP_KKT_TOL,
          f"kernel B max KKT beyond the f32 floor over the oracle's: {err}")
    check(err["kkt_kernel_share_le_1e-3"] >= err["kkt_f64_share_le_1e-3"] - 0.01,
          f"kernel B converges in fewer scenarios than the f64 oracle: {err}")
    check(nan_isolated, "kernel B: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["z_kernel_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_c(device) -> dict:
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device, N=N_LONG, qp_method="riccati")
    cfg = solver.cfg
    w = cfg.weight_tuples()
    X, U = carry.X, carry.U
    xp, J = lin_kernel.linearize(X, U, aug, solver.f, cfg.dt)
    args = [J, *solver.riccati_inputs(X, U, x0, y_ref, y_ref[:, -1], xp)]
    kernel = lambda a: riccati_kernel.riccati_ipm_from_J(*a, *w, cfg.qp_iters)
    du, dX = kernel(args)
    du_p, _ = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args, *w, cfg.qp_iters)
    args64 = [a.double() for a in args]
    du_d, _ = riccati_kernel.solve_ocp_box_riccati_ipm_plain(*args64, *w, cfg.qp_iters)
    roll = riccati_kernel.affine_rollout(*args64[:3], du.double())
    err = {"du_kernel_vs_f64": (du.double() - du_d).abs().max().item(),
           "du_plain_vs_f64": (du_p.double() - du_d).abs().max().item(),
           "du_kernel_vs_plain": (du - du_p).abs().max().item(),
           "dX_vs_rollout_of_du": (dX.double() - roll).abs().max().item(),
           "dX_max_abs": roll.abs().max().item()}
    del args64, du_d, du_p, roll

    bad = 7
    J_bad = J.clone()
    J_bad[bad, N_LONG // 2, 5, 8] = float("nan")
    nan_isolated = isolated(bad, (du, dX), kernel([J_bad] + args[1:]))
    del J_bad

    ms = timed_ms(lambda: kernel(args), reps=3)
    plain_ms = timed_ms(lambda: riccati_kernel.solve_ocp_box_riccati_ipm_plain(
        *args, *w, cfg.qp_iters), reps=1)
    work = bounds.riccati_work(SOLVE_B, N_LONG, cfg.qp_iters)
    lib = _build.load_library()
    emit("kernel_c", B=SOLVE_B, N=N_LONG, **err, nan_isolated=nan_isolated,
         smem_bytes=lib.mpcq_riccati_ws_bytes(N_LONG),
         scratch_bytes=SOLVE_B * lib.mpcq_riccati_scratch_bytes(N_LONG), ms=ms,
         plain_ms=plain_ms, **work, tol_du=RIC_DU_TOL, tol_dX_rel=RIC_DX_REL_TOL)
    check(torch.isfinite(du).all() and torch.isfinite(dX).all(), "kernel C: non-finite output")
    check(err["du_kernel_vs_f64"] < RIC_DU_TOL and err["du_plain_vs_f64"] < RIC_DU_TOL,
          f"kernel C dU: {err}")
    check(err["dX_vs_rollout_of_du"] <= RIC_DX_REL_TOL * max(1.0, err["dX_max_abs"]),
          f"kernel C dX is not the rollout of dU: {err}")
    check(nan_isolated, "kernel C: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": err["du_kernel_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def condense_stats(kernel, plain, args, w, poison) -> tuple:
    """A condensing kernel's H, g, M, d against its f32 and f64 plain
    versions, relative to each array's largest entry, H's exact symmetry,
    and NaN isolation with scenario 7's inputs poisoned by `poison`:
    (outputs, stats)."""
    out = kernel(*args, *w)
    ref = plain(*[a.double() for a in args], *w)
    p32 = plain(*args, *w)
    rel = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()
    err = {f"{k}_kernel_vs_f64_rel": rel(a, b) for k, a, b in zip("HgMd", out, ref)}
    err.update({f"{k}_plain_vs_f64_rel": rel(a, b) for k, a, b in zip("HgMd", p32, ref)})
    err["max_abs_err"] = max((a.double() - b).abs().max().item() for a, b in zip(out, ref))
    del ref, p32
    err["H_symmetric"] = torch.equal(out[0], out[0].mT)
    if out[0].shape[0] > 7:
        err["nan_isolated"] = isolated(7, out, kernel(*poison(args, 7), *w))
    return out, err


def check_condense(name: str, err: dict) -> None:
    check(all(v < COND_REL_TOL for k, v in err.items() if k.endswith("_rel")), f"{name}: {err}")
    check(err["H_symmetric"], f"{name}: H is not exactly symmetric")
    check(err.get("nan_isolated", True), f"{name}: a NaN scenario changed another scenario's outputs")


def poison_first(args, bad):
    first = args[0].clone()
    first[bad, 3, 5, 8] = float("nan")
    return [first] + list(args[1:])


def phase_kernel_d(device) -> dict:
    """Condensing at the main path's shapes: H, g, M, d against the f32 and
    f64 plain versions, relative to each array's largest entry."""
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    w = cfg.weight_tuples()
    args = step_args(solver, carry, x0, y_ref, aug)[:4]
    out, err = condense_stats(condense_kernel.condense_cost_from_J,
                              condense_kernel.condense_cost_from_J_plain, args, w, poison_first)
    del out
    ms = timed_ms(lambda: condense_kernel.condense_cost_from_J(*args, *w), reps=5)
    plain_ms = timed_ms(lambda: condense_kernel.condense_cost_from_J_plain(*args, *w), reps=2)
    work = bounds.condense_work(SOLVE_B, cfg.n_nodes)
    emit("kernel_d", B=SOLVE_B, **err, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_condense_ws_bytes(cfg.n_nodes), **work,
         tol_rel=COND_REL_TOL)
    check_condense("kernel D", err)
    return {"max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_d_long(device) -> None:
    """Kernel D at N=40 (its largest workspace, 70,724 B a block) against its
    f32 and f64 plain versions, on kernel B's N=40 inputs
    (``hover_long_inputs``, B=512)."""
    B = 512
    solver, carry, x0, y_ref, aug = hover_long_inputs(B, device)
    args = step_args(solver, carry, x0, y_ref, aug)[:4]
    out, err = condense_stats(condense_kernel.condense_cost_from_J,
                              condense_kernel.condense_cost_from_J_plain, args,
                              solver.cfg.weight_tuples(), poison_first)
    emit("kernel_d_n40", B=B, N=N_LONG, **err,
         smem_bytes=_build.load_library().mpcq_condense_ws_bytes(N_LONG), tol_rel=COND_REL_TOL)
    check(all(torch.isfinite(a).all() for a in out), "kernel D N=40: non-finite output")
    check_condense("kernel D N=40", err)


def phase_kernel_j(device) -> dict:
    """Condensing fed A and B, the small-batch step's, at the latency path's
    B=1 (timed there: per call through the wrapper, CUDA events, and the
    kernel's device time from the profiler) and at B = SMALL_BATCH - 1 with
    NaN isolation: against its f32 and f64 plain versions, and bitwise
    against kernel D on the J that A and B came from (the same stage loop)."""
    rows, res = {}, None
    for B in (1, sqp.SMALL_BATCH - 1):
        solver, carry, x0, y_ref, aug = kernel_inputs(B, device)
        cfg = solver.cfg
        w = cfg.weight_tuples()
        J, *tail = step_args(solver, carry, x0, y_ref, aug)[:4]
        args = [a.contiguous() for a in split_AB(J)] + tail
        out, err = condense_stats(condense_kernel.condense_cost_from_AB,
                                  condense_kernel.condense_cost_from_AB_plain, args, w,
                                  poison_first)
        err["bitwise_kernel_d"] = all(torch.equal(a, b) for a, b in zip(
            out, condense_kernel.condense_cost_from_J(J, *tail, *w)))
        rows[B] = err
        check_condense(f"kernel J, B={B}", err)
        check(err["bitwise_kernel_d"], f"kernel J, B={B}: differs from kernel D on the same J")
        if B == 1:
            run = lambda: condense_kernel.condense_cost_from_AB(*args, *w)
            ms = timed_ms(run, reps=50)
            # the kernel alone, without the host's launch path
            device_ms = phases.kernel_device_ms(run, "condense_ab", reps=200)
            check(device_ms is not None, "kernel J: the profiler records no launch")
            plain_ms = timed_ms(lambda: condense_kernel.condense_cost_from_AB_plain(*args, *w),
                                reps=5)
            res = {"max_abs_err": err["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                   **bounds.condense_work(1, cfg.n_nodes)}
    emit("kernel_j", **{f"B{B}_{k}": v for B, r in rows.items() for k, v in r.items()},
         ms_at_B1=res["ms"], device_ms_at_B1=device_ms, plain_ms_at_B1=res["plain_ms"],
         bound_ms_at_B1=res["bound_ms"],
         threads_per_block=_build.load_library().mpcq_condense_ab_threads(), tol_rel=COND_REL_TOL)
    check(device_ms > 0, f"kernel J: device time {device_ms} ms")
    return res


def phase_kernel_e(device, warm_start: bool = False) -> dict:
    """The standalone IPM on kernel D's QPs, cold or warm-started from the
    duals of the previous solve, against the f32 and f64 plain IPMs."""
    solver, carry, x0, y_ref, aug = (regulation_inputs(device) if warm_start
                                     else kernel_inputs(SOLVE_B, device))
    cfg = solver.cfg
    args = step_args(solver, carry, x0, y_ref, aug)
    H, g, _, _ = condense_kernel.condense_cost_from_J(*args[:4], *cfg.weight_tuples())
    box = (H, g + args[4], args[5], args[6])
    d32 = (carry.zl, carry.zu) if warm_start else (None, None)
    z, zl, zu = qp_kernel.solve_box_qp_pdip_batch(*box, cfg.qp_iters, *d32)
    box64 = [a.double() for a in box]
    d64 = [None if d is None else d.double() for d in d32]
    z_d, _, _ = qp_kernel.ipm_box_solve(*box64, cfg.qp_iters, *d64)
    z_p, _, _ = qp_kernel.ipm_box_solve(*box, cfg.qp_iters, *d32)
    st = qp_stats(z, qp_kkt_residual(*box, z), z_d, qp_kkt_residual(*box64, z_d))
    st["z_plain_vs_f64"] = (z_p.double() - z_d).abs().max().item()
    del box64, z_d, z_p
    bad = 7
    H_bad = H.clone()
    H_bad[bad, 5, 6] = float("nan")
    nan_isolated = isolated(bad, (z, zl, zu),
                            qp_kernel.solve_box_qp_pdip_batch(H_bad, *box[1:], cfg.qp_iters, *d32))
    del H_bad
    ms = timed_ms(lambda: qp_kernel.solve_box_qp_pdip_batch(*box, cfg.qp_iters, *d32), reps=5)
    plain_ms = timed_ms(lambda: qp_kernel.ipm_box_solve(*box, cfg.qp_iters, *d32), reps=2)
    nz = H.shape[-1]
    work = bounds.box_qp_work(SOLVE_B, nz, cfg.qp_iters, warm=warm_start)
    name = "kernel_e_warm" if warm_start else "kernel_e"
    emit(name, B=SOLVE_B, **st, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_box_qp_ws_bytes(nz), **work,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(torch.isfinite(z).all(), f"{name}: non-finite output")
    check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
          f"{name}: duals not finite and positive")
    check_qp(name, st)
    check(st["z_plain_vs_f64"] < QP_Z_TOL, f"{name} plain z: {st}")
    check(nan_isolated, f"{name}: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": st["z_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def phase_kernel_f(device) -> dict:
    """The whole step in one kernel against its f32 plain version (kernel
    A's, then kernel B's) and the f64 one, and against kernel B fed by
    kernel A on the same inputs."""
    solver, carry, x0, y_ref, aug = kernel_inputs(SOLVE_B, device)
    cfg = solver.cfg
    w = cfg.weight_tuples()
    X, U = carry.X, carry.U
    si = solver.step_inputs(X, U, x0, y_ref, y_ref[:, -1])
    run = lambda XX: sqp_fused_kernel.fused_sqp_step(XX, U, *si, aug, solver.f, cfg.dt, *w,
                                                     cfg.qp_iters)
    out = run(X)
    z_p, _, kkt_p, _, _ = sqp_fused_kernel.fused_sqp_step_plain(X, U, *si, aug, solver.f, cfg.dt,
                                                                *w, cfg.qp_iters)
    f64 = make_mpc_dynamics(solver.f.params.map(lambda a: a.double()))
    dbl = lambda a: a.double()
    z_d, dX_d, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_step_plain(
        dbl(X), dbl(U), *map(dbl, si), aug.map(dbl), f64, cfg.dt, *w, cfg.qp_iters)
    st = qp_stats(out[0], out[2], z_d, kkt_d)
    st["z_plain_vs_f64"] = (z_p.double() - z_d).abs().max().item()
    st["dX_vs_f64"] = (out[1].double() - dX_d).abs().max().item()
    z_b = sqp_fused_kernel.fused_sqp_from_J(*step_args(solver, carry, x0, y_ref, aug), *w,
                                            cfg.qp_iters)[0]
    st["z_vs_kernel_b"] = (out[0] - z_b).abs().max().item()
    bad = 7
    X_bad = X.clone()
    X_bad[bad, 3, 8] = float("nan")
    nan_isolated = isolated(bad, out, run(X_bad))
    ms = timed_ms(lambda: run(X), reps=5)
    plain_ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_step_plain(
        X, U, *si, aug, solver.f, cfg.dt, *w, cfg.qp_iters), reps=2)
    work = bounds.sqp_step_work(SOLVE_B, cfg.n_nodes, N_BASIS, cfg.qp_iters)
    emit("kernel_f", B=SOLVE_B, **st, nan_isolated=nan_isolated, ms=ms, plain_ms=plain_ms,
         smem_bytes=_build.load_library().mpcq_sqp_step_ws_bytes(cfg.n_nodes), **work,
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    check(all(torch.isfinite(a).all() for a in out), "kernel F: non-finite output")
    check(bool((out[3] > 0).all()) and bool((out[4] > 0).all()), "kernel F: duals not positive")
    check_qp("kernel F", st)
    check(st["z_plain_vs_f64"] < QP_Z_TOL, f"kernel F plain z: {st}")
    check(nan_isolated, "kernel F: a NaN scenario changed another scenario's outputs")
    return {"max_abs_err": st["z_vs_f64"], "ms": ms, "plain_ms": plain_ms, **work}


def regulation_inputs(device):
    """Warm-start inputs where warm duals pay: the regulation chain at
    B=65536 after 3 warm ticks, then the next tick's step, with the carry's
    duals."""
    solver, carry, x0, y_ref, rgp = regulation_setup(SOLVE_B, device, True, 12)
    for _ in range(3):
        carry, _ = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    return solver, carry, x0, y_ref, aug


def phase_kernel_b_warm(device) -> dict:
    """Kernel B warm-started with the duals of the previous solve against
    the f64 plain warm step: on the regulation chain (held to kernel B's
    rules), then on the solve cell's transient, where both f32 and f64 stay
    far from the optimum at 12 iterations, so only the KKT distribution is
    held to the oracle's."""
    rows = {}
    for cell, inputs in (("regulation", regulation_inputs),
                         ("solve_cell", lambda d: kernel_inputs(SOLVE_B, d, warm_start_duals=True))):
        solver, carry, x0, y_ref, aug = inputs(device)
        cfg = solver.cfg
        w = cfg.weight_tuples()
        args = step_args(solver, carry, x0, y_ref, aug)
        duals = (carry.zl, carry.zu)
        z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_from_J(*args, *w, cfg.qp_iters,
                                                               duals=duals)
        z_d, _, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(
            *[a.double() for a in args], *w, cfg.qp_iters, duals=tuple(d.double() for d in duals))
        z_cold, _, kkt_cold, _, _ = sqp_fused_kernel.fused_sqp_from_J(*args, *w, cfg.qp_iters)
        st = qp_stats(z, kkt, z_d, kkt_d)
        st.update(z_warm_vs_cold=(z - z_cold).abs().max().item(), kkt_cold_max=kkt_cold.max().item(),
                  kkt_cold_median=kkt_cold.median().item(), kkt_median=kkt.median().item())
        rows[cell] = st
        check(torch.isfinite(z).all() and torch.isfinite(dX).all(), f"kernel B warm, {cell}: non-finite")
        check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
              f"kernel B warm, {cell}: duals not finite and positive")
        check(st["z_warm_vs_cold"] > 0, f"kernel B warm, {cell}: the duals were not used")
        if cell == "regulation":
            check_qp(f"kernel B warm, {cell}", st)
            ms = timed_ms(lambda: sqp_fused_kernel.fused_sqp_from_J(*args, *w, cfg.qp_iters,
                                                                    duals=duals), reps=5)
        else:
            check(st["kkt_max"] <= st["kkt_f64_max"] + QP_KKT_TOL
                  and st["kkt_share_le_1e-3"] >= st["kkt_f64_share_le_1e-3"] - 0.01,
                  f"kernel B warm, {cell}: KKT distribution off the oracle's: {st}")
    emit("kernel_b_warm", B=SOLVE_B, **{f"{c}_{k}": v for c, r in rows.items() for k, v in r.items()},
         ms=ms, **bounds.sqp_from_J_work(SOLVE_B, cfg.n_nodes, cfg.qp_iters, warm=True),
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    return rows


def hover_long_inputs(B: int, device, dtype=torch.float32):
    """Kernel B's inputs at N=40 where the condensed f32 IPM keeps every
    scenario: the benchmark's 1 s horizon at 25 ms nodes, hover at 3 m with
    velocities U(-0.5, 0.5) m/s, y_ref = x0, RGP drag (posterior mean 0.3
    N(0, 1)); the first step from the initial carry."""
    gen = torch.Generator(device="cpu").manual_seed(40)
    p = hummingbird_params(dtype=torch.float32).map(lambda a: a.to(device, dtype))
    cfg = sqp.MPCConfig(n_nodes=N_LONG, t_horizon=1.0, u_ref=float(p.hover_input.float()))
    solver = sqp.SQPSolver(cfg, make_mpc_dynamics(p))
    x0 = torch.zeros((B, 13))
    x0[:, 3] = 1.0
    x0[:, 2] = 3.0
    x0[:, 7:10] = 0.5 * (2.0 * torch.rand((B, 3), generator=gen) - 1.0)
    rgp = rgp_init(torch.linspace(-10, 10, N_BASIS).expand(B, 3, N_BASIS), theta=(3.0, 0.1, 0.01))
    rgp = rgp.replace(mu_g=0.3 * torch.randn((B, 3, N_BASIS), generator=gen))
    x0, rgp = x0.to(device, dtype), rgp.map(lambda a: a.to(device, dtype))
    y_ref = x0[:, None].repeat(1, N_LONG, 1)
    carry = sqp.init_carry(cfg, x0)
    aug = fold_drag(rgp).map(lambda a: a.contiguous())
    return solver, carry, x0, y_ref, aug


def phase_kernel_b_long(device) -> None:
    """Kernel B at N=40 (five register slots a lane, 133 KB a block) against
    its f32 and f64 plain versions, at the operating point of
    ``hover_long_inputs``: the f32 plain version must keep every scenario,
    the kernel is held to kernel B's rules against the f64 oracle."""
    B = 512
    solver, carry, x0, y_ref, aug = hover_long_inputs(B, device)
    w = solver.cfg.weight_tuples()
    iters = solver.cfg.qp_iters
    args = step_args(solver, carry, x0, y_ref, aug)
    z, dX, kkt, zl, zu = sqp_fused_kernel.fused_sqp_from_J(*args, *w, iters)
    z_p, _, kkt_p, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(*args, *w, iters)
    z_d, dX_d, kkt_d, _, _ = sqp_fused_kernel.fused_sqp_from_J_plain(
        *[a.double() for a in args], *w, iters)
    st = qp_stats(z, kkt, z_d, kkt_d)
    st.update(plain_f32_nonfinite_share=(~torch.isfinite(z_p)).any(1).double().mean().item(),
              z_plain_vs_f64=(z_p.double() - z_d).abs().max().item(),
              dX_vs_f64=(dX.double() - dX_d).abs().max().item())
    bad = 7
    J_bad = args[0].clone()
    J_bad[bad, N_LONG // 2, 5, 8] = float("nan")
    nan_isolated = isolated(bad, (z, dX, kkt, zl, zu),
                            sqp_fused_kernel.fused_sqp_from_J(J_bad, *args[1:], *w, iters))
    emit("kernel_b_n40", B=B, N=N_LONG, t_horizon_s=1.0, **st, nan_isolated=nan_isolated,
         smem_bytes=_build.load_library().mpcq_sqp_ws_bytes(N_LONG), tol_z=QP_Z_TOL,
         tol_kkt=QP_KKT_TOL)
    check(st["plain_f32_nonfinite_share"] == 0, f"kernel B N=40: the f32 plain version lost "
          f"scenarios, the operating point does not hold the kernel to anything: {st}")
    check(torch.isfinite(z).all() and torch.isfinite(dX).all(), "kernel B N=40: non-finite output")
    check(torch.isfinite(zl).all() and bool((zl > 0).all()) and bool((zu > 0).all()),
          "kernel B N=40: duals not finite and positive")
    check_qp("kernel B N=40", st)
    check(nan_isolated, "kernel B N=40: a NaN scenario changed another scenario's outputs")


def time_chained(solver, carry0, x0, y_ref, rgp, iters: int, reps: int):
    """(solves/s over `reps` runs of `iters` chained solves after one, the
    last solution)."""
    times, sol = phases.time_solves(solver, carry0, x0, y_ref, rgp, iters, "cuda", reps)
    return x0.shape[0] * len(times) / sum(times), sol


def check_solution(name: str, sol, slack: float = 0.0) -> None:
    check(sol.U.shape == (SOLVE_B, 10, 4) and torch.isfinite(sol.U).all()
          and torch.isfinite(sol.X).all(), f"{name}: bad solve output")
    check(sol.U.min().item() >= -slack and sol.U.max().item() <= 1 + slack,
          f"{name}: controls left the box by more than {slack}")


def phase_pipeline_slice(device, pipeline: str) -> dict:
    """The N=10 slice's chained solves through another pipeline."""
    solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device, pipeline=pipeline)
    solves_per_s, sol = time_chained(solver, carry0, x0, y_ref, rgp, iters=20, reps=3)
    check_solution(f"{pipeline} slice", sol, U_BOX_SLACK)
    emit(f"{pipeline}_slice", B=SOLVE_B, chained_solves=20, solves_per_s=solves_per_s,
         kkt_max=sol.kkt_residual.max().item(), kkt_median=sol.kkt_residual.median().item())
    return {"solves_per_s": solves_per_s}


def phase_pipelines_agree(device) -> None:
    """One solve of the N=10 slice's inputs through each pipeline: max |dU|
    and |dX| of "split" and "fused" against "hybrid" (f32 on the card, each
    held against the f64 oracle in phase slice_vs_cpu_f64)."""
    sols = {}
    for pipe in sqp.PIPELINES:
        solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device, pipeline=pipe)
        _, sols[pipe] = solver.solve_batch(carry0, x0, y_ref, y_ref[:, -1], rgp)
    h = sols["hybrid"]
    row = {}
    for pipe in ("split", "fused"):
        row[f"{pipe}_max_abs_dU_vs_hybrid"] = (sols[pipe].U - h.U).abs().max().item()
        row[f"{pipe}_max_abs_dX_vs_hybrid"] = (sols[pipe].X - h.X).abs().max().item()
        row[f"{pipe}_U_bitwise_hybrid"] = torch.equal(sols[pipe].U, h.U)
        check_solution(f"{pipe} solve", sols[pipe], U_BOX_SLACK)
    emit("pipelines_vs_hybrid", B=SOLVE_B, **row, tol=QP_Z_TOL)
    check(all(v < QP_Z_TOL for k, v in row.items() if "dU" in k), f"pipelines disagree: {row}")
    # the three pipelines run one IPM definition on the same QP
    check(all(v for k, v in row.items() if "bitwise" in k), f"pipelines' U not bitwise equal: {row}")


def phase_warm_chain(device) -> dict:
    """The regulation chain at B=65536, 40 ticks: cold at 12 IPM iterations,
    warm at 6 and at 12, each through "hybrid"; then one warm tick through
    "split" and "fused", so kernels E and F run warm on the card too."""
    rows = {}
    for warm, iters in ((False, 12), (True, 6), (True, 12)):
        summary, carry, _ = regulation_chain(SOLVE_B, device, warm, iters, ticks=40)
        key = f"{'warm' if warm else 'cold'}{iters}"
        rows[key] = summary
        check(torch.isfinite(carry.U).all() and carry.U.min().item() >= -U_BOX_SLACK
              and carry.U.max().item() <= 1 + U_BOX_SLACK,
              f"warm chain {key}: controls not finite or out of the box")
        if warm:
            check(torch.isfinite(carry.zl).all() and bool((carry.zl > 0).all())
                  and bool((carry.zu > 0).all()), f"warm chain {key}: duals not finite and positive")
    for pipe in ("split", "fused"):
        summary, carry, _ = regulation_chain(SOLVE_B, device, True, 6, ticks=1, pipeline=pipe)
        rows[f"{pipe}_warm6_one_tick"] = summary
        check(torch.isfinite(carry.U).all() and bool((carry.zl > 0).all()),
              f"warm chain, {pipe}: bad tick")
    emit("warm_chain", B=SOLVE_B, ticks=40,
         **{f"{k}_{m}": v[m] for k, v in rows.items() for m in ("kkt_max", "kkt_median")})
    return rows


def phase_slice(device) -> dict:
    iters = 20
    solver, carry0, x0, y_ref, rgp = operating_point(SOLVE_B, device)
    solves_per_s, sol = time_chained(solver, carry0, x0, y_ref, rgp, iters=iters, reps=3)
    check_solution("slice", sol)

    # one-scenario latency (the small-batch step): 50 chained solves per
    # CUDA-event-timed run, 20 runs
    p50, p99 = headline.one_scenario_latency(solver, carry0, x0, y_ref, rgp, device)
    emit("slice", B=SOLVE_B, chained_solves=iters, solves_per_s=solves_per_s,
         latency_p50_ms=p50, latency_p99_ms=p99, kkt_max=sol.kkt_residual.max().item())
    return {"solves_per_s": solves_per_s, "p50": p50, "p99": p99}


def phase_slice_vs_cpu(device) -> None:
    """The card's f32 solve against the f64 plain solve on the CPU, through
    each pipeline."""
    B = 256
    s64, c64, x64, y64, r64 = operating_point(B, "cpu", torch.float64, mu_scale=0.3)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], r64)
    row = {}
    for pipe in sqp.PIPELINES:
        solver, carry, x0, y_ref, rgp = operating_point(B, device, mu_scale=0.3, pipeline=pipe)
        _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        row[f"{pipe}_max_abs_dU" if pipe != "hybrid" else "max_abs_dU"] = (
            sol.U.double().cpu() - ref.U).abs().max().item()
    emit("slice_vs_cpu_f64", B=B, **row, tol=QP_Z_TOL)
    check(all(v < QP_Z_TOL for v in row.values()), f"slice: card f32 vs CPU f64 max |dU| {row}")


def phase_riccati_vs_cpu(device) -> None:
    """The card's f32 Riccati solve at N=40 against the f64 one on the CPU."""
    B = 256
    kw = dict(mu_scale=0.3, N=N_LONG, qp_method="riccati")
    solver, carry, x0, y_ref, rgp = operating_point(B, device, **kw)
    _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
    s64, c64, x64, y64, r64 = operating_point(B, "cpu", torch.float64, **kw)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], r64)
    du = (sol.U.double().cpu() - ref.U).abs().max().item()
    emit("riccati_vs_cpu_f64", B=B, N=N_LONG, max_abs_dU=du,
         max_abs_dX=(sol.X.double().cpu() - ref.X).abs().max().item(),
         kkt_max=sol.kkt_residual.max().item(), kkt_f64_max=ref.kkt_residual.max().item(),
         tol=RIC_VS_CPU_TOL)
    check(du < RIC_VS_CPU_TOL, f"riccati: card f32 vs CPU f64 max |dU| = {du}")


def phase_riccati_slice(device) -> dict:
    """solve_batch(qp_method="auto") at N=40 takes kernels A and C; "pdip" at
    N=41, past FUSED_N_MAX, warns and takes them too."""
    iters = 10
    solver, carry, x0, y_ref, rgp = operating_point(SOLVE_B, device, N=N_LONG, qp_method="auto")
    check(solver._resolve_qp_method() == "riccati", "riccati slice: auto did not pick riccati")
    solves_per_s, sol = time_chained(solver, carry, x0, y_ref, rgp, iters, reps=1)
    check(sol.U.shape == (SOLVE_B, N_LONG, 4) and torch.isfinite(sol.U).all()
          and torch.isfinite(sol.X).all(), "riccati slice: bad solve output")
    check(bool(((sol.U >= 0) & (sol.U <= 1)).all()), "riccati slice: controls left the box")
    kkt = sol.kkt_residual

    c_before = riccati_kernel.riccati_ipm_from_J.launches
    b_before = sqp_fused_kernel.fused_sqp_from_J.launches
    n_past = sqp.FUSED_N_MAX + 1
    sp, cp, xp0, yp, rp = operating_point(1024, device, N=n_past, qp_method="pdip")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, solp = sp.solve_batch(cp, xp0, yp, yp[:, -1], rp)
    torch.cuda.synchronize()
    warned = any("condensed kernels' ceiling" in str(m.message) for m in caught)
    pdip_took_c = (riccati_kernel.riccati_ipm_from_J.launches == c_before + 1
                   and sqp_fused_kernel.fused_sqp_from_J.launches == b_before)
    emit("riccati_slice", B=SOLVE_B, N=N_LONG, chained_solves=iters, solves_per_s=solves_per_s,
         kkt_max=kkt.max().item(), kkt_median=kkt.median().item(),
         pdip_past_n=n_past, pdip_past_warned=warned, pdip_past_took_kernel_c=pdip_took_c)
    check(warned and pdip_took_c, f"riccati slice: pdip at N={n_past} did not fall back to kernel C")
    check(torch.isfinite(solp.U).all(), "riccati slice: pdip fallback gave non-finite controls")
    return {"solves_per_s": solves_per_s}


def solve_stats(sol, ref) -> dict:
    """A card solve against the f64 CPU solve: |dU| and the KKT distribution
    (kernel B's rules, ``check_qp``)."""
    return qp_stats(sol.U.flatten(1), sol.kkt_residual.cpu(), ref.U.flatten(1).to(sol.U.device),
                    ref.kkt_residual)


def phase_solve_vs_cpu(device) -> None:
    """The per-scenario solve on the card (f32) against the CPU's (f64) at
    the solve cell's operating point, B=1024: "pdip" and "projected_newton"
    at N=10 (kernels A and D, the unscaled IPM or projected Newton in tensor
    code), "riccati" at N=40 (kernels A and C); NaN isolation on the card.
    Projected Newton is held to the oracle's KKT distribution only: 12 of
    its iterations leave most of these QPs far from their optimum (86 % above
    KKT 1e-3 in f64, the JAX package's algorithm), where an active set that
    rounding flips moves a control across its box (|dU| 0.99 on the card)."""
    rows = {}
    for method, N in (("pdip", 10), ("projected_newton", 10), ("riccati", N_LONG)):
        kw = dict(mu_scale=0.3, N=N, qp_method=method)
        solver, carry, x0, y_ref, rgp = operating_point(PER_SCENARIO_B, device, **kw)
        _, sol = solver.solve(carry, x0, y_ref, y_ref[:, -1], rgp)
        s64, c64, x64, y64, r64 = operating_point(PER_SCENARIO_B, "cpu", torch.float64, **kw)
        _, ref = s64.solve(c64, x64, y64, y64[:, -1], r64)
        st = solve_stats(sol, ref)
        bad = 7
        x_bad = x0.clone()
        x_bad[bad, 8] = float("nan")
        _, sol_bad = solver.solve(carry, x_bad, y_ref, y_ref[:, -1], rgp)
        st["nan_isolated"] = isolated(bad, (sol.U, sol.X, sol.cost, sol.kkt_residual),
                                      (sol_bad.U, sol_bad.X, sol_bad.cost, sol_bad.kkt_residual))
        st["nonfinite_share"] = (~torch.isfinite(sol.U)).flatten(1).any(1).double().mean().item()
        rows[f"{method}_N{N}"] = st
    emit("solve_vs_cpu_f64", B=PER_SCENARIO_B, **{f"{m}_{k}": v for m, r in rows.items()
                                                  for k, v in r.items()},
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL)
    for name, st in rows.items():
        check(st["nonfinite_share"] == 0, f"solve {name}: non-finite controls {st}")
        check(st["nan_isolated"], f"solve {name}: a NaN scenario changed another scenario's outputs")
        if name.startswith("projected_newton"):
            check(st["kkt_max"] <= st["kkt_f64_max"] + QP_KKT_TOL
                  and st["kkt_share_le_1e-3"] >= st["kkt_f64_share_le_1e-3"] - 0.01,
                  f"solve {name}: KKT distribution off the oracle's: {st}")
        else:
            check_qp(f"solve {name}", st)


def phase_solve_batch_shapes(device) -> None:
    """``solve_batch`` at the ROS shapes, N=5 (the horizon of the ROS parity
    logs) and N=10 with 20 RGP basis vectors a axis (the ROS default), on
    the card (kernels A and B) against its f64 plain version on the CPU, by
    kernel B's rules, except that the share of scenarios at KKT <= 1e-3 may
    trail the lower of the oracle's and the f32 plain version's (on the CPU)
    by one point: at 20 basis vectors a third of the scenarios sit within a
    factor of two of 1e-3 in f64, where f32 rounding alone moves the share."""
    row = {}
    for tag, kw in (("N5", dict(N=5)), ("nb20", dict(n_basis=20))):
        solver, carry, x0, y_ref, rgp = operating_point(PER_SCENARIO_B, device, mu_scale=0.3, **kw)
        _, sol = solver.solve_batch(carry, x0, y_ref, y_ref[:, -1], rgp)
        ref, plain = ({}, {})
        for out, dtype in ((ref, torch.float64), (plain, torch.float32)):
            s_, c_, x_, y_, r_ = operating_point(PER_SCENARIO_B, "cpu", dtype, mu_scale=0.3, **kw)
            out["sol"] = s_.solve_batch(c_, x_, y_, y_[:, -1], r_)[1]
        row[tag] = st = solve_stats(sol, ref["sol"])
        st["kkt_plain_f32_share_le_1e-3"] = (plain["sol"].kkt_residual <= QP_KKT_TOL).double().mean().item()
        st["finite"] = bool(torch.isfinite(sol.U).all() and torch.isfinite(sol.X).all())
    emit("solve_batch_ros_shapes", B=PER_SCENARIO_B,
         **{f"{t}_{k}": v for t, r in row.items() for k, v in r.items()}, tol_z=QP_Z_TOL,
         tol_kkt=QP_KKT_TOL)
    for tag, st in row.items():
        check(st["finite"], f"solve_batch {tag}: non-finite output")
        check(st["z_vs_f64"] < QP_Z_TOL, f"solve_batch {tag} z: {st}")
        check(st["kkt_max"] <= st["kkt_f64_max"] + QP_KKT_TOL,
              f"solve_batch {tag}: max KKT beyond the f32 floor over the oracle's: {st}")
        floor = min(st["kkt_f64_share_le_1e-3"], st["kkt_plain_f32_share_le_1e-3"])
        check(st["kkt_share_le_1e-3"] >= floor - 0.01,
              f"solve_batch {tag} converges in fewer scenarios than the oracle and the f32 plain "
              f"version: {st}")


def phase_per_scenario_auto_range(device) -> None:
    """The per-scenario solve's condensed step in f32 from N=16 to N=31,
    where the JAX package's per-scenario "auto" still takes it (its switch is
    at 32) and the port's takes the Riccati step: ms per solve and the share
    of scenarios with non-finite controls, B=16384 as the crossover rows."""
    rows = [per_scenario_row(CROSS_B, N, reps=2, device=device) for N in AUTO_RANGE_N]
    emit("per_scenario_auto_range", rows=rows, auto_switch=sqp.AUTO_RICCATI_MIN_N)
    check(finite(rows), f"per-scenario auto range: {rows}")


def phase_episode_cpu_f64() -> dict:
    """The single episode on the CPU in f64, the card episode's reference
    (run before the card paths, whose plain versions are fenced off)."""
    ep = per_scenario.episode("cpu", torch.float64, t_max=EPISODE_T_MAX)
    emit("episode_cpu_f64", **ep)
    check(ep["finite"] and ep["err_mean_m"] < ERR_MEAN_TOL, f"episode on the CPU: {ep}")
    return ep


def phase_episode(device, ref: dict) -> dict:
    """``run_episode`` for one hummingbird in f32, a tick a call (the tick's
    wall time), then one scenario's ``solve`` alone (CUDA events): kernels A
    and J, the unscaled IPM in tensor code."""
    ep = per_scenario.episode(device, t_max=EPISODE_T_MAX)
    lat = per_scenario.solve_latency(device)
    rel = abs(ep["err_mean_m"] - ref["err_mean_m"]) / ref["err_mean_m"]
    emit("episode", **ep, solve_p50_ms=lat["solve_p50_ms"], solve_p99_ms=lat["solve_p99_ms"],
         solve_chained=lat["chained"], solve_runs=lat["runs"], err_mean_m_cpu_f64=ref["err_mean_m"],
         err_rel_vs_cpu_f64=rel, tol_err=ERR_MEAN_TOL, tol_rel=EPISODE_ERR_REL_TOL)
    check(ep["finite"], f"episode: non-finite output {ep}")
    check(ep["u_min"] >= -U_BOX_SLACK and ep["u_max"] <= 1 + U_BOX_SLACK,
          f"episode: controls left the box {ep}")
    check(ep["err_mean_m"] < ERR_MEAN_TOL, f"episode: err_mean_m {ep['err_mean_m']} >= {ERR_MEAN_TOL}")
    check(rel <= EPISODE_ERR_REL_TOL, f"episode: err_mean_m {ep['err_mean_m']} not within "
          f"{EPISODE_ERR_REL_TOL} of the CPU f64 run's {ref['err_mean_m']}")
    return {**ep, **lat}


def phase_episode_batch(device) -> dict:
    """``run_episode_batch`` (the per-scenario solve: kernels A and D, the
    unscaled IPM) on the closed loop's scenario, 16384 x 100 ticks."""
    cl = closed_loop(B=CLOSED_B, v=8.0, t_max=10.0, device=device, per_scenario=True)
    emit("episode_batch", **cl, tol_err=ERR_MEAN_TOL)
    check(math.isfinite(cl["err_mean_m"]) and math.isfinite(cl["err_p95_m"]),
          f"episode batch: non-finite error {cl}")
    check(cl["err_mean_m"] < ERR_MEAN_TOL, f"episode batch: err_mean_m {cl['err_mean_m']}")
    return cl


def phase_hetero(device) -> dict:
    """``run_episode_batch_fused`` on a heterogeneous batch of 16384 (v_max
    4, 8 and 12 m/s: traj_len and episode_ticks each episode's own), then 10
    ticks with control_skip = 10 on a trajectory sampled 10x finer against
    the same ticks on its every tenth sample."""
    summary, final, outs = hetero_closed_loop(B=CLOSED_B, device=device)
    # every finished episode logs its frozen state at each later tick, and
    # its carry is that state
    frozen = bool(((outs.x_odom == final.x[:, None]).all(-1) | outs.active).all())
    skip = skip_closed_loop(B=CLOSED_B, ticks=10, device=device)
    emit("hetero", **summary, frozen_bitwise=frozen, control_skip=skip, tol_err=HETERO_ERR_TOL)
    check(frozen, "hetero: a finished episode's state moved")
    check(math.isfinite(summary["rmse_mean_m"]) and summary["rmse_mean_m"] < HETERO_ERR_TOL,
          f"hetero: masked tracking error {summary}")
    check(skip["finite"] and skip["bitwise_equal_to_coarse"],
          f"hetero: control_skip=10 differs from the coarse trajectory's run {skip}")
    return summary


def phase_crossover(device) -> None:
    """Condensed against Riccati as N grows; N=16 is where "auto" switches.
    Below AUTO_RICCATI_MIN_N the condensed step must keep every scenario."""
    for N in (10, 16, 20, 30, 80):
        row = crossover_row(CROSS_B, N, reps=2, device=device)
        emit("crossover", **row, auto=sqp.SQPSolver(sqp.MPCConfig(n_nodes=N, qp_method="auto"),
                                                    None)._resolve_qp_method())
        if N < sqp.AUTO_RICCATI_MIN_N:
            check(row["condensed_nonfinite_share"] == 0,
                  f"crossover: the condensed step lost scenarios below AUTO_RICCATI_MIN_N: {row}")


def phase_closed_loop(device) -> dict:
    """The gp2 closed loop; its episodes' learning metric rides along
    (``cov``, for ``phase_paper_metric``)."""
    cl, outs = closed_loop(B=CLOSED_B, v=8.0, t_max=10.0, device=device, outputs=True)
    cov = velocity_error_covariances(outs)
    del outs
    emit("closed_loop", **cl)
    check(math.isfinite(cl["err_mean_m"]) and math.isfinite(cl["err_p95_m"]),
          f"closed loop: non-finite error {cl}")
    check(cl["err_mean_m"] < ERR_MEAN_TOL, f"closed loop: err_mean_m {cl['err_mean_m']} >= {ERR_MEAN_TOL}")
    return {**cl, "cov": cov}


def gp1_aug(gp, B: int, dtype, device):
    """The gp1 state folded in its own float64, cast to `dtype` on `device`
    (the kernels take float32) and broadcast to B scenarios."""
    return fold_drag(gp).map(lambda a: a.to(device, dtype).expand((B,) + a.shape).contiguous())


def phase_gp1_training(device) -> dict:
    """gp1_workflow, steps 1-3 and 7: the gp0 training flight of the closed
    loop's fleet (fused loop), episode 0's log, ``DataLoaderGP``, the fit
    (``train_gp``, float64 on the card) saved and read back, then the
    offline RGP (``train_rgp`` and ``rgp_learn``) on the card and on the
    CPU in float64."""
    GP1_DIR.mkdir(parents=True, exist_ok=True)
    gp0, log_path, outs = gp1_workflow.training_flight(CLOSED_B, str(GP1_DIR), device, outputs=True)
    cov_gp0 = velocity_error_covariances(outs)
    del outs
    emit("gp1_training_flight", **gp0, log=os.path.relpath(log_path, GP1_DIR.parents[1]))
    check(math.isfinite(gp0["err_mean_m"]) and math.isfinite(gp0["err_p95_m"]),
          f"gp1 training flight: non-finite error {gp0}")
    gpe, fitted = gp1_workflow.fit(log_path, str(GP1_DIR / "gp1"), device)
    emit("gp1_fit", **fitted)
    check(fitted["reloaded_bitwise"], "gp1 fit: the model files do not reload to the fitted state")
    check(torch.isfinite(gpe.state.alpha).all() and torch.isfinite(gpe.state.K_inv).all(),
          f"gp1 fit: non-finite state {fitted}")
    rgp = gp1_workflow.offline_rgp(log_path, str(GP1_DIR), device)
    emit("gp1_offline_rgp", **rgp, tol_rel=OFFLINE_REL_TOL)
    check(rgp["finite"], f"offline RGP: non-finite state {rgp}")
    check(rgp["train_rgp_rel_vs_cpu"] <= OFFLINE_REL_TOL and rgp["rgp_learn_rel_vs_cpu"] <= OFFLINE_REL_TOL,
          f"offline RGP: the card's float64 run is off the CPU's {rgp}")
    return {"gp": gpe.state, "gp0": gp0, "fit": fitted, "offline_rgp": rgp, "cov_gp0": cov_gp0}


def phase_gp1_solve(device, gp) -> None:
    """gp1_workflow, step 4: ``solve_batch`` at the solve cell's operating
    point, B=1024, with the fitted GP (folded in float64, cast to float32)
    for the drag, against the f64 solve on the CPU (kernel B's rules), NaN
    isolation; kernel A at the solution against its f64 plain version on the
    same float32 weights (``phase_kernel_a``'s rule, or this data's float32
    floor where that is higher), and the drag mean and x+ against the f64
    plain version at the fitted float64 state (reported: the float32 fold's
    error)."""
    solver, carry0, x0, y_ref, _ = operating_point(PER_SCENARIO_B, device, mu_scale=0.3)
    aug = gp1_aug(gp, PER_SCENARIO_B, torch.float32, device)
    carry, sol = solver.solve_batch(carry0, x0, y_ref, y_ref[:, -1], aug)
    s64, c64, x64, y64, _ = operating_point(PER_SCENARIO_B, "cpu", torch.float64, mu_scale=0.3)
    _, ref = s64.solve_batch(c64, x64, y64, y64[:, -1], gp1_aug(gp, PER_SCENARIO_B, torch.float64, "cpu"))
    st = solve_stats(sol, ref)
    bad = 7
    x_bad = x0.clone()
    x_bad[bad, 8] = float("nan")
    _, sol_bad = solver.solve_batch(carry0, x_bad, y_ref, y_ref[:, -1], aug)
    st["nan_isolated"] = isolated(bad, (sol.U, sol.X, sol.cost, sol.kkt_residual),
                                  (sol_bad.U, sol_bad.X, sol_bad.cost, sol_bad.kkt_residual))
    st["finite"] = bool(torch.isfinite(sol.U).all() and torch.isfinite(sol.X).all())

    f, dt = solver.f, solver.cfg.dt
    X, U = carry.X, carry.U
    f64 = make_mpc_dynamics(f.params.map(lambda a: a.double()))
    aug64 = gp1_aug(gp, PER_SCENARIO_B, torch.float64, device)
    xp, J = lin_kernel.linearize(X, U, aug, f, dt)
    xp_p, J_p = lin_kernel.linearize_plain(f, X, U, aug, dt)
    xp_d, J_d = lin_kernel.linearize_plain(f64, X.double(), U.double(), aug.map(lambda a: a.double()), dt)
    xp_t, _ = lin_kernel.linearize_plain(f64, X.double(), U.double(), aug64, dt)
    per_stage = lambda a: a[:, None]
    mean32 = gp_mean_world(X, aug.map(per_stage))
    mean64 = gp_mean_world(X.double(), aug64.map(per_stage))
    err = lambda a, b: (a.double() - b.double()).abs().max().item()
    lin = {"xp_vs_f64": err(xp, xp_d), "J_vs_f64": err(J, J_d),
           "xp_plain_vs_f64": err(xp_p, xp_d), "J_plain_vs_f64": err(J_p, J_d),
           "xp_vs_plain": err(xp, xp_p), "J_vs_plain": err(J, J_p),
           "xp_vs_f64_fitted_state": err(xp, xp_t),
           "drag_mean_abs_max": mean64.abs().max().item(),
           "drag_mean_vs_f64_fitted_state": err(mean32, mean64)}
    # kernel A's rule, or the float32 floor of these inputs where it is
    # higher: the fitted GP's drag reaches ~70 m/s^2 as a sum of terms of
    # alternating sign, so float32 rounds it by more than kernel A's
    # tolerances; the f32 plain version's error against the same f64
    # measures that floor, and the kernel, another order of the same
    # operations, may reach twice it
    tol_xp = max(LIN_XP_TOL, 2 * lin["xp_plain_vs_f64"])
    tol_J = max(LIN_J_TOL, 2 * lin["J_plain_vs_f64"])
    emit("gp1_solve_vs_cpu_f64", B=PER_SCENARIO_B, **st, **{f"kernel_a_{k}": v for k, v in lin.items()},
         tol_z=QP_Z_TOL, tol_kkt=QP_KKT_TOL, tol_xp=tol_xp, tol_J=tol_J)
    check(st["finite"], f"gp1 solve: non-finite output {st}")
    check(st["nan_isolated"], "gp1 solve: a NaN scenario changed another scenario's outputs")
    check_qp("gp1 solve", st)
    check(lin["xp_vs_f64"] <= tol_xp, f"gp1 kernel A xp: {lin}")
    check(lin["J_vs_f64"] <= tol_J, f"gp1 kernel A J: {lin}")


def phase_gp1_flight(device, gp, gp0: dict, gp2: dict) -> dict:
    """gp1_workflow, step 5: the fitted GP through the fused loop on the
    closed loop's fleet at full width (16384 x 100 ticks), beside the gp0
    training flight and the gp2 closed loop of this run.  Episode 0 is the
    drone the GP was fitted to: its error is held to ERR_MEAN_TOL; the other
    drones' drag is 0.5-2x its own, so the fleet is held to beat gp0."""
    cl, outs = closed_loop(B=CLOSED_B, v=8.0, t_max=10.0, device=device, drag=gp, outputs=True)
    err0 = (outs.x_odom[0, 30:, :3] - outs.x_ref[0, 30:, :3]).double().norm(dim=-1).mean().item()
    u = outs.w_odom
    cl.update(err_mean_m_episode0=err0, u_min=u.min().item(), u_max=u.max().item())
    emit("gp1_closed_loop", **cl, gp0_tick_solves_per_s=gp0["tick_solves_per_s"],
         gp0_err_mean_m=gp0["err_mean_m"], gp0_err_p95_m=gp0["err_p95_m"],
         gp2_tick_solves_per_s=gp2["tick_solves_per_s"], gp2_err_mean_m=gp2["err_mean_m"],
         gp2_err_p95_m=gp2["err_p95_m"], tol_err=ERR_MEAN_TOL)
    check(math.isfinite(cl["err_mean_m"]) and math.isfinite(cl["err_p95_m"])
          and bool(torch.isfinite(outs.x_odom).all()), f"gp1 closed loop: non-finite {cl}")
    check(cl["u_min"] >= -U_BOX_SLACK and cl["u_max"] <= 1 + U_BOX_SLACK,
          f"gp1 closed loop: controls left the box {cl}")
    check(err0 < ERR_MEAN_TOL, f"gp1 closed loop: the fitted drone's error {err0} >= {ERR_MEAN_TOL}")
    check(cl["err_mean_m"] < gp0["err_mean_m"],
          f"gp1 closed loop: the fleet's error {cl['err_mean_m']} is not below gp0's {gp0['err_mean_m']}")
    return cl


def phase_gp1_episode_batch(device, gp, fused: dict) -> dict:
    """gp1_workflow, step 6: ``run_episode_batch`` (the per-scenario solve,
    kernels A and D) in gp1 at B=1024 for 20 ticks, against the fused loop's
    run of the same episodes (`fused`, made before the counters were reset):
    the tracking error from tick 10 within EPISODE_ERR_REL_TOL of it."""
    cl = closed_loop(B=GP1_EPISODE_B, v=8.0, t_max=GP1_EPISODE_T, device=device, drag=gp,
                     per_scenario=True, err_from=GP1_ERR_FROM)
    rel = abs(cl["err_mean_m"] - fused["err_mean_m"]) / fused["err_mean_m"]
    emit("gp1_episode_batch", **cl, fused_err_mean_m=fused["err_mean_m"], err_rel_vs_fused=rel,
         tol_rel=EPISODE_ERR_REL_TOL)
    check(math.isfinite(cl["err_mean_m"]) and math.isfinite(cl["err_p95_m"]),
          f"gp1 episode batch: non-finite error {cl}")
    check(rel <= EPISODE_ERR_REL_TOL, f"gp1 episode batch: error {cl['err_mean_m']} not within "
          f"{EPISODE_ERR_REL_TOL} of the fused loop's {fused['err_mean_m']}")
    return cl


def phase_paper_metric(cov_gp0: np.ndarray, cov_gp2: np.ndarray) -> dict:
    """The paper's learning metric off the flights this run already made:
    each episode's cov(v, e) per axis (``Visualiser``) in the gp0 training
    flight and the gp2 closed loop, the same fleet; the ratio |gp0| / |gp2|
    of episode 0 and the fleet's median ratio, each held above
    PAPER_RATIO_MIN on x and y."""
    ratio = np.abs(cov_gp0) / np.abs(cov_gp2)
    row = {"episodes": int(ratio.shape[0]), "ratio_episode0_xyz": ratio[0].tolist(),
           "ratio_median_xyz": np.median(ratio, axis=0).tolist(),
           "cov_gp0_episode0_xyz": cov_gp0[0].tolist(), "cov_gp2_episode0_xyz": cov_gp2[0].tolist(),
           "abs_cov_gp0_median_xyz": np.median(np.abs(cov_gp0), axis=0).tolist(),
           "abs_cov_gp2_median_xyz": np.median(np.abs(cov_gp2), axis=0).tolist(),
           "tol_ratio": PAPER_RATIO_MIN}
    emit("paper_metric", **row)
    for key in ("ratio_episode0_xyz", "ratio_median_xyz"):
        check(min(row[key][:2]) > PAPER_RATIO_MIN,
              f"paper metric: {key} {row[key]} not above {PAPER_RATIO_MIN} on x and y")
    return row


def phase_cli(device) -> dict:
    """``run.main`` with the reference's own command at the closed loop's
    fleet width (``-o`` a log): the batched route, ``run_episode_batch_fused``
    (kernels A and B).  The fleet's timing and RMSE are the line the command
    prints (the loop's seconds to 10 ms, the RMSE to 1 mm); drone 0's
    flight is its log."""
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    log_path = CLI_DIR / "gp2_v10.pkl"
    argv = [*CLI_ARGS, "-o", str(log_path)]
    out = StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv)
    main_s = time.perf_counter() - t0
    stdout = out.getvalue().splitlines()
    found = [m for m in map(CLI_REPORT.search, stdout) if m]
    check(len(found) == 1, f"cli: no fleet report line in {stdout}")
    m = found[0]
    episodes, ticks, seconds = int(m["episodes"]), int(m["ticks"]), float(m["seconds"])
    log = load_dict(str(log_path))
    x, u = np.stack(log["x_odom"]), np.stack(log["w_odom"])
    rmse = {k: float(m[k]) for k in ("mean", "min", "max")}
    row = {"command": "python -m mpc_quad_ros_tpu_torch.run " + " ".join(argv[:-1]) + " OUT.pkl",
           "exit_code": rc, "episodes": episodes, "ticks": ticks, "seconds": seconds,
           "main_s": main_s, "tick_solves_per_s": episodes * ticks / seconds,
           "rmse_mean_m": rmse["mean"], "rmse_min_m": rmse["min"], "rmse_max_m": rmse["max"],
           "drone0_u_min": float(u.min()), "drone0_u_max": float(u.max()),
           "log_keys": sorted(log), "log_ticks": int(x.shape[0]), "stdout": stdout,
           "tol_rmse_mean": CLI_RMSE_TOL}
    emit("cli", **row)
    check(rc == 0, f"cli: run.main returned {rc}")
    check(episodes == CLOSED_B and all(math.isfinite(v) for v in rmse.values()),
          f"cli: the fleet report is off {row}")
    check(bool(np.isfinite(x).all() and np.isfinite(u).all()) and x.shape == (ticks, 13),
          f"cli: non-finite or misshapen log {row}")
    check(row["drone0_u_min"] >= -U_BOX_SLACK and row["drone0_u_max"] <= 1 + U_BOX_SLACK,
          f"cli: controls left the box {row}")
    check(row["rmse_mean_m"] < CLI_RMSE_TOL, f"cli: rmse mean {row['rmse_mean_m']} >= {CLI_RMSE_TOL}")
    check({"x_odom", "x_ref", "w_odom", "t_odom", "t_cpu", "rgp_mu_g_t"} <= set(log),
          f"cli: the log lacks the reference's keys {sorted(log)}")
    return row


def phase_minsnap(device) -> dict:
    """Trajectory 1 (random waypoints, hsize 30, 10 waypoints, seed 0) by
    ``run.build_trajectory`` (the numpy min-snap), the native min-snap held
    to the numpy one, then the first MINSNAP_TICKS ticks of the trajectory
    through the fused loop at B=MINSNAP_B (gp2, the closed loop's fleet)."""
    cfg = SimConfig(gpe=2, trajectory=1, v_max=10.0, a_max=10.0, seed=0)
    x0_pos = np.array([0.0, 0.0, 3.0])
    t0 = time.perf_counter()
    x_traj, ts = run.build_trajectory(cfg, x0_pos, sqp.MPCConfig().dt)
    build_s = time.perf_counter() - t0
    wp = random_waypoints(hsize=30.0, num_waypoints=10, start_point=x0_pos, seed=0)
    py = min_snap_trajectory(wp, cfg.v_max, cfg.a_max, backend="python")
    check(native_available(), "minsnap: the native library does not build (g++)")
    t0 = time.perf_counter()
    nat = native_min_snap_trajectory(wp, cfg.v_max, cfg.a_max)
    native_s = time.perf_counter() - t0
    tq = np.linspace(0.0, py.duration * 0.999, 2000)
    dur_rel = float(np.abs(nat.durations - py.durations).max() / np.abs(py.durations).max())
    pos_err = float(np.abs(nat.eval_flat(tq)["pos"] - py.eval_flat(tq)["pos"]).max())

    ecfg, solver, pb, x0, _, rgp = setup(MINSNAP_B, v=cfg.v_max, t_max=1.0, device=device)
    traj = torch.as_tensor(x_traj, dtype=torch.float32, device=device)
    traj = traj.expand((MINSNAP_B,) + traj.shape)
    run_episode_batch_fused(ecfg, solver, pb, x0, traj, 2, rgp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = run_episode_batch_fused(ecfg, solver, pb, x0, traj, MINSNAP_TICKS, rgp)
    torch.cuda.synchronize()
    fly_s = time.perf_counter() - t0
    err = (outs.x_odom[..., :3] - outs.x_ref[..., :3]).double().norm(dim=-1)
    u = outs.w_odom
    row = {"waypoints": int(wp.shape[0]), "duration_s": py.duration, "samples": int(len(ts)),
           "build_trajectory_s": build_s, "native_s": native_s,
           "native_durations_rel_vs_numpy": dur_rel, "native_pos_vs_numpy_m": pos_err,
           "episodes": MINSNAP_B, "ticks": MINSNAP_TICKS,
           "tick_solves_per_s": MINSNAP_B * MINSNAP_TICKS / fly_s,
           "err_mean_m": err.mean().item(), "err_max_m": err.max().item(),
           "v_ref_max_m_s": float(np.linalg.norm(x_traj[:MINSNAP_TICKS, 7:10], axis=1).max()),
           "u_min": u.min().item(), "u_max": u.max().item(),
           "tol_durations_rtol": MINSNAP_DUR_RTOL, "tol_pos_m": MINSNAP_POS_TOL,
           "tol_err_mean_m": ERR_MEAN_TOL}
    emit("minsnap", **row)
    check(dur_rel <= MINSNAP_DUR_RTOL and pos_err <= MINSNAP_POS_TOL,
          f"minsnap: native against numpy {row}")
    check(bool(torch.isfinite(outs.x_odom).all()) and math.isfinite(row["err_mean_m"]),
          f"minsnap: non-finite flight {row}")
    check(row["u_min"] >= -U_BOX_SLACK and row["u_max"] <= 1 + U_BOX_SLACK,
          f"minsnap: controls left the box {row}")
    check(row["err_mean_m"] < ERR_MEAN_TOL, f"minsnap: err_mean_m {row['err_mean_m']}")
    return row


def phase_matrix(device) -> dict:
    """``compare.run_matrix_batched`` on a JSON of gpe 0, 1, 2 at v_max 4, 8,
    12 m/s on the circle, MATRIX_TICKS ticks: one fused batch of 3 a gpe
    mode (below SMALL_BATCH: the small-batch step, kernels A, J, E); gpe 1
    flies the GP of the gp1 workflow's fit."""
    MATRIX_DIR.mkdir(parents=True, exist_ok=True)
    spec = {"runs": [{"gpe": g, "trajectory": 2, "v_max": v, "a_max": v}
                     for g in (0, 1, 2) for v in MATRIX_V]}
    path = MATRIX_DIR / "matrix.json"
    path.write_text(json.dumps(spec))
    t0 = time.perf_counter()
    rows = compare.run_matrix_batched(str(path), str(MATRIX_DIR / "logs"), verbose=False,
                                      max_ticks=MATRIX_TICKS, gp_path=str(GP1_DIR / "gp1"),
                                      device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    logs = sorted(os.listdir(MATRIX_DIR / "logs"))
    emit("matrix", runs=len(rows), ticks=MATRIX_TICKS, seconds=seconds, rows=rows, logs=len(logs))
    check(len(rows) == len(spec["runs"]) == len(logs), f"matrix: {len(rows)} rows, {len(logs)} logs")
    check(all(math.isfinite(r["mean_rmse_pos"]) and math.isfinite(r["v_peak"]) for r in rows),
          f"matrix: non-finite rows {rows}")
    return {"rows": rows, "seconds": seconds}


def phase_profile(device) -> dict:
    """``io/profiling.py::profile_solver_phases`` at the solve cell's
    operating point with RGP drag, B=SOLVE_B, N=10: kernel A, kernel D,
    kernel E and the whole hybrid ``solve_batch`` (A + B), CUDA events."""
    solver, carry, x0, y_ref, rgp = operating_point(SOLVE_B, device, mu_scale=0.3)
    res = profile_solver_phases(solver, carry, x0, y_ref, rgp, iters=10)
    emit("profile", **res, ms={k[:-2]: res[k] * 1e3 for k in ("linearize_s", "assemble_s", "qp_s",
                                                            "full_solve_s")})
    check(all(math.isfinite(res[k]) and res[k] > 0 for k in res), f"profile: {res}")
    return res


def node_flight(device, dtype, ticks: int) -> tuple:
    """The gp2 node at the ROS shapes from the ground, flown by ``SimLoop``
    for `ticks` odometry ticks: (node, loop, published commands)."""
    published = []
    p = hummingbird_params(dtype=torch.float64)
    node = ros.ControllerNode(p, ros.TrajectoryServer(), publish_control=published.append,
                              use_gp=2, dtype=dtype, device=device)
    loop = ros.SimLoop(node, p, NODE_X0)
    loop.run(max_ticks=ticks)
    return node, loop, published


def node_log(node) -> tuple:
    """The node's logged states and their position tracking errors."""
    d = node.logger.dictionary
    x = np.asarray(d["x_odom"])
    return x, np.linalg.norm(x[:, :3] - np.asarray(d["x_ref"])[:, :3], axis=1)


def phase_node_cpu_f64() -> dict:
    """The node's flight on the CPU in f64 through NODE_CPU_TICKS, the card
    flight's reference (run before the card paths, whose plain versions are
    fenced off)."""
    t0 = time.perf_counter()
    node, _, _ = node_flight("cpu", torch.float64, NODE_CPU_TICKS)
    x, err = node_log(node)
    row = {"ticks": NODE_CPU_TICKS, "logged": int(x.shape[0]), "err_mean_m": float(err.mean()),
           "seconds": time.perf_counter() - t0}
    emit("node_cpu_f64", **row)
    check(x.shape[0] >= 5 and np.isfinite(x).all(), f"node on the CPU: {row}")
    return {**row, "x": x}


def phase_node(device, ref: dict) -> dict:
    """The ROS node on the card: the bootstrap line, then the circle; each
    tick's wall time (host clock; the state comes back to the host each
    tick), the compute's (``elapsed_during_mpc``, after a synchronize), the
    tracking error, and the card's flight against the CPU's f64."""
    node, loop, published = node_flight(device, torch.float32, NODE_TICKS)
    x, err = node_log(node)
    d = node.logger.dictionary
    n_ref = ref["logged"]
    motors = np.stack([c.motors for c in published])
    tick_ms = np.asarray(loop.tick_s) * 1e3
    mpc_ms = np.asarray(d["elapsed_during_mpc"]) * 1e3
    x_vs_cpu = float(np.abs(x[:5] - ref["x"][:5]).max())
    err_ref = float(err[:n_ref].mean())
    row = {"ticks": len(loop.tick_s), "bootstrap_ticks": len(loop.tick_s) - int(x.shape[0]),
           "logged": int(x.shape[0]), "commands": len(published),
           "tick_p50_ms": float(np.median(tick_ms)), "tick_max_ms": float(tick_ms.max()),
           "elapsed_during_mpc_p50_ms": float(np.median(mpc_ms)),
           "elapsed_during_mpc_max_ms": float(mpc_ms.max()),
           "err_mean_m": float(err.mean()), "err_max_m": float(err.max()),
           "finite": bool(np.isfinite(x).all() and np.isfinite(np.asarray(d["w_odom"])).all()
                          and np.isfinite(motors).all()),
           "motors_min": float(motors.min()), "motors_max": float(motors.max()),
           "doing_a_line": node.doing_a_line, "trajectory_len": len(node.x_trajectory),
           "rgp_on": str(node.rgp_state.mu_g.device),
           "x_first5_vs_cpu_f64": x_vs_cpu, "cpu_logged": n_ref, "err_mean_first_m": err_ref,
           "err_mean_first_m_cpu_f64": ref["err_mean_m"],
           "err_rel_vs_cpu_f64": abs(err_ref - ref["err_mean_m"]) / ref["err_mean_m"],
           "tol_x": NODE_X_TOL, "tol_rel": EPISODE_ERR_REL_TOL}
    emit("node", **row)
    check(row["ticks"] == NODE_TICKS and row["commands"] == NODE_TICKS, f"node: ticks {row}")
    check(row["finite"], f"node: non-finite state or command {row}")
    check(row["motors_min"] >= 0.0 and row["motors_max"] <= 1.0, f"node: motors left [0, 1] {row}")
    # the state machine passed from the bootstrap line to the circle (30 s
    # at 100 Hz)
    check(row["bootstrap_ticks"] > 0 and not node.doing_a_line and row["trajectory_len"] == 3000,
          f"node: no passage from the line to the circle {row}")
    check(x_vs_cpu < NODE_X_TOL, f"node: first states {x_vs_cpu} off the CPU f64 flight's")
    check(row["err_rel_vs_cpu_f64"] <= EPISODE_ERR_REL_TOL,
          f"node: tracking error not within {EPISODE_ERR_REL_TOL} of the CPU f64 flight's {row}")
    return row


def phase_node_position(device) -> dict:
    """The crazyflie in cmdPosition actuation with the onboard controller's
    stand-in (``position_controller_motors``) and the plant on the card: a
    climb from hover that must finish within the 1 m ball."""
    p = crazyflie_params()
    base = ros.TrajectoryServer()

    class Climb(ros.TrajectoryServer):
        def handle(self, req):
            return base.handle(ros.TrajectoryRequest("line", NODE_HOVER[:3], CLIMB_END,
                                                     v_max=1.0, a_max=1.0))

    published = []
    node = ros.ControllerNode(p, Climb(), publish_control=published.append, v_max=1.0,
                              a_max=1.0, actuation="position", device=device)
    loop = ros.SimLoop(node, p, NODE_HOVER, position_tracking="dynamic")
    x_final = loop.run(max_ticks=2000)
    row = {"ticks": len(loop.tick_s), "finished": node.finished,
           "x_final": x_final[:3].tolist(), "error_m": float(np.linalg.norm(x_final[:3] - CLIMB_END)),
           "tick_p50_ms": float(np.median(loop.tick_s) * 1e3),
           "position_commands": all(isinstance(c, ros.PositionCommand) for c in published),
           "finite": bool(np.isfinite(x_final).all())}
    emit("node_position", **row)
    check(row["finite"] and row["position_commands"] and node.finished
          and row["error_m"] < node.EPSILON_TRAJECTORY_FINISHED,
          f"node_position: the climb did not finish in the ball {row}")
    return row


def phase_node_sockets(device) -> dict:
    """The trajectory service behind TcpRpcServer / TcpRpcClient and the
    node's ControlCommands through TcpPublisher / TcpSubscriber on
    localhost, the node on the card, flying the JAX transport test's line."""
    base = ros.TrajectoryServer()

    class Line(ros.TrajectoryServer):
        def handle(self, req):
            return base.handle(ros.TrajectoryRequest("line", NODE_HOVER[:3], SOCKET_END,
                                                     v_max=2.0, a_max=2.0))

    rpc = TcpRpcServer(Line().handle)
    client = TcpRpcClient(rpc.host, rpc.port)
    pub = TcpPublisher()
    received = []
    sub = TcpSubscriber(pub.host, pub.port, received.append)
    try:
        deadline = time.time() + 10.0
        while len(pub._clients) < 1 and time.time() < deadline:
            time.sleep(0.01)
        p = hummingbird_params()
        node = ros.ControllerNode(p, client, publish_control=pub, v_max=2.0, a_max=2.0,
                                  device=device)
        loop = ros.SimLoop(node, p, NODE_HOVER)
        x_final = loop.run(max_ticks=2000)
        sent = node.idx_traj
        deadline = time.time() + 10.0
        while len(received) < sent and time.time() < deadline:
            time.sleep(0.01)
    finally:
        pub.close()
        sub.close()
        client.close()
        rpc.close()
    row = {"ticks": len(loop.tick_s), "commands_sent": sent, "commands_received": len(received),
           "finished": node.finished, "x_final": x_final[:3].tolist(),
           "error_m": float(np.linalg.norm(x_final[:3] - SOCKET_END)),
           "tick_p50_ms": float(np.median(loop.tick_s) * 1e3), "tol": SOCKET_TOL}
    emit("node_sockets", **row)
    check(node.finished and row["error_m"] < SOCKET_TOL, f"node_sockets: the line {row}")
    # the tick that finishes the line publishes its command and ends the loop
    check(row["commands_received"] == sent == row["ticks"] + 1
          and all(isinstance(c, ros.ControlCommand) for c in received),
          f"node_sockets: not one command a control tick {row}")
    return row


def phase_hello_world(device) -> dict:
    """The takeoff and landing (``hello_world``, the crazyflie, N=10) on the
    card."""
    t0 = time.perf_counter()
    res = hello.hello_world(device=device, verbose=False)
    row = {"seconds": time.perf_counter() - t0, "tol": HELLO_TOL,
           **{f"{k}_error_m": v["error_m"] for k, v in res.items()},
           **{f"{k}_x_final": v["x_final"][:3].tolist() for k, v in res.items()}}
    emit("hello_world", **row)
    check(all(v["error_m"] < HELLO_TOL for v in res.values()), f"hello_world: {row}")
    return row


def phase_entry_cpu_f64() -> dict:
    """``entry()``'s solve on the CPU in f64, the card's reference (run
    before the card paths, whose plain versions are fenced off)."""
    fn, args = entry_mod.entry(device="cpu", dtype=torch.float64)
    return dict(zip(("U", "X", "cost"), fn(*args)))


def phase_entry(device, ref: dict) -> dict:
    """``entry()``'s solve once on the card (kernels A and J), against its
    f64 CPU solve by the one-drone rule."""
    fn, args = entry_mod.entry(device=device)
    t0 = time.perf_counter()
    U, X, cost = fn(*args)
    torch.cuda.synchronize()
    row = {"seconds": time.perf_counter() - t0, "U_shape": list(U.shape),
           "u_vs_cpu_f64": (U.double().cpu() - ref["U"]).abs().max().item(),
           "x_vs_cpu_f64": (X.double().cpu() - ref["X"]).abs().max().item(),
           "cost": cost.item(), "cost_cpu_f64": ref["cost"].item(), "tol": NODE_X_TOL}
    emit("entry", **row)
    check(bool(torch.isfinite(U).all() and torch.isfinite(X).all()), f"entry: non-finite {row}")
    check(row["u_vs_cpu_f64"] <= NODE_X_TOL and row["x_vs_cpu_f64"] <= NODE_X_TOL,
          f"entry: card against the CPU's f64 {row}")
    return row


def phase_multiprocess_ref() -> dict:
    """The f64 oracle of the farm's solve on the CPU: the chained solves of
    MP_REF_ROWS scenarios at the start of each rank's slice (scenarios are
    independent, so a subset's chain is the whole's)."""
    p, cfg, solver, rgp1 = mp_worker.solver_setup(12, "cpu")
    p = p.map(lambda a: a.double())
    solver = sqp.SQPSolver(cfg, make_mpc_dynamics(p))
    x0, y_ref, ref = mp_worker.build_inputs(MP_B, cfg.n_nodes)
    half = MP_B // MP_NPROC
    idx = np.concatenate([np.arange(r * half, r * half + MP_REF_ROWS) for r in range(MP_NPROC)])
    x0, y_ref, ref = (torch.as_tensor(a[idx], dtype=torch.float64) for a in (x0, y_ref, ref))
    rgp = mp_worker.batch_rgp(rgp1.map(lambda a: a.double()), len(idx))
    carry = sqp.init_carry(cfg, x0)
    for _ in range(MP_CHAIN):
        carry, sol = solver.solve_batch(carry, x0, y_ref, ref, rgp)
    return {"idx": idx, "U": sol.U}


def phase_multiprocess(device) -> dict:
    """The farm's ranks on the card (``launch_workers``); the kernels launch
    in the ranks, which report their counts."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = launch_workers(nproc=MP_NPROC, global_batch=MP_B, qp_iters=12, chain=MP_CHAIN,
                         ticks=MP_TICKS, repeats=MP_REPEATS, device=device.type)
    return {"results": res, "seconds": time.perf_counter() - t0}


def worker_launches(results: list) -> dict:
    """The ranks' launch counts summed, by kernel name."""
    out = dict.fromkeys(KERNELS, 0)
    for r in results:
        for k, v in r.items():
            if k.startswith("launches_"):
                out[k.split("_", 2)[2]] += int(v)
    return out


def phase_multiprocess_check(device, mp: dict, ref: dict) -> dict:
    """Each rank's rows against the single-process card run of the same
    scenarios, the reduced sums across ranks and against the single
    process's, the episode leg."""
    res = mp["results"]
    p, cfg, solver, rgp1 = mp_worker.solver_setup(12, device)
    x0, y_ref, y_ref_N = (torch.as_tensor(a, device=device)
                          for a in mp_worker.build_inputs(MP_B, cfg.n_nodes))
    rgp = mp_worker.batch_rgp(rgp1, MP_B)
    carry = sqp.init_carry(cfg, x0)
    for _ in range(MP_CHAIN):
        carry, sol = solver.solve_batch(carry, x0, y_ref, y_ref_N, rgp)
    U, cost = sol.U.cpu().numpy(), sol.cost.cpu().numpy()
    half = MP_B // MP_NPROC
    Ug = np.concatenate([r["U_local"] for r in res])
    costg = np.concatenate([r["cost_local"] for r in res])
    bitwise = bool(np.array_equal(Ug, U) and np.array_equal(costg, cost))
    u_ref = ref["U"].numpy()
    row = {"processes": MP_NPROC, "global_batch": MP_B, "per_rank": half, "chain": MP_CHAIN,
           "ticks": MP_TICKS, "repeats": MP_REPEATS, "seconds": mp["seconds"],
           "backend": [str(r["backend"]) for r in res], "device": [str(r["device"]) for r in res],
           "launches": [{k[len("launches_"):]: int(v) for k, v in r.items()
                         if k.startswith("launches_") and int(v)} for r in res],
           "bitwise_vs_single_process": bitwise,
           "u_vs_single_process": float(np.abs(Ug - U).max()),
           "cost_vs_single_process": float(np.abs(costg - cost).max()),
           "u_vs_f64_subset": float(np.abs(Ug[ref["idx"]] - u_ref).max()),
           "kkt_sum": [float(r["kkt_sum"]) for r in res],
           "cost_sum": [float(r["cost_sum"]) for r in res],
           "cost_sum_single_process": float(sol.cost.sum()),
           "kkt_sum_single_process": float(sol.kkt_residual.sum()),
           "ep_sq_err_sum": [float(r["ep_sq_err_sum"]) for r in res],
           "ep_n": float(res[0]["ep_n"]),
           "solves_per_s": float(res[0]["solves_per_sec"]),
           "sec_per_step": float(res[0]["sec_per_step"]),
           "note": "both ranks time-share one card: solves/s measures contention, not scaling",
           "tol_u_vs_f64": QP_Z_TOL, "tol_sum_rtol": MP_SUM_RTOL}
    emit("multiprocess", **row)
    check(all(b == "gloo" for b in row["backend"]), f"multiprocess: backend {row['backend']}")
    check(all(d.startswith("cuda") for d in row["device"]), f"multiprocess: device {row['device']}")
    if not bitwise:
        check(row["u_vs_f64_subset"] < QP_Z_TOL, f"multiprocess: rows against f64 {row}")
        shifted = float(np.abs(Ug - np.roll(U, 1, axis=0)).mean())
        check(shifted > 10 * max(float(np.abs(Ug - U).mean()), 1e-7),
              f"multiprocess: rows not routed to their scenarios {row}")
    for k in ("kkt_sum", "cost_sum", "ep_sq_err_sum"):
        check(len(set(row[k])) == 1, f"multiprocess: {k} differs across ranks {row[k]}")
    check(abs(row["cost_sum"][0] - row["cost_sum_single_process"])
          <= MP_SUM_RTOL * abs(row["cost_sum_single_process"]), f"multiprocess: cost sum {row}")
    check(abs(row["kkt_sum"][0] - row["kkt_sum_single_process"])
          <= MP_SUM_RTOL * abs(row["kkt_sum_single_process"]), f"multiprocess: kkt sum {row}")
    check(row["ep_n"] == MP_B and all(np.isfinite(r["ep_x_local"]).all() for r in res),
          f"multiprocess: the episode leg {row}")
    return row


def phase_parity_replay(device) -> dict:
    """The episode path's drone flown untimed with its posterior logged, then
    its log replayed by ``bench/parity.py`` on the card (kernels A and J
    each tick, in both)."""
    t0 = time.perf_counter()
    flight = per_scenario.logged_flight(str(PARITY_LOG), device, t_max=EPISODE_T_MAX)
    check(flight["finite"], f"parity_replay: the logged flight {flight}")
    t1 = time.perf_counter()
    r = parity.replay_reference_log(str(PARITY_LOG), device=device, **PARITY_REPLAY)
    torch.cuda.synchronize()
    return {**r, "flight_seconds": t1 - t0, "seconds": time.perf_counter() - t1}


def phase_parity_check(card: dict) -> dict:
    """The card's replay against the CPU's f64 replay of the same log (run
    after the card paths, with the plain versions back)."""
    t0 = time.perf_counter()
    cpu = parity.replay_reference_log(str(PARITY_LOG), device="cpu", **PARITY_REPLAY)
    du = np.abs(card["u_ours"] - cpu["u_ours"])
    row = {"ticks": len(card["u_ours"]), "flight_seconds": card["flight_seconds"],
           "seconds": card["seconds"],
           "cpu_f64_seconds": time.perf_counter() - t0,
           **{f"{k}_vs_logged": v for k, v in card.items() if k.startswith("du_")},
           **{f"{k}_vs_logged_cpu_f64": v for k, v in cpu.items() if k.startswith("du_")},
           "du_max_vs_cpu_f64": float(du.max()), "du_mean_vs_cpu_f64": float(du.mean()),
           "tol": PARITY_TOL}
    emit("parity_replay", **row)
    check(np.isfinite(card["u_ours"]).all(), f"parity_replay: non-finite {row}")
    check(row["du_max_vs_cpu_f64"] <= PARITY_TOL, f"parity_replay: card against f64 {row}")
    return row


def phase_gen_trajectory() -> dict:
    """The ``gen_trajectory`` CLI on the minsnap path's waypoints against the
    native library at the CSV's 6 decimals."""
    t0 = time.perf_counter()
    exe = gen_trajectory_path()
    build_s = time.perf_counter() - t0
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    wp = random_waypoints(hsize=30.0, num_waypoints=10, start_point=np.array([0.0, 0.0, 3.0]),
                          seed=0)
    wp_csv, out_csv = GEN_DIR / "waypoints.csv", GEN_DIR / "poly.csv"
    np.savetxt(wp_csv, wp, fmt="%.6f", delimiter=",")
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe), "-i", str(wp_csv), "-o", str(out_csv), "--v_max", "10",
                           "--a_max", "10"], capture_output=True, text=True, timeout=60)
    run_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"gen_trajectory exited {proc.returncode}: {proc.stderr}")
    poly = PiecewisePolynomial4D.loadcsv(str(out_csv))
    nat = native_min_snap_trajectory(np.loadtxt(wp_csv, delimiter=","), 10.0, 10.0)
    bad = subprocess.run([str(exe)], capture_output=True, text=True, timeout=60).returncode
    six = np.vectorize(lambda v: float(f"{v:.6f}"))
    row = {"build_s": build_s, "run_s": run_s, "segments": len(poly.durations),
           "durations_vs_native": float(np.abs(poly.durations - nat.durations).max()),
           "coeffs_vs_native": float(np.abs(poly.coeffs - nat.coeffs).max()),
           "equal_at_6_decimals": bool(np.array_equal(poly.durations, six(nat.durations))
                                       and np.array_equal(poly.coeffs, six(nat.coeffs))),
           "exit_without_arguments": bad}
    emit("gen_trajectory", **row)
    check(row["segments"] == len(wp) - 1 and bad == 2, f"gen_trajectory: {row}")
    check(row["equal_at_6_decimals"], f"gen_trajectory: CSV against the native library {row}")
    return row


@contextlib.contextmanager
def recorded_kernel_calls():
    """Record the per-scenario step's calls of kernels A and J (the names
    ``ops/sqp.py`` calls) while the block runs: {"lin": [(args, out)],
    "ab": [...]}, every tensor cloned."""
    calls = {"lin": [], "ab": []}
    keep = lambda a: a.clone() if isinstance(a, torch.Tensor) else a
    lin, ab = sqp.linearize, sqp.condense_cost_from_AB

    def rec(key, fn):
        def call(*args):
            out = fn(*args)
            calls[key].append(([a.map(keep) if hasattr(a, "map") else keep(a) for a in args],
                               [keep(o) for o in out]))
            return out
        return call

    sqp.linearize, sqp.condense_cost_from_AB = rec("lin", lin), rec("ab", ab)
    try:
        yield calls
    finally:
        sqp.linearize, sqp.condense_cost_from_AB = lin, ab


def node_kernel_errors(node, calls) -> dict:
    """Kernels A and J on one node tick's own inputs against their f32 and
    f64 plain versions (kernel A as the tick got it; kernel J recomputed on
    the tick's A and B by ``condense_stats``)."""
    f64 = make_mpc_dynamics(node.solver.f.params.map(lambda a: a.double()))
    err = lambda a, b: (a.double() - b.double()).abs().max().item()
    d64 = lambda a: None if a is None else a.map(lambda t: t.double())
    rows = {}
    for (X, U, aug, f, dt, *_), (xp, J) in calls["lin"]:
        xp_p, J_p = lin_kernel.linearize_plain(f, X, U, aug, dt)
        xp_d, J_d = lin_kernel.linearize_plain(f64, X.double(), U.double(), d64(aug), dt)
        for k, v in {"xp_vs_plain": err(xp, xp_p), "J_vs_plain": err(J, J_p),
                     "xp_vs_f64": err(xp, xp_d), "J_vs_f64": err(J, J_d),
                     "xp_plain_vs_f64": err(xp_p, xp_d), "J_plain_vs_f64": err(J_p, J_d)}.items():
            rows[f"kernel_a_{k}"] = max(rows.get(f"kernel_a_{k}", 0.0), v)
    for args, _ in calls["ab"]:
        _, st = condense_stats(condense_kernel.condense_cost_from_AB,
                               condense_kernel.condense_cost_from_AB_plain, args[:5], args[5:],
                               poison_first)
        check_condense("kernel J at the node's tick", st)
        for k, v in st.items():
            if k.endswith("_rel") or k == "max_abs_err":
                rows[f"kernel_j_{k}"] = max(rows.get(f"kernel_j_{k}", 0.0), v)
    rows.update(lin_calls=len(calls["lin"]), ab_calls=len(calls["ab"]),
                B=int(calls["lin"][0][0][0].shape[0]), N=int(calls["lin"][0][0][0].shape[1]) - 1,
                basis_per_axis=None if calls["lin"][0][0][2] is None
                else int(node.rgp_state.X.shape[-1]))
    return rows


def phase_node_kernels(device) -> None:
    """Kernels A and J at the node's own shapes and inputs, against their f32
    and f64 plain versions: one tick of the gp2 node at the ROS shapes
    (B=1, N=5, 20 basis vectors a axis, NODE_KERNEL_TICKS into the bootstrap
    line), and one of hello_world's takeoff (the crazyflie, no GP, N=10,
    NODE_KERNEL_TICKS in).  Kernel A by its rules (LIN_XP_TOL, LIN_J_TOL
    against the f32 plain version; against f64 the same, or this data's
    f32 floor where that is higher, as at the fitted GP); kernel J by
    COND_REL_TOL."""
    p = crazyflie_params()
    x0 = np.zeros(13)
    x0[3] = 1.0
    lift = hello.line_node(p, x0, x0[:3], np.array([0.0, 0.0, 1.0]), device)
    gp2, loop, _ = node_flight(device, torch.float32, NODE_KERNEL_TICKS)
    lift_loop = ros.SimLoop(lift, p, x0)
    lift_loop.run(max_ticks=NODE_KERNEL_TICKS)
    for name, node, x in (("node", gp2, loop.x), ("hello_world", lift, lift_loop.x)):
        with recorded_kernel_calls() as calls:
            node.pose_received_cb(x)
        check(len(calls["lin"]) == len(calls["ab"]) == node.cfg.sqp_iters,
              f"{name}: the tick made {len(calls['lin'])} kernel A and {len(calls['ab'])} "
              f"kernel J calls")
        row = node_kernel_errors(node, calls)
        tol_xp = max(LIN_XP_TOL, 2 * row["kernel_a_xp_plain_vs_f64"])
        tol_J = max(LIN_J_TOL, 2 * row["kernel_a_J_plain_vs_f64"])
        emit(f"node_kernels_{name}", **row, tol_xp=tol_xp, tol_J=tol_J,
             tol_xp_vs_plain=LIN_XP_TOL, tol_J_vs_plain=LIN_J_TOL, tol_rel=COND_REL_TOL)
        check(row["kernel_a_xp_vs_plain"] <= LIN_XP_TOL and row["kernel_a_xp_vs_f64"] <= tol_xp,
              f"kernel A xp at the {name} tick: {row}")
        check(row["kernel_a_J_vs_plain"] <= LIN_J_TOL and row["kernel_a_J_vs_f64"] <= tol_J,
              f"kernel A J at the {name} tick: {row}")


def sass_ffma_counts() -> dict:
    """FFMA instructions in each instantiation of kernel G's SASS
    (``cuobjdump -sass`` of the built library), or {} without cuobjdump."""
    tool = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(_build.build())], capture_output=True,
                          text=True, timeout=300).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if "mpcq_fma_kernel" in name:
            counts[kernel_key(name)] = len(re.findall(r"\bFFMA\b", block))
    return counts


def rel_err(a, b) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def phase_kernel_g(device) -> dict:
    """Kernel G in both homes against its f32 and f64 plain versions at the
    JAX shapes (the peak path's) and at a small shape whose 61 steps run the
    remainder trip; its SASS.  Its time comes from the peak path."""
    small = phases.fma_input(8, 4, device, seed=2)
    cases = [("registers", small, 16, 61, True), ("smem", small, 8, 61, False)]
    for (sublanes, chains, steps, grid), home, resident in (
            (phases.REGISTER_SHAPE, "registers", True), (phases.STREAMING_SHAPE, "smem", False)):
        cases.append((home, phases.fma_input(sublanes, grid, device), chains, steps, resident))
    err, jax_abs = {}, []
    for home, x, chains, steps, resident in cases:
        out = phases.fma_chains(x, chains, steps, resident)
        ref = phases.fma_chains_plain(x, chains, steps)
        tag = f"{home}_n{x.numel()}_c{chains}_s{steps}"
        row = {"vs_plain_rel": rel_err(out, ref),
               "vs_f64_rel": rel_err(out, phases.fma_chains_plain(x.double(), chains, steps)),
               "max_abs_vs_plain": (out - ref).abs().max().item(),
               "tol_rel": fma_rel_tol(chains, steps)}
        err[tag] = row
        if x is not small:
            jax_abs.append(row["max_abs_vs_plain"])
        check(row["vs_plain_rel"] < row["tol_rel"] and row["vs_f64_rel"] < row["tol_rel"],
              f"kernel G {tag}: {row}")
        del out, ref
    ffma = sass_ffma_counts()
    sublanes, chains, steps, grid = phases.REGISTER_SHAPE
    xr = phases.fma_input(sublanes, grid, device)
    plain_ms = timed_ms(lambda: phases.fma_chains_plain(xr, chains, steps), reps=1)
    work = bounds.fma_work(xr.numel(), chains, steps)
    emit("kernel_g", **err, sass_ffma=ffma, plain_ms=plain_ms, **work)
    expect = {f"fma<{c},{r}>": 5 * c for c in phases.FMA_CHAINS for r in (0, 1)}
    check(not ffma or ffma == expect, f"kernel G: FFMA count {ffma}, expected {expect}")
    return {"max_abs_err": max(jax_abs), "plain_ms": plain_ms, **work}


def phase_peak(device) -> dict:
    peak = phases.vpu_peak(device)
    emit("peak", **peak, ceiling_flops_per_s=FMA_RATE_CEILING)
    reg, smem = peak["register_resident_f32_flops_per_s"], peak["smem_streaming_f32_flops_per_s"]
    check(0 < reg <= FMA_RATE_CEILING, f"peak: register-resident rate {reg} past {FMA_RATE_CEILING}")
    check(0 < smem < 0.9 * reg, f"peak: the shared-memory rate {smem} is not below the "
          f"register rate {reg}: the accumulators did not stream")
    return peak


def phase_kernels_hi(device) -> dict:
    """Kernels H and I at the probe's shape against their f32 and f64 plain
    versions, with NaN isolation.  Their times come from the transpose
    path."""
    B, nz, reps = BENCH_B, PROBE_NZ, PROBE_REPS[0]
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((B, nz, nz), generator=gen, device=device)
    res = {}
    for name, wrapper, plain in (("mirror_probe", probe_hybrid.mirror_probe,
                                  probe_hybrid.mirror_probe_plain),
                                 ("elem_probe", probe_hybrid.elem_probe,
                                  probe_hybrid.elem_probe_plain)):
        out = wrapper(x, reps)
        ref = plain(x, reps)
        err = {"vs_plain_rel": rel_err(out, ref), "vs_f64_rel": rel_err(out, plain(x.double(), reps)),
               "max_abs_err": (out - ref).abs().max().item()}
        bad = 7
        x_bad = x.clone()
        x_bad[bad, 9, 2] = float("nan")
        nan_isolated = isolated(bad, (out,), (wrapper(x_bad, reps),))
        plain_ms = timed_ms(lambda: plain(x, reps), reps=5)
        work = bounds.transpose_work(B, nz, reps)
        emit(name, B=B, nz=nz, reps=reps, **err, nan_isolated=nan_isolated, plain_ms=plain_ms,
             **work, tol_rel=PROBE_REL_TOL)
        check(err["vs_plain_rel"] < PROBE_REL_TOL and err["vs_f64_rel"] < PROBE_REL_TOL,
              f"{name}: {err}")
        check(nan_isolated, f"{name}: a NaN scenario changed another scenario's outputs")
        res[name] = {"max_abs_err": err["max_abs_err"], "plain_ms": plain_ms, **work}
    return res


def finite(d) -> bool:
    """Every float in a (nested) result is finite."""
    if isinstance(d, dict):
        return all(finite(v) for v in d.values())
    if isinstance(d, (list, tuple)):
        return all(finite(v) for v in d)
    return not isinstance(d, float) or math.isfinite(d)


def phase_transpose(device) -> dict:
    """The probe at each of PROBE_REPS; the result at the first."""
    res = {}
    for reps in PROBE_REPS:
        probe = probe_hybrid.transpose_probe(nz=PROBE_NZ, B=BENCH_B, reps=reps, device=device)
        emit("transpose_probe", **probe)
        check(finite(probe) and all(probe[k] is not None and probe[k] > 0 for k in (
            "mirror_s", "elem_s", "mirror_device_ms", "elem_device_ms")),
              f"transpose probe: {probe}")
        res = res or probe
    return res


def phase_table(device, peak) -> None:
    table = phases.phase_table(BENCH_B, device, peak=peak)
    emit("phase_table", **table)
    split = table["fused_split"]
    check(finite(table) and split["ipm_per_iteration_s"] > 0 and split["non_ipm_intercept_s"] > 0,
          f"phase table: {table}")


def phase_breakdown(device) -> None:
    brk = probe_hybrid.hybrid_breakdown(BENCH_B, device)
    jf = probe_hybrid.jfed_standalone(BENCH_B, device=device)
    emit("hybrid_breakdown", **brk, jfed=jf)
    check(finite(brk) and finite(jf) and jf["ipm_slope_s"] > 0, f"breakdown: {brk}, {jf}")


def phase_throughput(device) -> None:
    rows = suite.throughput((1024, 4096, 16384, SOLVE_B), device=device)
    emit("throughput", rows=rows)
    check(finite(rows) and all(r["solves_per_s"] > 0 for r in rows), f"throughput: {rows}")


def phase_riccati_profile(device, peak) -> None:
    prof = probe_hybrid.riccati_profile(device=device, peak=peak)
    emit("riccati_profile", **prof, cut="none: N = 10, 20, 40, B=1024, iterations 2, 6, 12")
    # kernel C alone: every iteration runs a backward sweep, so time grows
    # with the iteration count at every horizon
    check(finite(prof) and all(prof[str(N)]["sweep_slope_s"] > 0 for N in (10, 20, 40)),
          f"riccati profile: {prof}")


def phase_riccati_breakdown(device) -> None:
    brk = probe_hybrid.riccati_breakdown(SOLVE_B, N_LONG, device=device)
    emit("riccati_breakdown", **brk)
    check(finite(brk) and all(brk[k] > 0 for k in ("lin_kernel_s", "riccati_kernel_s",
                                                    "riccati_finish_s", "step_s")),
          f"riccati breakdown: {brk}")


def phase_headline(device, peak) -> None:
    line = headline.measure(skip_closed=True, device=device, peak=peak)
    emit("headline", **line)
    check(finite(line) and line["value"] > 0 and line["latency_p50_ms"] > 0,
          f"headline: {line}")


def _fenced(name):
    def fence(*args, **kwargs):
        raise RuntimeError(f"{name}: the plain version ran on the CUDA path")
    return fence


# kernels A-J: (wrapper with its launch counter, route, source, the TPU kernel
# it replaces)
KERNELS = {
    "lin_kernel": (lin_kernel.linearize, "mpc_quad_ros_tpu_torch/csrc/lin_kernel.cu",
                   "mpc_quad_ros_tpu/ops/pallas/lin_kernel.py:140"),
    "sqp_fused_kernel": (sqp_fused_kernel.fused_sqp_from_J,
                         "mpc_quad_ros_tpu_torch/csrc/sqp_fused_kernel.cu",
                         "mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py:291"),
    "riccati_ipm": (riccati_kernel.riccati_ipm_from_J, "mpc_quad_ros_tpu_torch/csrc/riccati_ipm.cu",
                    "mpc_quad_ros_tpu/ops/pallas/riccati_kernel.py:54"),
    "condense_kernel": (condense_kernel.condense_cost_from_J,
                        "mpc_quad_ros_tpu_torch/csrc/condense_kernel.cu",
                        "mpc_quad_ros_tpu/ops/pallas/condense_kernel.py:108"),
    "qp_kernel": (qp_kernel.solve_box_qp_pdip_batch, "mpc_quad_ros_tpu_torch/csrc/qp_kernel.cu",
                  "mpc_quad_ros_tpu/ops/pallas/qp_kernel.py:216"),
    "sqp_step_kernel": (sqp_fused_kernel.fused_sqp_step,
                        "mpc_quad_ros_tpu_torch/csrc/sqp_fused_kernel.cu",
                        "mpc_quad_ros_tpu/ops/pallas/sqp_fused_kernel.py:57"),
    "condense_ab_kernel": (condense_kernel.condense_cost_from_AB,
                           "mpc_quad_ros_tpu_torch/csrc/condense_kernel.cu",
                           "mpc_quad_ros_tpu/ops/pallas/condense_kernel.py:37"),
    "fma_peak": (phases.fma_chains, "mpc_quad_ros_tpu_torch/csrc/fma_peak.cu",
                 "mpc_quad_ros_tpu/bench/phases.py:88"),
    "mirror_probe": (probe_hybrid.mirror_probe, "mpc_quad_ros_tpu_torch/csrc/transpose_probe.cu",
                     "mpc_quad_ros_tpu/bench/probe_hybrid.py:162"),
    "elem_probe": (probe_hybrid.elem_probe, "mpc_quad_ros_tpu_torch/csrc/transpose_probe.cu",
                   "mpc_quad_ros_tpu/bench/probe_hybrid.py:173"),
}
PLAINS = ((lin_kernel, "linearize_plain"), (sqp_fused_kernel, "fused_sqp_from_J_plain"),
          (riccati_kernel, "solve_ocp_box_riccati_ipm_plain"),
          (condense_kernel, "condense_cost_from_J_plain"), (qp_kernel, "ipm_box_solve"),
          (sqp_fused_kernel, "fused_sqp_step_plain"),
          (condense_kernel, "condense_cost_from_AB_plain"), (phases, "fma_chains_plain"),
          (probe_hybrid, "mirror_probe_plain"), (probe_hybrid, "elem_probe_plain"))


def drive(*phases) -> dict:
    """Run the phases with every launch count at 0 first; the counts after,
    by kernel name."""
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    for phase in phases:
        phase()
    torch.cuda.synchronize()
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def launched(counts: dict) -> set:
    return {name for name, n in counts.items() if n > 0}


def main() -> None:
    phase_environment()
    device = torch.device("cuda", 0)
    phase_residency(phase_build())
    res = {"lin_kernel": phase_kernel_a(device), "sqp_fused_kernel": phase_kernel_b(device),
           "riccati_ipm": phase_kernel_c(device), "condense_kernel": phase_kernel_d(device),
           "qp_kernel": phase_kernel_e(device), "sqp_step_kernel": phase_kernel_f(device),
           "condense_ab_kernel": phase_kernel_j(device), "fma_peak": phase_kernel_g(device),
           **phase_kernels_hi(device)}
    torch.cuda.empty_cache()
    phase_kernel_b_warm(device)
    phase_kernel_e(device, warm_start=True)
    phase_kernel_b_long(device)
    phase_kernel_d_long(device)
    torch.cuda.empty_cache()
    phase_slice_vs_cpu(device)
    phase_riccati_vs_cpu(device)
    phase_pipelines_agree(device)
    torch.cuda.empty_cache()
    phase_solve_vs_cpu(device)
    phase_solve_batch_shapes(device)
    phase_per_scenario_auto_range(device)
    phase_node_kernels(device)
    episode_ref = phase_episode_cpu_f64()
    node_ref = phase_node_cpu_f64()
    entry_ref = phase_entry_cpu_f64()
    mp_ref = phase_multiprocess_ref()
    torch.cuda.empty_cache()
    # the gp1 workflow's training path (its offline RGP's CPU reference and
    # the solve check's f64 plain versions need the plain versions unfenced)
    gp1 = {}
    paths = {"gp1_training": drive(lambda: gp1.update(phase_gp1_training(device)))}
    phase_gp1_solve(device, gp1["gp"])
    torch.cuda.empty_cache()

    # the main paths: counts from 0 before each, plain versions fenced off
    saved = [getattr(mod, name) for mod, name in PLAINS]
    for mod, name in PLAINS:
        setattr(mod, name, _fenced(mod.__name__))
    closed = {}
    try:
        paths |= {
            "hybrid": drive(lambda: phase_slice(device),
                            lambda: closed.update(phase_closed_loop(device))),
            "split": drive(lambda: phase_pipeline_slice(device, "split")),
            "fused": drive(lambda: phase_pipeline_slice(device, "fused")),
            "warm_chain": drive(lambda: phase_warm_chain(device)),
            "riccati": drive(lambda: phase_riccati_slice(device)),
            "episode": drive(lambda: phase_episode(device, episode_ref)),
            "episode_batch": drive(lambda: phase_episode_batch(device)),
            "hetero": drive(lambda: phase_hetero(device)),
            "gp1_fused": drive(lambda: phase_gp1_flight(device, gp1["gp"], gp1["gp0"], closed)),
        }
        # the fused loop's run of the per-scenario path's episodes, its reference
        fused = closed_loop(B=GP1_EPISODE_B, v=8.0, t_max=GP1_EPISODE_T, device=device,
                            drag=gp1["gp"], err_from=GP1_ERR_FROM)
        paths["gp1_episode_batch"] = drive(lambda: phase_gp1_episode_batch(device, gp1["gp"], fused))
        phase_paper_metric(gp1["cov_gp0"], closed["cov"])
        torch.cuda.empty_cache()
        # the simulation entry point, its trajectories, the comparison matrix and
        # the solver's phase profile
        paths["cli"] = drive(lambda: phase_cli(device))
        torch.cuda.empty_cache()
        paths["minsnap"] = drive(lambda: phase_minsnap(device))
        paths["matrix"] = drive(lambda: phase_matrix(device))
        paths["profile"] = drive(lambda: phase_profile(device))
        torch.cuda.empty_cache()
        # the ROS node, its cmdPosition cascade, its sockets and hello_world
        paths["node"] = drive(lambda: phase_node(device, node_ref))
        paths["node_position"] = drive(lambda: phase_node_position(device))
        paths["node_sockets"] = drive(lambda: phase_node_sockets(device))
        paths["hello_world"] = drive(lambda: phase_hello_world(device))
        torch.cuda.empty_cache()
        # the entry point, the multi-process farm (its ranks launch the
        # kernels and report their counts), the parity harness on the episode
        # path's log and the gen_trajectory CLI
        paths["entry"] = drive(lambda: phase_entry(device, entry_ref))
        mp = {}
        paths["multiprocess"] = drive(lambda: mp.update(phase_multiprocess(device)))
        for name, n in worker_launches(mp["results"]).items():
            paths["multiprocess"][name] += n
        phase_multiprocess_check(device, mp, mp_ref)
        torch.cuda.empty_cache()
        replay = {}
        paths["parity_replay"] = drive(lambda: replay.update(phase_parity_replay(device)))
        paths["gen_trajectory"] = drive(phase_gen_trajectory)
        phase_crossover(device)
        torch.cuda.empty_cache()
        peak, probe = {}, {}
        paths["peak"] = drive(lambda: peak.update(phase_peak(device)))
        paths["transpose"] = drive(lambda: probe.update(phase_transpose(device)))
        paths["phases"] = drive(lambda: phase_table(device, peak))
        paths["breakdown"] = drive(lambda: phase_breakdown(device))
        paths["throughput"] = drive(lambda: phase_throughput(device))
        paths["riccati_profile"] = drive(lambda: phase_riccati_profile(device, peak),
                                         lambda: phase_riccati_breakdown(device))
        paths["headline"] = drive(lambda: phase_headline(device, peak))
    finally:
        for (mod, name), fn in zip(PLAINS, saved):
            setattr(mod, name, fn)
    phase_parity_check(replay)
    # the kernels' times on the paths that measure them
    res["fma_peak"]["ms"] = peak["register_resident_ms_per_launch"]
    res["mirror_probe"]["ms"] = probe["mirror_device_ms"]
    res["elem_probe"]["ms"] = probe["elem_device_ms"]
    small_step = {"lin_kernel", "condense_ab_kernel", "qp_kernel"}
    expect = {"hybrid": {"lin_kernel", "sqp_fused_kernel"} | small_step,
              "split": {"lin_kernel", "condense_kernel", "qp_kernel"},
              "fused": {"sqp_step_kernel"},
              "warm_chain": {"lin_kernel", "sqp_fused_kernel", "condense_kernel", "qp_kernel",
                             "sqp_step_kernel"},
              "riccati": {"lin_kernel", "riccati_ipm"},
              "episode": {"lin_kernel", "condense_ab_kernel"},
              "episode_batch": {"lin_kernel", "condense_kernel"},
              "hetero": {"lin_kernel", "sqp_fused_kernel"},
              "gp1_training": {"lin_kernel", "sqp_fused_kernel"},
              "gp1_fused": {"lin_kernel", "sqp_fused_kernel"},
              "gp1_episode_batch": {"lin_kernel", "condense_kernel"},
              "cli": {"lin_kernel", "sqp_fused_kernel"},
              "minsnap": {"lin_kernel", "sqp_fused_kernel"},
              "matrix": small_step,
              "profile": {"lin_kernel", "condense_kernel", "qp_kernel", "sqp_fused_kernel"},
              "node": {"lin_kernel", "condense_ab_kernel"},
              "node_position": {"lin_kernel", "condense_ab_kernel"},
              "node_sockets": {"lin_kernel", "condense_ab_kernel"},
              "hello_world": {"lin_kernel", "condense_ab_kernel"},
              "entry": {"lin_kernel", "condense_ab_kernel"},
              "multiprocess": {"lin_kernel", "sqp_fused_kernel", "condense_kernel"},
              "parity_replay": {"lin_kernel", "condense_ab_kernel"},
              "gen_trajectory": set(),
              "peak": {"fma_peak"},
              "transpose": {"mirror_probe", "elem_probe"},
              "phases": {"sqp_step_kernel", "lin_kernel", "condense_kernel", "qp_kernel"},
              "breakdown": {"lin_kernel", "sqp_fused_kernel"},
              "throughput": {"lin_kernel", "sqp_fused_kernel"},
              "riccati_profile": {"lin_kernel", "riccati_ipm"},
              "headline": {"lin_kernel", "sqp_fused_kernel"} | small_step}
    for path, counts in paths.items():
        check(launched(counts) == expect[path],
              f"the {path} path launched {counts}, expected exactly {sorted(expect[path])}")
    emit("launches", **paths)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(counts[name] for counts in paths.values()),
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": None}
        for name, (_, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
