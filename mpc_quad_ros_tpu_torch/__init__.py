"""mpc_quad_ros_tpu_torch — the PyTorch + CUDA port of ``mpc_quad_ros_tpu``.

The JAX package beside this one stays the reference; this package mirrors its
layout so every module has a counterpart there:

- ``utils``    : quaternion algebra (every function of the JAX package's),
                 the trajectory metrics, the tensor containers, the
                 reference chunk gather
- ``models``   : quadrotor parameters (the four presets, xacro files) and
                 dynamics, the learned drag (the recursive GP and its
                 hyperparameter learner, the exact GP and its fit,
                 ``GPEnsemble`` and its model files, the training data and
                 the offline trainers), the drag-augmented MPC model
- ``ops``      : the SQP-RTI solve, batched (``SQPSolver.solve_batch``) and
                 per scenario (``SQPSolver.solve``), the box-QP solvers;
                 ``ops.cuda`` holds the hand-written Hopper kernels (sources
                 in ``csrc/``) beside their plain PyTorch versions
- ``traj``     : the reference trajectories: the circles and the square,
                 random and line waypoints, the piecewise polynomial and its
                 flat outputs, min-snap (numpy, and a C++ build of it bound
                 with ctypes), the CSV files and the 13-state expansion, the
                 polynomial inspection CLI
- ``loop``     : the closed learning loops: ``run_episode`` (one episode, or a
                 batch as ``run_episode_batch``) and the batch-major
                 ``run_episode_batch_fused``
- ``io``       : episode logs (the reference's keys), checkpoints,
                 ``SimConfig``, ``Visualiser`` (the paper's learning
                 metric, the report, the RGP figures and animations) and
                 ``LiveFlightView``, the profiling timers, the TCP transport
- ``run``      : the simulation entry point (the reference's
                 ``execute_trajectory.py``): ``build_trajectory``,
                 ``run_sim``, ``main``
- ``node``     : the ROS-shaped controller node, its trajectory server, the
                 cmdPosition cascade and ``SimLoop``; ``hello_world`` flies
                 it through a takeoff and a landing
- ``scripts``, ``scripts_viz_parity``: the run and figure scripts, the
                 figure check against the reference's Visualiser
- ``compare``  : the comparison matrix, one run at a time or one fused batch
                 a drag mode
- ``explore``, ``explorer``: the exploration curriculum
- ``bench``    : the measurement harness and the benchmark's scenarios
- ``interop``  : parameters and GP states from the JAX package (as numpy)
                 into this one

Importing the package never imports ``jax``, builds no kernel and touches no
GPU: the CUDA library is compiled at the first launch on a CUDA tensor (the
min-snap library at its first use).  The entry points run on the card
unless given ``device="cpu"`` (``--cpu``).
"""

__version__ = "0.1.0"
