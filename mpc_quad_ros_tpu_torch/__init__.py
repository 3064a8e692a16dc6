"""mpc_quad_ros_tpu_torch — the PyTorch + CUDA port of ``mpc_quad_ros_tpu``.

The JAX package beside this one stays the reference; this package mirrors its
layout so every module has a counterpart there:

- ``utils``    : quaternion algebra, the tensor containers, the reference
                 chunk gather
- ``models``   : quadrotor parameters (the four presets, xacro files) and
                 dynamics, the learned drag (the recursive GP and its
                 hyperparameter learner, the exact GP and its fit,
                 ``GPEnsemble`` and its model files, the training data and
                 the offline trainers), the drag-augmented MPC model
- ``ops``      : the SQP-RTI solve, batched (``SQPSolver.solve_batch``) and
                 per scenario (``SQPSolver.solve``), the box-QP solvers;
                 ``ops.cuda`` holds the hand-written Hopper kernels (sources
                 in ``csrc/``) beside their plain PyTorch versions
- ``traj``     : the accelerating circle reference and its 13-state expansion
- ``loop``     : the closed learning loops: ``run_episode`` (one episode, or a
                 batch as ``run_episode_batch``) and the batch-major
                 ``run_episode_batch_fused``
- ``io``       : episode logs (the reference's keys) and checkpoints
- ``bench``    : the measurement harness and the benchmark's scenarios
- ``interop``  : parameters and GP states from the JAX package (as numpy)
                 into this one

Importing the package never imports ``jax``, builds no kernel and touches no
GPU: the CUDA library is compiled at the first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
