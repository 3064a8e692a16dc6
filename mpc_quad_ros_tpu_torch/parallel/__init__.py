"""The scenario batch over several devices (``mesh``) and several processes
(``distributed``, ``mp_worker``, ``launch``), on ``torch.distributed``.
Counterpart of ``mpc_quad_ros_tpu/parallel``."""

from .distributed import global_mesh, initialize, local_shard, make_global_batch, process_slice
from .mesh import make_mesh, psum_metrics, shard_episode_batch, sharded_step_fn

__all__ = ["make_mesh", "shard_episode_batch", "sharded_step_fn", "psum_metrics",
           "global_mesh", "initialize", "local_shard", "make_global_batch",
           "process_slice"]
