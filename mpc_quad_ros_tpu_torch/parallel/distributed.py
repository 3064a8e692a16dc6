"""Multi-process distribution of the scenario batch over ``torch.distributed``.

Counterpart of ``mpc_quad_ros_tpu/parallel/distributed.py``.  Every process
(rank) runs the same program:

- ``initialize`` joins the process group.  The rendezvous is torch's own:
  ``init_method`` (``tcp://host:port``, ``file:///path``) or, without one,
  ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), so
  ``torchrun`` can start the worker too;
- the backend is NCCL when each rank of a host has a card of its own, gloo
  when the ranks outnumber the cards (NCCL refuses two ranks on one GPU).
  Under gloo, ranks that share a card still compute on it: only the
  metrics' all-reduce goes through the host.  Nothing moves the work to the
  CPU;
- each rank builds only its own contiguous slice of the global batch
  (``process_slice``, rank-major), on its own device (``rank_device``);
  ``make_global_batch`` keeps those rows there, the global batch being a
  row count, and ``global_mesh`` is this rank's mesh, whose metrics
  ``sharded_step_fn`` all-reduces over every rank.

Plain tensors and explicit collectives: the only cross-rank traffic is the
metric sums.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, ShardedBatch, shard_episode_batch, tree_leaves, tree_map

TIMEOUT_S = 600.0   # how long a collective waits for the other ranks


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def choose_backend(world_size: int, device="cuda") -> str:
    """"nccl" when the ranks on this host (``LOCAL_WORLD_SIZE``, else the
    whole world) each have a card of their own, else "gloo"."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if dist.is_nccl_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: the CPU, or card ``LOCAL_RANK`` (else the rank)
    modulo the host's cards, several ranks sharing a card when they
    outnumber them.  A rank asked for a card where none exists raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if rank is None:
        rank = _world()[0]
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda") -> str:
    """Join this process into the group; returns the backend
    (``choose_backend``).  World size and rank default to ``WORLD_SIZE`` and
    ``RANK``; the rendezvous to ``env://``."""
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    dev = rank_device(device, rank)
    backend = choose_backend(world_size, device)
    kw = {"device_id": dev} if backend == "nccl" else {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return backend


def global_mesh(device="cuda") -> Mesh:
    """This rank's one-shard mesh on its device; ``sharded_step_fn`` sums
    its metrics over every rank of the group."""
    return Mesh((rank_device(device),))


def process_slice(global_batch: int) -> slice:
    """The contiguous slice of a size-`global_batch` scenario axis that this
    rank owns (rank-major).  A batch the ranks do not divide raises."""
    rank, world = _world()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} processes")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def make_global_batch(mesh: Mesh, local_tree) -> ShardedBatch:
    """This rank's rows (tensors or numpy arrays with a leading batch dim) on
    the mesh's devices; the global batch, local rows times the ranks, is
    metadata.  No rows cross ranks."""
    tree = tree_map(torch.as_tensor, local_tree)
    return shard_episode_batch(mesh, tree, rows=tree_leaves(tree)[0].shape[0] * _world()[1])


def local_shard(arr: torch.Tensor) -> np.ndarray:
    """This rank's rows of a batch-sharded output, as numpy."""
    return arr.detach().cpu().numpy()
