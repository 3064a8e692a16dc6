"""Data-parallel mesh of the scenario batch in one process.

Counterpart of ``mpc_quad_ros_tpu/parallel/mesh.py``.  One axis ("dp") over
scenarios: each shard is a contiguous block of the batch on its own device,
the step runs shard by shard (launches on different cards overlap, since
they are asynchronous), and the per-shard metric sums are added up; when a
process group is initialised they are also all-reduced over its ranks
(``psum_metrics``), which is what ``parallel/distributed.py`` builds on.

Only data parallelism: a scenario's problem is tiny (nz = 40 condensed
variables), so every kernel works one scenario at a time and no kernel
reduces across scenarios.  A shard's outputs are therefore the unsharded
step's rows, bit for bit, wherever the step's batched glue picks the same
algorithm at the shard's batch size.

``make_mesh(n, device="cuda")`` takes ``cuda:0 .. n-1`` and raises when fewer
cards exist; ``make_mesh(n, device="cpu")`` gives n shards on the CPU, the
counterpart of the JAX package's virtual CPU devices, asked for explicitly.
There is no silent fall-back from the card to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..utils.containers import Tensors


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple          # one torch.device a shard (a device may hold several)
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """A batch tree cut into the mesh's shards, each on its shard's device.
    `rows` is the global batch: the shards' rows over every rank."""

    shards: tuple
    rows: int


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of a tree (tensors or numpy arrays, in
    ``Tensors`` records, tuples, lists, dicts; None stays None), zipped with
    trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *rest)
    if isinstance(tree, Tensors):
        return type(tree)(**{k: tree_map(fn, v, *(getattr(r, k) for r in rest))
                             for k, v in tree.fields().items()})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    raise TypeError(f"unsupported leaf in a batch tree: {type(tree)}")


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda a: out.append(a) or a, tree)
    return out


def make_mesh(n_devices: int | None = None, device="cuda", axis: str = "dp") -> Mesh:
    """n shards: on ``cuda:0 .. n-1`` (every card when n is None), raising
    when fewer cards exist, or on the CPU with ``device="cpu"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (1 if n_devices is None else n_devices), axis)
    if kind != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise RuntimeError(f"make_mesh: need {n} CUDA devices, have {have} "
                           "(pass device='cpu' for CPU shards)")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def shard_episode_batch(mesh: Mesh, tree, rows: int | None = None) -> ShardedBatch:
    """Cut a tree whose leaves share a leading batch dim into the mesh's
    contiguous shards, each moved to its shard's device.  A batch the mesh
    does not divide raises: pad it to a multiple first."""
    leaves = tree_leaves(tree)
    B = leaves[0].shape[0]
    if any(a.shape[0] != B for a in leaves):
        raise ValueError(f"the leaves' leading dims differ: {sorted({a.shape[0] for a in leaves})}")
    if B % mesh.size:
        raise ValueError(f"a batch of {B} scenarios does not divide into {mesh.size} shards; "
                         "pad it to a multiple of the mesh size")
    per = B // mesh.size
    shards = tuple(tree_map(lambda a, i=i, dev=dev: a[i * per:(i + 1) * per].to(dev), tree)
                   for i, dev in enumerate(mesh.devices))
    return ShardedBatch(shards, B if rows is None else rows)


def psum_metrics(metrics: dict) -> dict:
    """Each metric summed over the ranks of the process group (one
    ``all_reduce`` a metric, in the dict's order); unchanged without one.
    Under gloo a metric on a card goes through the host for the reduction
    (a scalar each way) and comes back to its card."""
    if not (dist.is_available() and dist.is_initialized()):
        return metrics
    via_host = dist.get_backend() == "gloo"
    out = {}
    for k, v in metrics.items():
        r = v.cpu() if via_host and v.is_cuda else v.clone()
        dist.all_reduce(r, op=dist.ReduceOp.SUM)
        out[k] = r.to(v.device)
    return out


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def sharded_step_fn(mesh: Mesh, step_fn: Callable) -> Callable:
    """Wrap a batched `step_fn(batch) -> (per_scenario_outputs, metrics)`,
    whose metrics are per-shard sums (counts, error sums), into a step over
    the mesh: each shard's step on its device, the outputs concatenated
    along the batch on the first shard's device, the metrics summed over
    the shards in shard order and then over the ranks (``psum_metrics``).
    It takes a ``ShardedBatch`` or a whole batch tree, which it shards."""

    def stepped(batch):
        if not isinstance(batch, ShardedBatch):
            batch = shard_episode_batch(mesh, batch)
        outs, mets = [], []
        for dev, shard in zip(mesh.devices, batch.shards):
            with _on(dev):
                o, m = step_fn(shard)
            outs.append(o)
            mets.append(m)
        home = mesh.devices[0]
        if len(outs) == 1:
            out = outs[0]
        else:
            out = tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]), *outs)
        metrics = {}
        for k in mets[0]:
            total = mets[0][k].to(home)
            for m in mets[1:]:
                total = total + m[k].to(home)
            metrics[k] = total
        return out, psum_metrics(metrics)

    return stepped
