"""Frozen dataclasses of tensors — the port's stand-in for the JAX package's
NamedTuple pytrees (parameters, GP state, solver carry)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Tensors:
    """Base for a record whose fields are tensors, records of tensors (as
    ``RGPLearnState.base``) or None."""

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable):
        """Apply `fn` to every tensor, nested records included, e.g.
        ``.map(lambda a: a[idx])``."""
        return type(self)(**{k: (None if v is None else v.map(fn) if isinstance(v, Tensors)
                                 else fn(v)) for k, v in self.fields().items()})


def stack_records(records: list, dim: int = 0):
    """Records of one class stacked field by field along a new `dim` (the
    JAX package's ``jax.tree.map(lambda *ls: jnp.stack(ls), *records)``)."""
    first = records[0]
    out = {}
    for k, v in first.fields().items():
        parts = [getattr(r, k) for r in records]
        out[k] = (None if v is None else stack_records(parts, dim) if isinstance(v, Tensors)
                  else torch.stack(parts, dim))
    return type(first)(**out)
