"""Frozen dataclasses of tensors — the port's stand-in for the JAX package's
NamedTuple pytrees (parameters, GP state, solver carry)."""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Tensors:
    """Base for a record whose fields are tensors (or None)."""

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable):
        """Apply `fn` to every non-None field, e.g. ``.map(lambda a: a[idx])``."""
        return type(self)(**{k: (None if v is None else fn(v))
                             for k, v in self.fields().items()})
