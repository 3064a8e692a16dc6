"""Parameters carried across from the JAX package.

The JAX package's records are NamedTuples; handed over as numpy arrays
(``{k: np.asarray(v) for k, v in state._asdict().items()}``) they become the
port's records with the same field names, so the same inputs give the same
numbers in both packages.  Works with or without a leading batch axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.params import QuadParams
from .models.rgp import RGPState


def _from_numpy(cls, arrays: dict, device=None, dtype=None):
    names = [f for f in cls.__dataclass_fields__]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {sorted(missing)}")
    return cls(**{k: torch.as_tensor(np.array(arrays[k]), device=device,
                                     dtype=dtype) for k in names})


def quad_params_from_numpy(arrays: dict, device=None, dtype=None) -> QuadParams:
    return _from_numpy(QuadParams, arrays, device, dtype)


def rgp_state_from_numpy(arrays: dict, device=None, dtype=None) -> RGPState:
    return _from_numpy(RGPState, arrays, device, dtype)


def to_numpy(record) -> dict:
    """The inverse: a port record as {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in record.fields().items()}
