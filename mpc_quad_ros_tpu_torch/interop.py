"""Parameters, GP states and solver carries carried across from the JAX package.

The JAX package's records are NamedTuples; handed over as numpy arrays
(``{k: np.asarray(v) for k, v in state._asdict().items()}``, a nested record
as a nested dict) they become the port's records with the same field names,
so the same inputs give the same numbers in both packages.  Works with or
without leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gp import GPState
from .models.params import QuadParams
from .models.rgp import RGPLearnState, RGPState
from .ops.sqp import SolverCarry


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


def gp_state_from_numpy(arrays: dict, device=None, dtype=None) -> GPState:
    return _from_numpy(GPState, arrays, device, dtype)


def rgp_learn_state_from_numpy(arrays: dict, device=None, dtype=None) -> RGPLearnState:
    """The learner's state, its RGP under "base" as a dict of arrays."""
    ten = lambda k: torch.as_tensor(np.array(arrays[k]), device=device, dtype=dtype)
    return RGPLearnState(base=rgp_state_from_numpy(arrays["base"], device, dtype),
                         mu_eta=ten("mu_eta"), C_eta=ten("C_eta"), C_g_eta=ten("C_g_eta"))


def solver_carry_from_numpy(arrays: dict, device=None, dtype=None) -> SolverCarry:
    """X and U, and the IPM duals zl, zu where given (absent or None: no
    duals, as a carry made without `warm_start_duals`)."""
    def tensor(v):
        return None if v is None else torch.as_tensor(np.array(v), device=device, dtype=dtype)

    return SolverCarry(X=tensor(arrays["X"]), U=tensor(arrays["U"]),
                       zl=tensor(arrays.get("zl")), zu=tensor(arrays.get("zu")))


def to_numpy(record) -> dict:
    """The inverse: a port record as {field: numpy array}, a nested record
    as a nested dict."""
    return {k: (None if v is None else to_numpy(v) if not isinstance(v, torch.Tensor)
                else v.detach().cpu().numpy()) for k, v in record.fields().items()}
