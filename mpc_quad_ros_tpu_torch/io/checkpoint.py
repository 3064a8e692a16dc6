"""Checkpoint and resume of the port's records.

Counterpart of ``mpc_quad_ros_tpu/io/checkpoint.py``.  The JAX package
pickles a JAX treedef, which cannot be read without JAX, so the port writes
its own format: each record as its class name and its fields, tensors as
numpy arrays, nested records the same way.  Any record of the port saves and
loads: the closed loop's ``EpisodeCarry`` (plant state, solver warm start,
the full RGP posterior with C_g, the previous prediction), ``RGPState``,
``RGPLearnState``, ``GPState``, ``QuadParams``.  ``run_episode(carry0=,
start_tick=)`` resumes from a loaded carry bitwise.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any

import numpy as np
import torch


def _record_classes() -> dict:
    from ..loop.episode import EpisodeCarry, EpisodeOutput
    from ..models.augmented import FoldedDrag
    from ..models.gp import GPState
    from ..models.params import QuadParams
    from ..models.rgp import RGPLearnState, RGPState
    from ..ops.sqp import MPCSolution, SolverCarry

    return {c.__name__: c for c in (EpisodeCarry, EpisodeOutput, FoldedDrag, GPState, QuadParams,
                                    RGPLearnState, RGPState, MPCSolution, SolverCarry)}


def _encode(obj):
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {"record": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    raise TypeError(f"cannot checkpoint a {type(obj)}")


def _decode(obj, classes: dict, dtype, device):
    if obj is None:
        return None
    if isinstance(obj, np.ndarray):
        cast = dtype if dtype is not None and np.issubdtype(obj.dtype, np.floating) else None
        return torch.as_tensor(obj, device=device, dtype=cast)
    fields = {k: _decode(v, classes, dtype, device) for k, v in obj["fields"].items()}
    return classes[obj["record"]](**fields)


def save_checkpoint(path: str, record: Any) -> str:
    """Write a record of the port (tensors on any device) to `path` (".ckpt"
    appended when missing); returns the path written."""
    if not path.endswith(".ckpt"):
        path = path + ".ckpt"
    with open(path, "wb") as f:
        pickle.dump({"format": "mpc_quad_ros_tpu_torch", "record": _encode(record)}, f)
    return path


def load_checkpoint(path: str, dtype=None, device=None) -> Any:
    """The record saved at `path`, its tensors on `device` (the CPU by
    default), floating ones cast to `dtype` when given."""
    if not path.endswith(".ckpt"):
        path = path + ".ckpt"
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not isinstance(payload, dict) or payload.get("format") != "mpc_quad_ros_tpu_torch":
        raise ValueError(f"{path} is not a checkpoint of mpc_quad_ros_tpu_torch (the JAX "
                         "package's checkpoints need JAX to read)")
    return _decode(payload["record"], _record_classes(), dtype, device)
