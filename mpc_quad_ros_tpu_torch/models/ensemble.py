"""3-axis GP/RGP ensemble: the user-facing wrapper over the stacked states.

Counterpart of ``mpc_quad_ros_tpu/models/ensemble.py`` (``GPEnsemble``):
constructors (``fromrange``, ``fromemptybasisvectors``,
``frombasisvectors``, ``fromlist``, ``fromdir``), predict /
predict_using_y / regress over the 3 body axes, the per-axis fit, and the
model files ``mdl_{x,y,z}.gp|.rgp``.  The files hold numpy arrays under the
JAX package's keys (for an RGP also C_g and, with a learn state, mu_eta,
C_eta, C_g_eta), so a model saved by either package loads in the other.

The closed loops carry the stacked ``RGPState``/``GPState`` records
themselves (``.state``); this wrapper serves the offline workflow.  The
constructors that make tensors run on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..utils.containers import stack_records
from ..utils.device import resolve_device
from .gp import GPState, gp_fit, gp_init, gp_predict
from .rgp import (RGPLearnState, RGPState, rgp_init, rgp_predict, rgp_predict_using_y,
                  rgp_regress)

_AXES = ("x", "y", "z")


def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


class GPEnsemble:
    def __init__(self, state, type: str, learn: Optional[RGPLearnState] = None):
        if type not in ("GP", "RGP"):
            raise ValueError(f"type must be 'GP' or 'RGP', not {type!r}")
        self.state = state      # stacked (3, ...) GPState or RGPState
        self.type = type
        # the stacked (3, ...) learn-mode state (hyperparameter posterior),
        # saved and loaded beside the base state
        self.learn = learn

    # ----------------------- constructors -----------------------
    @classmethod
    def fromrange(cls, x_min_max, n_basis, theta=(1.0, 0.1, 0.1), dtype=torch.float32,
                  device="cuda") -> "GPEnsemble":
        """RGP ensemble with n_basis linspaced basis vectors over each axis's
        (min, max); n_basis an int or a 3-list of equal values."""
        if isinstance(n_basis, (list, tuple)):
            if len(set(n_basis)) != 1:
                raise ValueError("per-axis basis counts must match (stacked state)")
            n_basis = n_basis[0]
        dev = resolve_device(device)
        X = torch.stack([torch.linspace(lo, hi, n_basis, dtype=dtype, device=dev)
                         for lo, hi in x_min_max])
        return cls(rgp_init(X, theta=theta), "RGP")

    @classmethod
    def fromemptybasisvectors(cls, X, theta=(1.0, 0.1, 0.1), device="cuda") -> "GPEnsemble":
        """RGP ensemble from explicit basis vectors (3 of them, nb each), zero
        prior mean."""
        dev = resolve_device(device)
        X = torch.stack([torch.as_tensor(np.asarray(Xd)) for Xd in X]).to(dev)
        return cls(rgp_init(X, theta=theta), "RGP")

    @classmethod
    def frombasisvectors(cls, X, y, C, theta, device="cuda") -> "GPEnsemble":
        """RGP ensemble from per-axis basis vectors, prior means,
        covariances and hyperparameters."""
        dev = resolve_device(device)
        ten = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        states = [rgp_init(ten(X[d]), ten(y[d]), ten(C[d]), ten(theta[d])) for d in range(3)]
        return cls(stack_records(states), "RGP")

    @classmethod
    def fromlist(cls, states: list, type: Optional[str] = None) -> "GPEnsemble":
        """Three per-axis states (on their own device) stacked."""
        t = type or ("RGP" if isinstance(states[0], RGPState) else "GP")
        return cls(stack_records(states), t)

    @classmethod
    def fromdir(cls, path: str, type: str, device="cuda") -> "GPEnsemble":
        """Load `mdl_{x,y,z}.gp|.rgp` from `path`: files of either package,
        or the reference's joblib dumps.  An RGP file's C_g and learn state
        are restored where present.  Tensors keep the files' dtype."""
        dev = resolve_device(device)
        ten = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        ext = ".gp" if type == "GP" else ".rgp"
        states, learns = [], []
        for ax in _AXES:
            with open(os.path.join(path, f"mdl_{ax}{ext}"), "rb") as f:
                d = _robust_load(f)
            X, y = ten(d["X"]), ten(d["y"])
            theta = ten(np.asarray(d["theta"], dtype=np.float64).ravel()[:3]).to(X.dtype)
            if type == "GP":
                states.append(gp_init(X, y, theta))
                continue
            C = d.get("C_g")
            st = rgp_init(X, y, C=None if C is None else ten(C), theta=theta)
            states.append(st)
            if "mu_eta" in d:
                learns.append(RGPLearnState(
                    base=st, mu_eta=ten(d["mu_eta"]).to(X.dtype), C_eta=ten(d["C_eta"]).to(X.dtype),
                    C_g_eta=ten(d["C_g_eta"]).to(X.dtype)))
        learn = stack_records(learns) if len(learns) == 3 else None
        return cls(stack_records(states), type, learn=learn)

    # ----------------------- compute -----------------------
    def _queries(self, X_t) -> torch.Tensor:
        X_t = torch.as_tensor(X_t, dtype=self.state.X.dtype, device=self.state.X.device)
        return X_t.reshape(3, -1)

    def predict(self, X_t) -> torch.Tensor:
        """Per-axis posterior mean; X_t (3,) or (3, m) -> (3, m)."""
        fn = rgp_predict if self.type == "RGP" else gp_predict
        return fn(self.state, self._queries(X_t))

    def predict_using_y(self, X_t, y) -> torch.Tensor:
        """RGP mean with an external basis response y (3, nb)."""
        self._require("RGP", "predict_using_y")
        return rgp_predict_using_y(self.state, self._queries(X_t), y)

    def regress(self, X_t, y_t) -> tuple:
        """Recursive update of all 3 axes (the stored state changes);
        returns (mu_g, C_g)."""
        self._require("RGP", "regress")
        self.state = rgp_regress(self.state, self._queries(X_t), self._queries(y_t))
        return self.state.mu_g, self.state.C_g

    def fit(self, theta0=(1.0, 1.0, 1.0)) -> None:
        """Hyperparameter fit of the 3 exact GPs, one after the other."""
        if self.type == "RGP":
            raise NotImplementedError("RGP is not fitted with fit(); use regress()")
        self.state = stack_records([gp_fit(self.state.X[d], self.state.y[d], theta0)
                                    for d in range(3)])

    def get_theta(self) -> list:
        return [list(_np(self.state.theta[d])) for d in range(3)]

    @property
    def basis_vectors(self) -> torch.Tensor:
        return self.state.X

    def _require(self, type: str, what: str) -> None:
        if self.type != type:
            raise ValueError(f"{what} needs a {type} ensemble, this one is {self.type}")

    # ----------------------- io -----------------------
    def save(self, path: str) -> None:
        """Write `mdl_{x,y,z}.gp|.rgp` under the JAX package's key layout."""
        os.makedirs(path, exist_ok=True)
        ext = ".gp" if self.type == "GP" else ".rgp"
        st = self.state
        for d, ax in enumerate(_AXES):
            theta = _np(st.theta[d])
            if self.type == "GP":
                payload = {"kernel_params": {"L": np.eye(1) * float(theta[0]),
                                             "sigma_f": float(theta[1])},
                           "kernel_type": "SEK", "X": _np(st.X[d]), "y": _np(st.y[d]),
                           "theta": theta, "X_dim": 1}
            else:
                payload = {"X": _np(st.X[d]), "y": _np(st.mu_g[d]), "theta": theta,
                           "C_g": _np(st.C_g[d])}
                if self.learn is not None:
                    payload.update(mu_eta=_np(self.learn.mu_eta[d]), C_eta=_np(self.learn.C_eta[d]),
                                   C_g_eta=_np(self.learn.C_g_eta[d]))
            with open(os.path.join(path, f"mdl_{ax}{ext}"), "wb") as f:
                pickle.dump(payload, f)


def _robust_load(f):
    """A plain pickle, or a joblib dump (the reference's files)."""
    try:
        return pickle.load(f)
    except (pickle.UnpicklingError, EOFError, KeyError, ValueError):
        f.seek(0)
        import joblib

        return joblib.load(f)
