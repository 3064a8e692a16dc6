"""Exact (batch) Gaussian process regression, on tensors: the offline 'gp1'
drag model.

Counterpart of ``mpc_quad_ros_tpu/models/gp.py``: the trained state, its
mean and covariance, the Cholesky negative log marginal likelihood and the
maximum-likelihood fit (scipy's L-BFGS-B with lower bounds, driven by
``torch.autograd`` gradients of the NLL in float64 on the inputs' device).
Every function but the fit broadcasts over leading dims of its inputs: X
(..., n), theta (..., 3); the 3-axis ``ensemble_gp_*`` forms add a leading
(3,) axis.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.containers import Tensors, stack_records
from .rgp import rbf


@dataclasses.dataclass(frozen=True)
class GPState(Tensors):
    X: torch.Tensor        # (..., n) training inputs
    y: torch.Tensor        # (..., n) training targets
    alpha: torch.Tensor    # (..., n) K^-1 y
    K_inv: torch.Tensor    # (..., n, n)
    theta: torch.Tensor    # (..., 3) [L, sigma_f, noise]


def _kernel_with_noise(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """K(X, X) + (noise + 1e-7) I: the noise is added as it is, not squared
    (the reference's GP)."""
    L, sigma_f, noise = (theta[..., i, None, None] for i in range(3))
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return rbf(X, X, L, sigma_f) + (noise + 1e-7) * eye


def gp_init(X: torch.Tensor, y: torch.Tensor, theta=(1.0, 1.0, 1.0)) -> GPState:
    kw = dict(dtype=X.dtype, device=X.device)
    y = torch.as_tensor(y, **kw)
    theta = torch.as_tensor(theta, **kw).expand(X.shape[:-1] + (3,)).clone()
    K_inv = torch.linalg.inv(_kernel_with_noise(X, theta))
    return GPState(X=X, y=y, alpha=(K_inv @ y[..., None])[..., 0], K_inv=K_inv, theta=theta)


def gp_predict(state: GPState, x_star: torch.Tensor, with_cov: bool = False):
    """Posterior mean at x_star (..., m), and with `with_cov` its covariance
    (..., m, m)."""
    L, sigma_f = state.theta[..., 0, None, None], state.theta[..., 1, None, None]
    k_s = rbf(state.X, x_star, L, sigma_f)                               # (..., n, m)
    mu = (k_s.mT @ state.alpha[..., None])[..., 0]
    if not with_cov:
        return mu
    k_ss = rbf(x_star, x_star, L, sigma_f)
    return mu, k_ss - k_s.mT @ state.K_inv @ k_s


def gp_nll(X: torch.Tensor, y: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood by Cholesky: sum log diag(Lc) +
    y^T K^-1 y / 2 + n log(2 pi) / 2."""
    Lc = torch.linalg.cholesky(_kernel_with_noise(X, theta))
    s1 = torch.linalg.solve_triangular(Lc, y[..., None], upper=False)
    s2 = torch.linalg.solve_triangular(Lc.mT, s1, upper=True)[..., 0]
    return (torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * (y * s2).sum(-1) + 0.5 * X.shape[-1] * math.log(2 * math.pi))


def gp_fit(X: torch.Tensor, y: torch.Tensor, theta0=(1.0, 1.0, 1.0),
           low_bnd: float = 0.01) -> GPState:
    """Maximum-likelihood hyperparameters of one GP (X, y (n,)): scipy's
    L-BFGS-B with every theta bounded below by `low_bnd`, on the value and
    gradient of ``gp_nll`` in float64 on X's device (one host transfer an
    evaluation).  Returns ``gp_init`` at the optimum in X's dtype."""
    from scipy.optimize import minimize

    X64, y64 = X.detach().double(), torch.as_tensor(y, device=X.device).detach().double()

    def fun(th_np):
        th = torch.tensor(th_np, dtype=torch.float64, device=X.device, requires_grad=True)
        v = gp_nll(X64, y64, th)
        (g,) = torch.autograd.grad(v, th)
        vg = torch.cat([v.detach()[None], g]).cpu().numpy()
        return float(vg[0]), vg[1:]

    res = minimize(fun, x0=np.asarray(theta0, dtype=np.float64), jac=True, method="L-BFGS-B",
                   bounds=[(low_bnd, None)] * 3)
    return gp_init(X, y, theta=torch.as_tensor(res.x, dtype=X.dtype, device=X.device))


def ensemble_gp_fit(X: torch.Tensor, y: torch.Tensor, theta0=(1.0, 1.0, 1.0)) -> GPState:
    """The 3 per-axis fits, one after the other (offline)."""
    return stack_records([gp_fit(X[d], y[d], theta0) for d in range(X.shape[0])])


# the 3-axis forms: the functions broadcast over the leading (3,) axis
ensemble_gp_init = gp_init
ensemble_gp_predict = gp_predict
