"""Recursive Gaussian process on fixed basis vectors, on tensors.

Counterpart of ``mpc_quad_ros_tpu/models/rgp.py`` (``RGPState``, ``rbf``,
``rgp_init``, ``rgp_regress``).  Where the JAX package vmaps over the
(episode, axis) dims, every function here broadcasts over leading dims of
the state: X (..., nb), C_g (..., nb, nb), theta (..., 3).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.containers import Tensors


@dataclasses.dataclass(frozen=True)
class RGPState(Tensors):
    X: torch.Tensor        # (..., nb) basis vector locations
    mu_g: torch.Tensor     # (..., nb) posterior mean at the basis vectors
    C_g: torch.Tensor      # (..., nb, nb) posterior covariance
    K_x_inv: torch.Tensor  # (..., nb, nb) (K(X, X) + sigma_n^2 I)^-1
    theta: torch.Tensor    # (..., 3) hyperparameters [L, sigma_f, sigma_n]


def rbf(x1: torch.Tensor, x2: torch.Tensor, L, sigma_f) -> torch.Tensor:
    """k(x1[i], x2[j]) = sigma_f^2 exp(-(x1 - x2)^2 / (2 L^2)); x1 (..., n),
    x2 (..., m) -> (..., n, m).  L and sigma_f broadcast against the result."""
    diff = x1[..., :, None] - x2[..., None, :]
    return sigma_f**2 * torch.exp(-0.5 * diff**2 / (L * L))


def rgp_init(X: torch.Tensor, theta=(1.0, 0.1, 0.1)) -> RGPState:
    """Zero prior mean, prior covariance K(X, X) + sigma_n^2 I.  X (..., nb);
    theta a 3-sequence or a (..., 3) tensor."""
    theta = torch.as_tensor(theta, dtype=X.dtype, device=X.device)
    theta = theta.expand(X.shape[:-1] + (3,)).clone()
    L, sf, sn = (theta[..., i, None, None] for i in range(3))
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    K_x = rbf(X, X, L, sf) + sn**2 * eye
    return RGPState(X=X, mu_g=torch.zeros_like(X), C_g=K_x,
                    K_x_inv=torch.linalg.inv(K_x), theta=theta)


def rgp_regress(state: RGPState, x_t: torch.Tensor, y_t: torch.Tensor) -> RGPState:
    """Kalman-style update with new data x_t, y_t (..., k).  k = 1, the
    control-loop case, takes the elementwise path; k > 1 the matrix path.
    C_g is re-symmetrised after the update (keeps it PSD over long f32
    runs)."""
    theta = state.theta
    sigma_n = theta[..., 2]
    if x_t.shape[-1] == 1:
        L_, sf = theta[..., 0, None], theta[..., 1, None]                # (..., 1)
        kx = sf**2 * torch.exp(-0.5 * (x_t - state.X) ** 2 / (L_ * L_))  # (..., nb)
        Jt1 = (kx[..., :, None] * state.K_x_inv).sum(-2)
        mu_p1 = (Jt1 * state.mu_g).sum(-1)
        B1 = sf[..., 0] ** 2 - (Jt1 * kx).sum(-1)
        CJ = (state.C_g * Jt1[..., None, :]).sum(-1)
        C_p1 = B1 + (Jt1 * CJ).sum(-1)
        G1 = CJ / (C_p1 + sigma_n**2)[..., None]
        mu_new = state.mu_g + G1 * (y_t[..., 0] - mu_p1)[..., None]
        JC = (Jt1[..., :, None] * state.C_g).sum(-2)
        C_new = state.C_g - G1[..., :, None] * JC[..., None, :]
    else:
        L_, sf = theta[..., 0, None, None], theta[..., 1, None, None]
        Jt = rbf(x_t, state.X, L_, sf) @ state.K_x_inv                  # (..., k, nb)
        mu_p = (Jt @ state.mu_g[..., None])[..., 0]
        Bm = rbf(x_t, x_t, L_, sf) - Jt @ rbf(state.X, x_t, L_, sf)
        C_p = Bm + Jt @ state.C_g @ Jt.mT
        eye = torch.eye(x_t.shape[-1], dtype=x_t.dtype, device=x_t.device)
        S = C_p + sigma_n[..., None, None] ** 2 * eye
        G = torch.linalg.solve(S, (state.C_g @ Jt.mT).mT).mT            # (..., nb, k)
        mu_new = state.mu_g + (G @ (y_t - mu_p)[..., None])[..., 0]
        C_new = state.C_g - G @ Jt @ state.C_g
    C_new = 0.5 * (C_new + C_new.mT)
    return state.replace(mu_g=mu_new, C_g=C_new)
