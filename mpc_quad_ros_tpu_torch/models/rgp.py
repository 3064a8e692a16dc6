"""Recursive Gaussian process on fixed basis vectors, on tensors.

Counterpart of ``mpc_quad_ros_tpu/models/rgp.py``: the state, the RBF
kernel, prediction (with its covariance, and with an external basis
response), the Kalman-style update, and the joint basis and hyperparameter
learner (the unscented transform over [L, sigma_f, sigma_n]).  Where the JAX
package vmaps over the (episode, axis) dims, every function here broadcasts
over leading dims of the state: X (..., nb), C_g (..., nb, nb), theta
(..., 3); queries and data carry the same leading dims.  So the 3-axis
``ensemble_*`` forms are the functions themselves.
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


def _rbf_theta(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """rbf with L = theta[..., 0] and sigma_f = theta[..., 1]."""
    return rbf(x1, x2, theta[..., 0, None, None], theta[..., 1, None, None])


def rgp_kernel_matrix(state: RGPState, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return _rbf_theta(state.theta, x1, x2)


def rgp_init(X: torch.Tensor, y: torch.Tensor | None = None, C: torch.Tensor | None = None,
             theta=(1.0, 0.1, 0.1)) -> RGPState:
    """Prior mean y (zeros when learning from scratch), prior covariance
    K(X, X) + sigma_n^2 I unless C is given.  X (..., nb); y (..., nb); C
    (..., nb, nb); theta a 3-sequence or a (..., 3) tensor."""
    kw = dict(dtype=X.dtype, device=X.device)
    theta = torch.as_tensor(theta, **kw).expand(X.shape[:-1] + (3,)).clone()
    y = torch.zeros_like(X) if y is None else torch.as_tensor(y, **kw)
    eye = torch.eye(X.shape[-1], **kw)
    K_x = _rbf_theta(theta, X, X) + theta[..., 2, None, None] ** 2 * eye
    C_g = K_x if C is None else torch.as_tensor(C, **kw)
    return RGPState(X=X, mu_g=y, C_g=C_g, K_x_inv=torch.linalg.inv(K_x), theta=theta)


def rgp_gain(state: RGPState, x_star: torch.Tensor) -> torch.Tensor:
    """The gain J_t = K(x*, X) K_x^-1: x_star (..., m) -> (..., m, nb)."""
    return rgp_kernel_matrix(state, x_star, state.X) @ state.K_x_inv


def rgp_predict(state: RGPState, x_star: torch.Tensor, with_cov: bool = False):
    """Posterior mean at x_star (..., m): mu (..., m), or (mu, C_p (..., m,
    m), J_t (..., m, nb)) with `with_cov`."""
    Jt = rgp_gain(state, x_star)
    mu = (Jt @ state.mu_g[..., None])[..., 0]
    if not with_cov:
        return mu
    K_ss = rgp_kernel_matrix(state, x_star, x_star)
    Bm = K_ss - Jt @ rgp_kernel_matrix(state, state.X, x_star)
    return mu, Bm + Jt @ state.C_g @ Jt.mT, Jt


def rgp_predict_using_y(state: RGPState, x_star: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Posterior mean at x_star (..., m) given an external basis response y
    (..., nb): J_t(x*) y."""
    return (rgp_gain(state, x_star) @ y[..., None])[..., 0]


def rgp_regress(state: RGPState, x_t: torch.Tensor, y_t: torch.Tensor,
                symmetrize: bool = True) -> RGPState:
    """Kalman-style update with new data x_t, y_t (..., k).  k = 1, the
    control-loop case, takes the elementwise path; k > 1 the matrix path.
    With `symmetrize`, C_g is re-symmetrised after the update (keeps it PSD
    over long f32 runs)."""
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
        mu_p, C_p, Jt = rgp_predict(state, x_t, with_cov=True)
        eye = torch.eye(x_t.shape[-1], dtype=x_t.dtype, device=x_t.device)
        S = C_p + sigma_n[..., None, None] ** 2 * eye
        G = torch.linalg.solve(S, (state.C_g @ Jt.mT).mT).mT            # (..., nb, k)
        mu_new = state.mu_g + (G @ (y_t - mu_p)[..., None])[..., 0]
        C_new = state.C_g - G @ Jt @ state.C_g
    if symmetrize:
        C_new = 0.5 * (C_new + C_new.mT)
    return state.replace(mu_g=mu_new, C_g=C_new)


def _sqrtm_psd(C: torch.Tensor) -> torch.Tensor:
    """Square root of a symmetric PSD matrix by its eigendecomposition
    (negative eigenvalues clipped to 0); unique, so the eigenvectors' signs
    do not matter."""
    vals, vecs = torch.linalg.eigh(C)
    return (vecs * vals.clamp_min(0.0).sqrt()[..., None, :]) @ vecs.mT


@dataclasses.dataclass(frozen=True)
class RGPLearnState(Tensors):
    """The joint basis and hyperparameter learner's state: the RGP, and the
    hyperparameters' posterior and cross-covariance."""

    base: RGPState
    mu_eta: torch.Tensor    # (..., 3) hyperparameter mean [L, sigma_f, sigma_n]
    C_eta: torch.Tensor     # (..., 3, 3)
    C_g_eta: torch.Tensor   # (..., nb, 3)


def rgp_learn_init(state: RGPState) -> RGPLearnState:
    kw = dict(dtype=state.X.dtype, device=state.X.device)
    lead = state.X.shape[:-1]
    return RGPLearnState(base=state, mu_eta=state.theta,
                         C_eta=torch.eye(3, **kw).expand(lead + (3, 3)).clone(),
                         C_g_eta=torch.zeros(lead + (state.X.shape[-1], 3), **kw))


def rgp_learn(ls: RGPLearnState, x_t: torch.Tensor, y_t: torch.Tensor) -> RGPLearnState:
    """One joint basis and hyperparameter update from a scalar observation
    x_t, y_t (..., 1), by the unscented transform over eta = [L, sigma_f,
    sigma_n] (the JAX ``rgp_learn``).  The sigma points' moments are combined
    by the JAX package's sequential recurrence (the running mean inside each
    outer product), and C_g_eta is left as it was, as there."""
    st = ls.base
    n_g, n_eta = st.mu_g.shape[-1], ls.mu_eta.shape[-1]
    lead = st.mu_g.shape[:-1]
    kw = dict(dtype=st.X.dtype, device=st.X.device)
    mu_eta, C_eta, C_g_eta = ls.mu_eta, ls.C_eta, ls.C_g_eta

    Jt = _rbf_theta(mu_eta, x_t, st.X) @ st.K_x_inv                             # (..., 1, n_g)
    Bm = _rbf_theta(mu_eta, x_t, x_t) - Jt @ _rbf_theta(mu_eta, st.X, x_t)    # (..., 1, 1)
    St = torch.linalg.solve(C_eta.mT, C_g_eta.mT).mT                           # (..., n_g, n_eta)

    n_p = n_g + n_eta + 1
    At = torch.zeros(lead + (n_p, n_g + n_eta), **kw)
    At[..., :n_g, :n_g] = torch.eye(n_g, **kw)
    At[..., n_g:n_g + n_eta, n_g:] = torch.eye(n_eta, **kw)
    At[..., n_g + n_eta:, :n_g] = Jt
    C_w = torch.zeros(lead + (n_p, n_p), **kw)
    C_w[..., -1, -1] = Bm[..., 0, 0]

    # the unscented transform over eta: 2 n + 1 sigma points
    w0 = 0.5
    sq = _sqrtm_psd(n_eta / (1.0 - w0) * C_eta)
    m = mu_eta[..., None, :]
    eta_pts = torch.cat([m, m + sq.mT, m - sq.mT], dim=-2)                    # (..., 7, n_eta)
    weights = [w0] + [(1 - w0) / (2 * n_eta)] * (2 * n_eta)

    # every point's covariance is the same: At [C_g - St C_g_eta^T, 0; 0, 0] At^T + C_w
    tmp = torch.zeros(lead + (n_g + n_eta, n_g + n_eta), **kw)
    tmp[..., :n_g, :n_g] = st.C_g - St @ C_g_eta.mT
    C_i = At @ tmp @ At.mT + C_w
    mu_acc = torch.zeros(lead + (n_p,), **kw)
    C_acc = torch.zeros(lead + (n_p, n_p), **kw)
    for i, wi in enumerate(weights):
        eta_i = eta_pts[..., i, :]
        g_i = st.mu_g + (St @ (eta_i - mu_eta)[..., None])[..., 0]
        mu_i = (At @ torch.cat([g_i, eta_i], -1)[..., None])[..., 0]
        mu_acc = mu_acc + wi * mu_i
        e = mu_i - mu_acc
        C_acc = C_acc + wi * (e[..., :, None] * e[..., None, :] + C_i)
    mu_p, C_p = mu_acc, C_acc

    # the update: observed o = [sigma_n, y], the rest u
    s = n_g + n_eta - 1
    mu_o, C_o = mu_p[..., s:], C_p[..., s:, s:]
    mu_u, C_u_prev = mu_p[..., :s], C_p[..., :s, :s]
    C_ou = C_p[..., s:, :s]

    mu_y = mu_o[..., 1:]
    C_y = C_o[..., 1:, 1:] + C_o[..., 0, 0, None, None] + mu_o[..., 0, None, None] ** 2
    C_o_y = C_o[..., :, 1:]
    Gt = torch.linalg.solve(C_y.mT, C_o_y.mT).mT                               # (..., 2, 1)
    mu_e = mu_o + (Gt @ (y_t - mu_y)[..., None])[..., 0]
    C_e = C_o - Gt @ C_y @ Gt.mT

    Lt = torch.linalg.solve(C_o.mT, C_ou).mT                                   # (..., s, 2)
    mu_u_new = mu_u + (Lt @ (mu_e - mu_o)[..., None])[..., 0]
    C_u_new = C_u_prev + Lt @ (C_e - C_o) @ Lt.mT

    # h = e_0 picks sigma_n out of the observed pair
    mu_z = torch.cat([mu_u_new, mu_e[..., :1]], -1)
    top = torch.cat([C_u_new, (Lt @ C_e)[..., :, :1]], -1)
    bot = torch.cat([(C_e @ Lt.mT)[..., :1, :], C_e[..., :1, :1]], -1)
    C_z = torch.cat([top, bot], -2)

    mu_eta_new = mu_z[..., n_g:]
    eye = torch.eye(n_g, **kw)
    K_x = _rbf_theta(mu_eta_new, st.X, st.X) + mu_eta_new[..., 2, None, None] ** 2 * eye
    base = RGPState(X=st.X, mu_g=mu_z[..., :n_g], C_g=C_z[..., :n_g, :n_g],
                    K_x_inv=torch.linalg.inv(K_x), theta=mu_eta_new)
    return RGPLearnState(base=base, mu_eta=mu_eta_new, C_eta=C_z[..., n_g:, n_g:],
                         C_g_eta=C_g_eta)


def ensemble_init(x_min_max, n_basis: int, theta=(1.0, 0.1, 0.1), dtype=torch.float32,
                  device=None) -> RGPState:
    """The 3-axis RGP ensemble with n_basis linspaced basis vectors over each
    axis's (min, max): an RGPState with a leading (3,) axis."""
    X = torch.stack([torch.linspace(lo, hi, n_basis, dtype=dtype, device=device)
                     for lo, hi in x_min_max])
    return rgp_init(X, theta=theta)


# the 3-axis forms: the functions broadcast over the leading (3,) axis
ensemble_predict = rgp_predict
ensemble_predict_using_y = rgp_predict_using_y
ensemble_regress = rgp_regress
