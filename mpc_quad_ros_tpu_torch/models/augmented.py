"""MPC model: nominal rigid body plus the learned (folded RGP) drag.

Counterpart of ``mpc_quad_ros_tpu/models/augmented.py`` for the RGP path:
``FoldedDrag``, ``fold_drag``, ``gp_mean_world`` (the FoldedDrag branch) and
``make_mpc_dynamics``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.containers import Tensors
from ..utils.rotations import quaternion_inverse, v_dot_q
from .dynamics import f_nominal
from .params import QuadParams
from .rgp import RGPState


@dataclasses.dataclass(frozen=True)
class FoldedDrag(Tensors):
    """Solve-invariant form of the per-axis RGP drag: during one solve the
    mean k(v, X) K_x^-1 mu_g collapses to k(v, X) . w with w = K_x^-1 mu_g."""

    X: torch.Tensor        # (..., 3, nb) basis vectors per axis
    w: torch.Tensor        # (..., 3, nb) folded weights per axis
    L: torch.Tensor        # (..., 3) RBF lengthscale per axis
    sigma_f: torch.Tensor  # (..., 3) RBF signal scale per axis


def fold_drag(aug):
    """RGPState -> FoldedDrag (w = K_x^-1 mu_g, L = theta_0, sigma_f =
    theta_1); None and FoldedDrag pass through."""
    if aug is None or isinstance(aug, FoldedDrag):
        return aug
    if isinstance(aug, RGPState):
        w = torch.einsum("...ij,...j->...i", aug.K_x_inv, aug.mu_g)
        return FoldedDrag(X=aug.X, w=w, L=aug.theta[..., 0], sigma_f=aug.theta[..., 1])
    raise TypeError(f"unsupported augmentation state: {type(aug)}")


def gp_mean_world(x: torch.Tensor, aug: FoldedDrag) -> torch.Tensor:
    """World-frame learned-drag acceleration at x: the per-axis mean at
    v_body = R(q)^T v, rotated back to world.  aug leaves broadcast against
    x's leading dims."""
    q = x[..., 3:7]
    v_body = v_dot_q(x[..., 7:10], quaternion_inverse(q))
    diff = v_body[..., :, None] - aug.X                                  # (..., 3, nb)
    k = aug.sigma_f[..., :, None] ** 2 * torch.exp(-0.5 * diff**2 / (aug.L[..., :, None] ** 2))
    mean = (k * aug.w).sum(-1)
    return v_dot_q(mean, q)


class MPCDynamics:
    """Continuous-time MPC model f(x, u, aug) -> ẋ: nominal dynamics, plus
    the folded RGP drag mean on v̇ when aug is given.  `params` is what the
    linearisation kernel reads its constants from."""

    def __init__(self, params: QuadParams):
        self.params = params

    def __call__(self, x: torch.Tensor, u: torch.Tensor,
                 aug: Optional[FoldedDrag] = None) -> torch.Tensor:
        dx = f_nominal(x, u, self.params)
        if aug is None:
            return dx
        a_world = gp_mean_world(x, fold_drag(aug))
        return torch.cat([dx[..., :7], dx[..., 7:10] + a_world, dx[..., 10:]], dim=-1)


def make_mpc_dynamics(params: QuadParams) -> MPCDynamics:
    return MPCDynamics(params)
