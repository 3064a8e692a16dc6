"""MPC model: nominal rigid body plus the learned drag.

Counterpart of ``mpc_quad_ros_tpu/models/augmented.py``: ``FoldedDrag``,
``fold_drag``, ``gp_mean_world`` and ``make_mpc_dynamics``.  The drag model
is the online RGP (gp2, an ``RGPState``), the pretrained exact GP (gp1, a
``GPState``) or either one folded; None is the nominal model (gp0).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.containers import Tensors
from ..utils.rotations import quaternion_inverse, v_dot_q
from .dynamics import f_nominal
from .gp import GPState, gp_predict
from .params import QuadParams
from .rgp import RGPState, rgp_predict_using_y


@dataclasses.dataclass(frozen=True)
class FoldedDrag(Tensors):
    """Solve-invariant form of the per-axis drag: during one solve the mean
    k(v, X) K_x^-1 mu_g (RGP) or k(v, X) alpha (GP) is k(v, X) . w with the
    weights w folded once."""

    X: torch.Tensor        # (..., 3, nb) basis vectors (training inputs) per axis
    w: torch.Tensor        # (..., 3, nb) folded weights per axis
    L: torch.Tensor        # (..., 3) RBF lengthscale per axis
    sigma_f: torch.Tensor  # (..., 3) RBF signal scale per axis


def fold_drag(aug):
    """RGPState -> FoldedDrag (w = K_x^-1 mu_g), GPState -> FoldedDrag (w =
    alpha); None, a FoldedDrag and any other record pass through unchanged,
    as in the JAX package."""
    if isinstance(aug, RGPState):
        w = torch.einsum("...ij,...j->...i", aug.K_x_inv, aug.mu_g)
        return FoldedDrag(X=aug.X, w=w, L=aug.theta[..., 0], sigma_f=aug.theta[..., 1])
    if isinstance(aug, GPState):
        return FoldedDrag(X=aug.X, w=aug.alpha, L=aug.theta[..., 0], sigma_f=aug.theta[..., 1])
    return aug


def gp_mean_world(x: torch.Tensor, aug) -> torch.Tensor:
    """World-frame learned-drag acceleration at x: the per-axis mean at
    v_body = R(q)^T v, rotated back to world.  aug is a FoldedDrag, an
    RGPState or a GPState with a (3,) axis before its own dims; its leaves
    broadcast against x's leading dims."""
    q = x[..., 3:7]
    v_body = v_dot_q(x[..., 7:10], quaternion_inverse(q))
    if isinstance(aug, FoldedDrag):
        diff = v_body[..., :, None] - aug.X                              # (..., 3, nb)
        k = aug.sigma_f[..., :, None] ** 2 * torch.exp(-0.5 * diff**2 / (aug.L[..., :, None] ** 2))
        mean = (k * aug.w).sum(-1)
    elif isinstance(aug, RGPState):
        mean = rgp_predict_using_y(aug, v_body[..., None], aug.mu_g)[..., 0]
    elif isinstance(aug, GPState):
        mean = gp_predict(aug, v_body[..., None])[..., 0]
    else:
        raise TypeError(f"unsupported augmentation state: {type(aug)}")
    return v_dot_q(mean, q)


class MPCDynamics:
    """Continuous-time MPC model f(x, u, aug) -> ẋ: nominal dynamics, plus
    the learned drag mean on v̇ when aug is given.  `params` is what the
    linearisation kernel reads its constants from."""

    def __init__(self, params: QuadParams):
        self.params = params

    def __call__(self, x: torch.Tensor, u: torch.Tensor, aug=None) -> torch.Tensor:
        dx = f_nominal(x, u, self.params)
        if aug is None:
            return dx
        a_world = gp_mean_world(x, aug)
        return torch.cat([dx[..., :7], dx[..., 7:10] + a_world, dx[..., 10:]], dim=-1)


def make_mpc_dynamics(params: QuadParams) -> MPCDynamics:
    return MPCDynamics(params)
