"""Box-QP helpers.  Counterpart of ``mpc_quad_ros_tpu/ops/qp.py``; the port
has only the KKT residual so far (its IPM is ``ops/cuda/qp_kernel.py``)."""

from __future__ import annotations

import torch


def qp_kkt_residual(H, g, lb, ub, z) -> torch.Tensor:
    """Projected-gradient KKT violation max |clip(z - (Hz + g), lb, ub) - z|
    of every leading index (NaN propagates)."""
    grad = (H @ z[..., None])[..., 0] + g
    proj = torch.minimum(torch.maximum(z - grad, lb), ub) - z
    return proj.abs().amax(-1)
