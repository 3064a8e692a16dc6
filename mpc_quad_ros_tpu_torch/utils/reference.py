"""Reference-trajectory chunks as clipped strided gathers.

Counterpart of ``mpc_quad_ros_tpu/utils/reference.py``: the rows
[current_idx + j skip for j < control_nodes], clipped to the last sample,
which is the reference's repeat-last-row end padding.
"""

from __future__ import annotations

import torch


def reference_gather_indices(current_idx, n_samples: int, control_nodes: int, skip: int = 1,
                             device=None) -> torch.Tensor:
    """(control_nodes,) indices current_idx + j skip, clipped to [0, n_samples - 1]."""
    j = torch.arange(control_nodes, device=device)
    return (current_idx + j * skip).clamp(0, n_samples - 1)


def get_reference_chunk(reference_trajectory: torch.Tensor, current_idx, control_nodes: int,
                        skip: int = 1) -> torch.Tensor:
    """(control_nodes, d) rows of a (T, d) trajectory from `current_idx`,
    every `skip`-th, the last row repeated past the end."""
    idx = reference_gather_indices(current_idx, reference_trajectory.shape[0], control_nodes,
                                   skip, reference_trajectory.device)
    return reference_trajectory[idx]
