"""Where an entry point runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device, raising when the card is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device (pass device='cpu' for the plain versions)")
    return dev
