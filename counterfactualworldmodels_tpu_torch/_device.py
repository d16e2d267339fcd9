"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for (the
    default of every entry point) and no GPU is present, so nothing ever
    carries on quietly on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    return device
