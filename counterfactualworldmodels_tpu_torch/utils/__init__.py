import numpy as np
import torch

from . import weights  # noqa: F401


def to_host(t: torch.Tensor) -> np.ndarray:
    """t as a float32 numpy array on the host (detached; a tensor on the
    card is copied back)."""
    return t.detach().float().cpu().numpy()
