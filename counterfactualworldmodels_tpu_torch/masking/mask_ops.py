"""Mask manipulation ops. Port of counterfactualworldmodels_tpu/masking/
mask_ops.py (``upsample_masks`` so far). Mask convention: bool, True = masked.
"""
from __future__ import annotations

import torch


def upsample_masks(masks: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbor resize of a [..., h, w] mask to (H, W); integer
    up/down factors only."""
    h, w = masks.shape[-2:]
    H, W = size
    if (H, W) == (h, w):
        return masks
    if H < h and W < w:
        return masks[..., ::h // H, ::w // W]
    if H % h or W % w:
        raise ValueError(f'non-integer upsampling {(h, w)} -> {(H, W)}')
    masks = masks.repeat_interleave(H // h, dim=-2)
    return masks.repeat_interleave(W // w, dim=-1)
