"""Bilinear image resize.

The JAX package resizes with ``jax.image.resize(..., 'bilinear')``, which
antialiases when it downsamples (a triangle filter widened by the scale)
and uses half-pixel centres. ``F.interpolate(mode='bilinear',
align_corners=False, antialias=True)`` computes the same filter; without
``antialias`` a 300x260 -> 224 resize differs from JAX's by up to 0.34.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the last two dims of x [..., H, W] to ``size`` (h, w), as
    jax.image.resize(x, (..., h, w), 'bilinear') does; other dims keep
    their shape."""
    size = tuple(int(v) for v in size)
    if tuple(x.shape[-2:]) == size:
        return x
    lead = x.shape[:-2]
    flat = x.reshape(1, -1, *x.shape[-2:]).float()
    out = F.interpolate(flat, size=size, mode='bilinear', align_corners=False,
                        antialias=True)
    return out.reshape(*lead, *size).to(x.dtype)
