"""Coordinate grids.

Port of counterfactualworldmodels_tpu/ops/coords.py.
"""
from __future__ import annotations

import torch


def coordinate_ims(batch_size: int, seq_length: int, imsize,
                   normalize: bool = True, dtype=torch.float32,
                   device='cpu') -> torch.Tensor:
    """[B,T,H,W,2] grid of (h, w) coordinates; [B,H,W,2] if seq_length == 0.

    normalize=True maps coordinates to [-1, 1]."""
    t = max(seq_length, 1)
    h_dim, w_dim = imsize
    h = torch.arange(h_dim, dtype=dtype, device=device)
    w = torch.arange(w_dim, dtype=dtype, device=device)
    if normalize:
        h = 2.0 * (h / (h_dim - 1) - 0.5)
        w = 2.0 * (w / (w_dim - 1) - 0.5)
    grid = torch.stack([h[:, None].expand(h_dim, w_dim),
                        w[None, :].expand(h_dim, w_dim)], -1)
    grid = grid[None, None].expand(batch_size, t, h_dim, w_dim, 2)
    return grid[:, 0] if seq_length == 0 else grid
