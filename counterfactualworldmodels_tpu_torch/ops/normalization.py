"""Imagenet (un)normalization for [B,T,C,H,W] / [B,C,T,H,W] videos.

Port of counterfactualworldmodels_tpu/ops/normalization.py.
"""
from __future__ import annotations

import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def _mean_std(x: torch.Tensor, temporal_dim: int):
    shape = [1] * x.dim()
    channel_dim = 2 if temporal_dim == 1 else 1
    if x.dim() == 4:  # [B,C,H,W]
        channel_dim = 1
    shape[channel_dim] = 3
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=x.dtype,
                        device=x.device).reshape(shape)
    std = torch.tensor(IMAGENET_DEFAULT_STD, dtype=x.dtype,
                       device=x.device).reshape(shape)
    return mean, std


def imagenet_normalize(x: torch.Tensor, temporal_dim: int = 1) -> torch.Tensor:
    mean, std = _mean_std(x, temporal_dim)
    return (x - mean) / std


def imagenet_unnormalize(x: torch.Tensor,
                         temporal_dim: int = 1) -> torch.Tensor:
    mean, std = _mean_std(x, temporal_dim)
    return x * std + mean
