"""Clip shards. Port of counterfactualworldmodels_tpu/data/shards.py
(``u8_to_chw_01`` so far; the shard format and its loaders come later)."""
from __future__ import annotations

import torch


def u8_to_chw_01(batch) -> torch.Tensor:
    """Device-side normalize for ``out_dtype='u8'`` loader batches: uint8
    [B, T, h, w, C] -> float32 [B, T, C, h, w] in [0, 1]."""
    x = torch.as_tensor(batch)
    return x.float().permute(0, 1, 4, 2, 3) / 255.0
