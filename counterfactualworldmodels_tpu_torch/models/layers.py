"""Transformer building blocks. Port of counterfactualworldmodels_tpu/models/
layers.py (``dense_attention`` so far; the exact-model blocks come with the
exact VMAE forward)."""
from __future__ import annotations

import torch


def dense_attention(q, k, v, dtype=torch.float32):
    """Plain softmax attention; q is pre-scaled. [B,H,N,D] each. f32 scores
    and softmax, probabilities cast to ``dtype``, f32 products, output in
    ``dtype``."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(dtype)
    return torch.matmul(attn.float(), v.float()).to(dtype)
