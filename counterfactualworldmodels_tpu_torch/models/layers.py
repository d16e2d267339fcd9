"""Transformer building blocks of the VMAE family. Port of
counterfactualworldmodels_tpu/models/layers.py.

The modules' ``state_dict`` keys are the reference (torch) layout that
``utils/weights.vmae_state_dict_from_jax`` produces: a fused ``qkv.weight``
[3A, D] with separate ``q_bias`` / ``v_bias`` (k bias fixed at zero),
``nn.Linear`` / ``nn.LayerNorm`` weights, and the patch embedding as a
Conv3d weight [E, C, pt, ph, pw].

Mixed precision mirrors flax, not ``torch.autocast``: parameters stay f32;
each product casts its weight to the compute ``dtype`` (accumulating in f32)
and adds its bias in that dtype; LayerNorm takes its statistics in f32 and
returns the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.patches import patchify


def dense_attention(q, k, v, dtype=torch.float32):
    """Plain softmax attention; q is pre-scaled. [B,H,N,D] each. f32 scores
    and softmax, probabilities cast to ``dtype``, f32 products, output in
    ``dtype``."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(dtype)
    return torch.matmul(attn.float(), v.float()).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6, dtype=None):
    """LayerNorm as flax computes it: statistics and affine in f32, output
    in ``dtype`` (default: x's)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(dtype or x.dtype)


def dense(x, layer: nn.Linear, dtype):
    """flax ``nn.Dense(dtype=...)``: x and the weight in ``dtype``, the
    product accumulated in f32, then the bias added in ``dtype``."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` parameters with flax's numerics (``layer_norm``)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__(dim, eps=eps, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps,
                          self.compute_dtype)


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features, device=device)
        self.fc2 = nn.Linear(hidden_features, out_features, device=device)
        self.dtype = dtype

    def forward(self, x):
        h = F.gelu(dense(x, self.fc1, self.dtype), approximate='none')
        return dense(h, self.fc2, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with the reference's split q/v bias layout:
    fused qkv weight without bias plus separate q_bias / v_bias (k bias
    fixed at zero). attn_impl 'flash' runs ops/flash_attention (K1, or
    K5/K6 when a gradient is asked for); 'dense' the plain
    ``dense_attention``."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 attn_head_dim: Optional[int] = None, dtype=torch.float32,
                 attn_impl: str = 'dense', device=None):
        super().__init__()
        if attn_impl not in ('dense', 'flash'):
            raise ValueError(f'attn_impl must be "dense" or "flash": {attn_impl!r}')
        self.num_heads = num_heads
        self.head_dim = attn_head_dim or dim // num_heads
        all_head_dim = self.head_dim * num_heads
        self.scale = qk_scale or self.head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * all_head_dim, bias=False, device=device)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(all_head_dim, device=device))
            self.v_bias = nn.Parameter(torch.zeros(all_head_dim, device=device))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(all_head_dim, dim, device=device)
        self.dtype = dtype
        self.attn_impl = attn_impl

    def forward(self, x):
        b, n, _ = x.shape
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt))
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
            qkv = qkv + bias.to(dt)
        qkv = qkv.reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)     # [B,H,N,d]
        q = (q * self.scale).contiguous()
        k, v = k.contiguous(), v.contiguous()
        if self.attn_impl == 'flash':
            from ..ops.flash_attention import flash_attention
            out = flash_attention(q, k, v)
        else:
            out = dense_attention(q, k, v, dtype=dt)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return dense(out, self.proj, dt)


class Block(nn.Module):
    """Pre-norm transformer block with optional layerscale gammas."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 init_values: Optional[float] = None,
                 attn_head_dim: Optional[int] = None, dtype=torch.float32,
                 attn_impl: str = 'dense', norm_eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, dtype, device)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale,
                              attn_head_dim, dtype, attn_impl, device)
        self.norm2 = LayerNorm(dim, norm_eps, dtype, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, device)
        if (init_values or 0) > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values),
                                                   device=device))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values),
                                                   device=device))
        else:
            self.gamma_1 = self.gamma_2 = None
        self.dtype = dtype

    def forward(self, x):
        if self.gamma_1 is None:
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + self.gamma_1.to(self.dtype) * self.attn(self.norm1(x))
        return x + self.gamma_2.to(self.dtype) * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Tubelet patch embedding as patchify + one matmul (the reference's
    strided Conv3d is exactly a linear map on patch vectors because stride
    == kernel). The weight keeps the Conv3d shape [E, C, pt, ph, pw].
    Input [B, C, T, H, W]."""

    def __init__(self, patch_size, in_chans: int, embed_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_chans, embed_dim, self.patch_size,
                              stride=self.patch_size, device=device)
        self.dtype = dtype

    def forward(self, x):
        patches = patchify(x, self.patch_size, temporal_dim=2)  # [B,N,(pt ph pw c)]
        w = self.proj.weight                                    # [E, C, pt, ph, pw]
        kernel = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)
        out = F.linear(patches.to(self.dtype), kernel.to(self.dtype))
        return out + self.proj.bias.to(self.dtype)


def interpolate_with_mask_token(x, mask, mask_token, invert: bool = True):
    """Soft lerp between tokens and a mask token."""
    b, n, c = x.shape
    m = torch.clamp(mask.to(x.dtype), 0.0, 1.0)
    if invert:
        m = 1.0 - m
    m = m[..., None]
    token = mask_token.reshape(1, 1, c).expand(b, n, c)
    return token + m * (x - token)
