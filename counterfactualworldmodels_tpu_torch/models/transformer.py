"""Cross-attention transformer blocks of the conjoined (two-stream) models.

Port of counterfactualworldmodels_tpu/models/transformer.py. The cross
attention is plain attention (f32 scores and softmax, as the JAX package's
``dense_attention`` and einsums), so these blocks run as tensor products
on either device; the streams' self-attention blocks (models/layers.Block)
are where the flash kernel runs.

``state_dict`` keys are the reference layout the JAX package's torch
export writes (``cross_attention.{qk,qk_src,v,v_src,projection,
projection_src}``, ``mlp.{trg,src}.layers.{0,2}``,
``self_attention.{trg,src}.{qkv,q_bias,v_bias,projection}``, the norms and
the layerscale gammas). ``UnidirectionalCrossAttention`` has no reference
export; its keys follow the JAX parameter names (``qv``, ``k``,
``projection``, ``q_bias``, ``v_bias``). Mixed precision is flax's, as in
models/layers.py.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, dense, dense_attention


def _heads(z, b, n, h, width):
    """[B, N, h*width] -> [B, h, N, width]."""
    return z.reshape(b, n, h, width).transpose(1, 2)


def _softmax_f32(q, k, spec):
    return torch.softmax(torch.einsum(spec, q.float(), k.float()), dim=-1)


def _apply(attn, v, spec, dtype):
    """attn probabilities cast to ``dtype``, f32 product, ``dtype`` out."""
    return torch.einsum(spec, attn.to(dtype).float(), v.float()).to(dtype)


class GenericMlp(nn.Module):
    """layers.0 (Linear) -> exact GELU -> layers.2 (Linear)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(in_dim, hidden_dim, device=device), nn.GELU(),
            nn.Linear(hidden_dim, out_dim, device=device))
        self.dtype = dtype

    def forward(self, x):
        h = F.gelu(dense(x, self.layers[0], self.dtype), approximate='none')
        return dense(h, self.layers[2], self.dtype)


class CrossSelfAttention(nn.Module):
    """Self-attention with head_dim / out_dim overrides: fused ``qkv``
    without bias plus ``q_bias`` / ``v_bias``, then ``projection``."""

    def __init__(self, in_dim: int, num_heads: int = 8,
                 head_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        if out_dim is None:
            head_dim = head_dim or in_dim // num_heads
            out_dim = head_dim * num_heads
        else:
            head_dim = head_dim or out_dim // num_heads
        self.num_heads, self.head_dim = num_heads, head_dim
        self.scale = qk_scale or head_dim ** -0.5
        inner = head_dim * num_heads
        self.qkv = nn.Linear(in_dim, 3 * inner, bias=False, device=device)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(inner, device=device))
            self.v_bias = nn.Parameter(torch.zeros(inner, device=device))
        else:
            self.q_bias = self.v_bias = None
        self.projection = nn.Linear(inner, out_dim, device=device)
        self.dtype = dtype

    def forward(self, x):
        b, n, _ = x.shape
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt))
        if self.q_bias is not None:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(dt)
        qkv = qkv.reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        y = dense_attention(q * self.scale, k, v, dtype=dt)
        y = y.transpose(1, 2).reshape(b, n, -1)
        return dense(y, self.projection, dt)


class UnidirectionalCrossAttention(nn.Module):
    """src -> target flow: queries and values from src, keys from the
    target; each target token reads a softmax over the src tokens. Returns
    (y, None): the src stream passes through unchanged."""

    def __init__(self, in_dim: int, num_heads: int,
                 in_dim_src: Optional[int] = None,
                 head_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        in_dim_src = in_dim_src or in_dim
        head_dim = head_dim or in_dim // num_heads
        out_dim = out_dim or in_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.scale = qk_scale or head_dim ** -0.5
        inner = head_dim * num_heads
        self.qv = nn.Linear(in_dim_src, 2 * inner, bias=False, device=device)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(inner, device=device))
            self.v_bias = nn.Parameter(torch.zeros(inner, device=device))
        else:
            self.q_bias = self.v_bias = None
        self.k = nn.Linear(in_dim, inner, bias=False, device=device)
        self.projection = nn.Linear(inner, out_dim, device=device)
        self.dtype = dtype

    def forward(self, x, src):
        dt, h, d = self.dtype, self.num_heads, self.head_dim
        b, n, _ = x.shape
        m = src.shape[1]
        qv = dense(src, self.qv, dt)
        if self.q_bias is not None:
            qv = qv + torch.cat([self.q_bias, self.v_bias]).to(dt)
        qv = qv.reshape(b, m, 2, h, d)
        q = qv[:, :, 0].transpose(1, 2)
        v = qv[:, :, 1].transpose(1, 2)
        k = _heads(dense(x, self.k, dt), b, n, h, d) * self.scale
        attn = _softmax_f32(q, k, 'bhmd,bhnd->bhnm')
        y = _apply(attn, v, 'bhnm,bhmd->bhnd', dt)
        y = y.transpose(1, 2).reshape(b, n, h * d)
        return dense(y, self.projection, dt), None


class BidirectionalCrossAttention(nn.Module):
    """Two-way token exchange: each stream reads a softmax over the other's
    tokens (one shared similarity, or a separate one per direction)."""

    def __init__(self, in_dim: int, num_heads: int,
                 shared_similarity: bool = False,
                 in_dim_src: Optional[int] = None,
                 head_dim: Optional[int] = None,
                 out_dim: Optional[int] = None,
                 out_dim_src: Optional[int] = None,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        in_dim_src = in_dim_src or in_dim
        head_dim = head_dim or in_dim // num_heads
        out_dim = out_dim or in_dim
        out_dim_src = out_dim_src or in_dim_src
        self.num_heads, self.head_dim = num_heads, head_dim
        self.scale = qk_scale or head_dim ** -0.5
        self.shared_similarity = shared_similarity
        inner = head_dim * num_heads
        self.qk = nn.Linear(in_dim, 2 * inner, bias=False, device=device)
        self.qk_src = nn.Linear(in_dim_src, 2 * inner, bias=False,
                                device=device)
        self.v = nn.Linear(in_dim, inner, bias=False, device=device)
        self.v_src = nn.Linear(in_dim_src, inner, bias=False, device=device)
        self.projection = nn.Linear(inner, out_dim, device=device)
        self.projection_src = nn.Linear(inner, out_dim_src, device=device)
        self.dtype = dtype

    def forward(self, x, src):
        dt, h, d = self.dtype, self.num_heads, self.head_dim
        b, n, _ = x.shape
        m = src.shape[1]
        qk = _heads(dense(x, self.qk, dt), b, n, h, 2 * d)
        qk_src = _heads(dense(src, self.qk_src, dt), b, m, h, 2 * d)
        v = _heads(dense(x, self.v, dt), b, n, h, d)
        v_src = _heads(dense(src, self.v_src, dt), b, m, h, d)
        y, y_src = self.exchange(qk, qk_src, v, v_src)
        return (dense(y, self.projection, dt),
                dense(y_src, self.projection_src, dt))

    def exchange(self, qk, qk_src, v, v_src):
        """Each stream's read of the other [B, N, h*d] / [B, M, h*d], before
        the projections, from the heads' qk [B, h, N, 2d], qk_src
        [B, h, M, 2d], v [B, h, N, d] and v_src [B, h, M, d]."""
        d = self.head_dim
        b, h, n, _ = v.shape
        m = v_src.shape[2]
        dt = self.dtype
        if self.shared_similarity:
            sim = torch.einsum('bhnd,bhmd->bhnm', (qk * self.scale).float(),
                               qk_src.float())
            attn = torch.softmax(sim, -1)
            attn_src = torch.softmax(sim.transpose(-2, -1), -1)
        else:
            attn = _softmax_f32(qk[..., :d] * self.scale, qk_src[..., :d],
                                'bhnd,bhmd->bhnm')
            attn_src = _softmax_f32(qk[..., d:] * self.scale,
                                    qk_src[..., d:], 'bhnd,bhmd->bhmn')
        y = _apply(attn, v_src, 'bhnm,bhmd->bhnd', dt)
        y_src = _apply(attn_src, v, 'bhmn,bhnd->bhmd', dt)
        return (y.transpose(1, 2).reshape(b, n, h * d),
                y_src.transpose(1, 2).reshape(b, m, h * d))


def _gammas(names_dims, init_values, device):
    if (init_values or 0) <= 0:
        return {}
    return {name: nn.Parameter(torch.full((dim,), float(init_values),
                                          device=device))
            for name, dim in names_dims}


class TransformerBlock(nn.Module):
    """Pre-norm block whose attention may change the width (a bias-free
    ``shortcut`` then carries the residual)."""

    def __init__(self, in_dim: int, num_heads: int = 8,
                 head_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 init_values: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        out_dim = out_dim or ((head_dim or in_dim // num_heads) * num_heads)
        self.norm1 = LayerNorm(in_dim, 1e-6, dtype, device)
        self.attention = CrossSelfAttention(in_dim, num_heads, head_dim,
                                            out_dim, qkv_bias, qk_scale,
                                            dtype, device)
        self.shortcut = (None if in_dim == out_dim else
                         nn.Linear(in_dim, out_dim, bias=False, device=device))
        self.norm2 = LayerNorm(out_dim, 1e-6, dtype, device)
        self.mlp = (GenericMlp(out_dim, int(out_dim * mlp_ratio), out_dim,
                               dtype, device) if mlp_ratio > 0 else None)
        for name, p in _gammas((('gamma_1', out_dim), ('gamma_2', out_dim)),
                               init_values, device).items():
            setattr(self, name, p)
        self.dtype = dtype

    def _g(self, name):
        p = getattr(self, name, None)
        return 1.0 if p is None else p.to(self.dtype)

    def forward(self, x):
        y = self.attention(self.norm1(x))
        sc = x if self.shortcut is None else dense(x, self.shortcut,
                                                   self.dtype)
        x = sc + self._g('gamma_1') * y
        if self.mlp is not None:
            x = x + self._g('gamma_2') * self.mlp(self.norm2(x))
        return x


class CrossAttentionTransformerBlock(nn.Module):
    """Cross attention (+ optional self-attention) + MLP over two streams.
    forward(x, src) -> (x, src); with ``unidirectional`` the src stream
    passes through unchanged."""

    GAMMAS = ('gamma_1', 'gamma_1_cross', 'gamma_1_src', 'gamma_1_src_cross',
              'gamma_2', 'gamma_2_src')

    def __init__(self, in_dim: int, num_heads: int,
                 in_dim_src: Optional[int] = None,
                 head_dim: Optional[int] = None,
                 out_dim: Optional[int] = None,
                 out_dim_src: Optional[int] = None, mlp_ratio: float = 4.0,
                 init_values: Optional[float] = None,
                 with_self_attention: bool = True,
                 shared_similarity: bool = False,
                 unidirectional: bool = False, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        in_dim_src = in_dim_src or in_dim
        out_dim = out_dim or in_dim
        out_dim_src = out_dim_src or in_dim_src
        self.dtype = dtype
        self.with_self_attention = with_self_attention
        self.passthrough_src = unidirectional
        self.norm1_cross = LayerNorm(in_dim, 1e-6, dtype, device)
        self.norm1_src_cross = LayerNorm(in_dim_src, 1e-6, dtype, device)
        if unidirectional:
            self.cross_attention = UnidirectionalCrossAttention(
                in_dim, num_heads, in_dim_src, head_dim, out_dim, qkv_bias,
                qk_scale, dtype, device)
        else:
            self.cross_attention = BidirectionalCrossAttention(
                in_dim, num_heads, shared_similarity, in_dim_src, head_dim,
                out_dim, out_dim_src, qk_scale, dtype, device)
        dims = dict(gamma_1=out_dim, gamma_1_cross=out_dim,
                    gamma_1_src=out_dim_src, gamma_1_src_cross=out_dim_src,
                    gamma_2=out_dim, gamma_2_src=out_dim_src)
        for name, p in _gammas(dims.items(), init_values, device).items():
            setattr(self, name, p)
        self.shortcut_trg = (None if in_dim == out_dim else nn.Linear(
            in_dim, out_dim, bias=False, device=device))
        self.shortcut_src = (None if in_dim_src == out_dim_src else nn.Linear(
            in_dim_src, out_dim_src, bias=False, device=device))
        if with_self_attention:
            self.norm1 = LayerNorm(in_dim, 1e-6, dtype, device)
            self.norm1_src = LayerNorm(in_dim_src, 1e-6, dtype, device)
            self.self_attention = nn.ModuleDict({
                'trg': CrossSelfAttention(in_dim, num_heads, head_dim,
                                          out_dim, qkv_bias, qk_scale, dtype,
                                          device),
                'src': CrossSelfAttention(in_dim_src, num_heads, head_dim,
                                          out_dim_src, qkv_bias, qk_scale,
                                          dtype, device)})
        self.mlp = None
        if mlp_ratio > 0:
            self.norm2 = LayerNorm(out_dim, 1e-6, dtype, device)
            mlps = {'trg': GenericMlp(out_dim, int(out_dim * mlp_ratio),
                                      out_dim, dtype, device)}
            if not unidirectional:
                self.norm2_src = LayerNorm(out_dim_src, 1e-6, dtype, device)
                mlps['src'] = GenericMlp(out_dim_src,
                                         int(out_dim_src * mlp_ratio),
                                         out_dim_src, dtype, device)
            self.mlp = nn.ModuleDict(mlps)

    def _g(self, name):
        if not self.with_self_attention and name in ('gamma_1',
                                                     'gamma_1_src'):
            return 0.0
        p = getattr(self, name, None)
        return 1.0 if p is None else p.to(self.dtype)

    def _shortcut(self, z, layer):
        return z if layer is None else dense(z, layer, self.dtype)

    def forward(self, x, src):
        y_cross, y_src_cross = self.cross_attention(self.norm1_cross(x),
                                                    self.norm1_src_cross(src))
        sa_trg = sa_src = 0.0
        if self.with_self_attention:
            sa_trg = self._g('gamma_1') * self.self_attention['trg'](
                self.norm1(x))
            sa_src = self._g('gamma_1_src') * self.self_attention['src'](
                self.norm1_src(src))
        x = (self._shortcut(x, self.shortcut_trg) + sa_trg
             + self._g('gamma_1_cross') * y_cross)
        if not self.passthrough_src:
            src = (self._shortcut(src, self.shortcut_src) + sa_src
                   + self._g('gamma_1_src_cross') * y_src_cross)
        if self.mlp is not None:
            x = x + self._g('gamma_2') * self.mlp['trg'](self.norm2(x))
            if not self.passthrough_src:
                src = src + self._g('gamma_2_src') * self.mlp['src'](
                    self.norm2_src(src))
        return x, src
