"""Shared-prefix counterfactual engine for the VMAE predictor.

Port of counterfactualworldmodels_tpu/models/fast_vmae.py. The counterfactual
workload runs one 2-frame scene through the predictor S times, varying
only a motion prompt: frame 0 is fully visible and identical across the
samples. Prefix-isolated attention computes frame 0's encoder and decoder
states ONCE (frame-0 queries attend frame-0 keys only) and caches their
per-layer keys/values; per-sample (suffix) tokens then attend
[cached prefix K/V ; own K/V].

Attention on the path goes to the hand-written kernels on CUDA
(ops/flash_attention: K1 for the prefix blocks, K2 for the suffix decoder)
and to their plain versions on the CPU. The layer loop is a Python loop
over parameters stacked [L, ...] (``jax.lax.scan`` in the JAX engine);
bf16 cast points mirror the JAX engine's: projections accumulate in f32
and cast back, ``q * scale`` comes after that cast, pooled means are f32
and then cast.
"""
from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops import patches as patch_ops
from ..ops.flash_attention import flash_attention, flash_attention_prefix
from ..ops.normalization import imagenet_normalize
from ..ops.pos_embed import sinusoid_encoding_table
from .layers import dense_attention, layer_norm
from .vmae import PretrainVisionTransformer, mask_order


class FastParams(NamedTuple):
    """VMAE weights re-laid-out for the engine (see stack_vmae_params).
    Kernels are [in, out] like the JAX engine's; block parameters are
    nested dicts of tensors stacked on a leading layer axis."""
    patch_kernel: Any
    patch_bias: Any
    enc_blocks: Any
    enc_norm: Any
    e2d_kernel: Any
    mask_token: Any
    dec_blocks: Any
    dec_norm: Any
    head_kernel: Any
    head_bias: Any


def _block_params(sd, prefix: str) -> Dict:
    """One block of a reference-layout state dict -> the engine's dict."""
    def lin(name):
        return {'kernel': sd[f'{prefix}.{name}.weight'].t(),
                'bias': sd[f'{prefix}.{name}.bias']}

    def ln(name):
        return {'scale': sd[f'{prefix}.{name}.weight'],
                'bias': sd[f'{prefix}.{name}.bias']}

    attn = {'qkv_kernel': sd[f'{prefix}.attn.qkv.weight'].t(),
            'proj': lin('attn.proj')}
    for b in ('q_bias', 'v_bias'):
        if f'{prefix}.attn.{b}' in sd:
            attn[b] = sd[f'{prefix}.attn.{b}']
    p = {'norm1': ln('norm1'), 'norm2': ln('norm2'), 'attn': attn,
         'mlp': {'fc1': lin('mlp.fc1'), 'fc2': lin('mlp.fc2')}}
    for g in ('gamma_1', 'gamma_2'):
        if f'{prefix}.{g}' in sd:
            p[g] = sd[f'{prefix}.{g}']
    return p


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer(stacked, i: int):
    return _tree_map(lambda t: t[i], stacked)


def stack_vmae_params(model: PretrainVisionTransformer, state_dict,
                      dtype=None, device='cuda') -> FastParams:
    """Re-lay-out a reference-layout VMAE state dict (utils/weights.py) for
    the engine: block parameters stacked on a leading layer axis, kernels
    [in, out], everything cast to the compute dtype on ``device``."""
    if model.qk_scale is not None:
        raise ValueError(
            'the shared-prefix engine hardcodes the default attention scale '
            'head_dim**-0.5; qk_scale overrides are only supported by the '
            'exact path. No released CWM checkpoint sets qk_scale.')
    if model.use_learnable_pos_emb:
        raise ValueError(
            'the shared-prefix engine adds the fixed sinusoid positional '
            'table; a model with use_learnable_pos_emb=True would silently '
            'diverge. No released CWM checkpoint uses them.')
    dtype = dtype or model.dtype
    device = resolve_device(device)
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}

    def cast(tree):
        return _tree_map(
            lambda t: t.to(device=device, dtype=dtype).contiguous(), tree)

    def stack(prefix, depth):
        blocks = [_block_params(sd, f'{prefix}.{i}') for i in range(depth)]
        return _tree_map(lambda *xs: torch.stack(xs, 0), *blocks)

    w = sd['encoder.patch_embed.proj.weight']      # [E, C, pt, ph, pw]
    patch_kernel = w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0])
    return FastParams(
        patch_kernel=cast(patch_kernel),
        patch_bias=cast(sd['encoder.patch_embed.proj.bias']),
        enc_blocks=cast(stack('encoder.blocks', model.encoder_depth)),
        enc_norm=cast({'scale': sd['encoder.norm.weight'],
                       'bias': sd['encoder.norm.bias']}),
        e2d_kernel=cast(sd['encoder_to_decoder.weight'].t()),
        mask_token=cast(sd['mask_token']),
        dec_blocks=cast(stack('decoder.blocks', model.decoder_depth)),
        dec_norm=cast({'scale': sd['decoder.norm.weight'],
                       'bias': sd['decoder.norm.bias']}),
        head_kernel=cast(sd['decoder.head.weight'].t()),
        head_bias=cast(sd['decoder.head.bias']),
    )


def _ln(x, p, eps=1e-6):
    return layer_norm(x, p['scale'], p['bias'], eps)


def _qkv(p_attn, h, num_heads: int):
    """h [B, N, D] -> q, k, v [B, H, N, d] contiguous (q unscaled)."""
    b, n, _ = h.shape
    qkv = torch.matmul(h, p_attn['qkv_kernel']).to(h.dtype)
    if 'q_bias' in p_attn:
        q_bias = p_attn['q_bias']
        qkv = qkv + torch.stack([q_bias, torch.zeros_like(q_bias),
                                 p_attn['v_bias']]).reshape(-1)
    a = qkv.shape[-1] // 3
    qkv = qkv.reshape(b, n, 3, num_heads, a // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    return q, k, v


def _proj(p_attn, out, b, n):
    a = out.shape[1] * out.shape[3]
    out = out.transpose(1, 2).reshape(b, n, a)
    return (torch.matmul(out, p_attn['proj']['kernel']).to(out.dtype)
            + p_attn['proj']['bias'])


def _mlp(p_mlp, x, gelu: str = 'erf'):
    h = (torch.matmul(x, p_mlp['fc1']['kernel']).to(x.dtype)
         + p_mlp['fc1']['bias'])
    # 'erf' is the reference's exact nn.GELU; 'tanh' the cheap approximation
    h = F.gelu(h, approximate='tanh' if gelu == 'tanh' else 'none')
    return (torch.matmul(h, p_mlp['fc2']['kernel']).to(h.dtype)
            + p_mlp['fc2']['bias'])


def resolve_gelu(gelu: Optional[str] = None) -> str:
    """None reads CWM_FAST_GELU ('erf' default = reference-exact)."""
    if gelu is None:
        gelu = os.environ.get('CWM_FAST_GELU', 'erf')
    if gelu not in ('erf', 'tanh'):
        raise ValueError(f'gelu must be "erf" or "tanh", got {gelu!r}')
    return gelu


# Minimum frame-1 grid edge for each 'auto' pooling rung (the JAX engine's
# calibration): ViT-L 4x4 @224 (grid 56) -> pool 4; ViT-B 8x8 @224
# (grid 28) -> pool 2; test-scale grids (<=16) stay exact.
_AUTO_POOL_MIN_GRID = {4: 32, 2: 24}


def resolve_pools(gh: int, gw: int, prefix_pool='auto', suffix_pool='auto',
                  gelu='auto'):
    """'auto' picks the largest pooling rung in {4, 2, 1} the (gh, gw)
    frame-1 token grid supports and pairs it with the tanh gelu when any
    pooling is engaged, the exact erf when none is. Integers and
    'erf'/'tanh' pass through. Returns (prefix_pool, suffix_pool, gelu)."""
    def auto_pool():
        for p in (4, 2):
            if (gh % p == 0 and gw % p == 0
                    and min(gh, gw) >= _AUTO_POOL_MIN_GRID[p]):
                return p
        return 1

    pp = auto_pool() if prefix_pool in (None, 'auto') else int(prefix_pool)
    sp = auto_pool() if suffix_pool in (None, 'auto') else int(suffix_pool)
    if gelu is None:
        gelu = os.environ.get('CWM_FAST_GELU', 'auto')
    if gelu == 'auto':
        gelu = 'tanh' if max(pp, sp) > 1 else 'erf'
    if gelu not in ('erf', 'tanh') or pp < 1 or sp < 1:
        raise ValueError(f'bad rung: pools {(pp, sp)}, gelu {gelu!r}')
    return pp, sp, gelu


def sfx_bucket(n_sfx: int, n1: int) -> int:
    """Bucketed per-sample visible-frame-1 width: 4, 8, 16, then widening
    midpoints (24, 32, 40, 48, 64, 96, ...), capped at n1; 0 stays 0. Pad
    slots carry the sentinel index n1, which the engine masks out of
    attention and drops at the scatter, so bucketing is numerics-neutral.
    CWM_SFX_BUCKET=0 disables it."""
    if n_sfx <= 0:
        return 0
    if os.environ.get('CWM_SFX_BUCKET', '1') == '0':
        return n_sfx
    for b in (4, 8, 16, 24, 32, 40, 48, 64, 96, 128, 192, 256, 384, 512,
              768, 1024, 1536, 2048, 3072, 4096):
        if b >= n_sfx or b >= n1:
            return min(b, n1)
    return n1


def pad_vis1_idx(mask1, n_sfx_pad: int):
    """Visible-first frame-1 indices padded to a bucket width.

    mask1: bool [S, N1] (True = masked). Returns int64 [S, n_sfx_pad]: each
    row's visible indices first (original order), then the sentinel N1."""
    n1 = mask1.shape[-1]
    vis_counts = (~mask1).sum(-1)
    order = mask_order(mask1)[:, :n_sfx_pad]
    col = torch.arange(n_sfx_pad, device=mask1.device)[None]
    return torch.where(col < vis_counts[:, None], order,
                       torch.full_like(order, n1))


def _dense_attention(q, k, v):
    return dense_attention(q, k, v, dtype=v.dtype)


def _dense_attention_prefix(q, k0, v0, k1, v1, weight0: float = 1.0,
                            weight1: float = 1.0, own_valid=None):
    """Two-source dense attention without materializing broadcast+concat
    K/V: softmax over [prefix scores ; own scores], f32. q [S, H, Nq, d];
    k0/v0 [S0, H, N0, d] with S0 in {1, S}; k1/v1 [S, H, N1, d].

    weight0/weight1: key multiplicity of each panel. own_valid: optional
    bool [S, N1]; False marks pad keys of the own panel (sfx_bucket), which
    score -inf, so a row with no valid own key falls back to prefix-only
    attention. A zero-width own panel is single-source attention over the
    prefix."""
    qf = q.float()
    sub0 = 'hkd' if k0.shape[0] == 1 else 'shkd'
    k0f = (k0[0] if k0.shape[0] == 1 else k0).float()
    v0f = (v0[0] if v0.shape[0] == 1 else v0).float()
    s0 = torch.einsum(f'shqd,{sub0}->shqk', qf, k0f)
    if k1.shape[2] == 0:
        p0 = torch.softmax(s0, dim=-1)
        o = torch.einsum(f'shqk,{sub0}->shqd', p0, v0f)
        return o.to(v1.dtype)
    s1 = torch.einsum('shqd,shkd->shqk', qf, k1.float())
    if weight0 != 1.0:
        s0 = s0 + float(np.log(weight0))
    if weight1 != 1.0:
        s1 = s1 + float(np.log(weight1))
    if own_valid is not None:
        s1 = s1.masked_fill(~own_valid[:, None, None, :], float('-inf'))
    m = torch.maximum(s0.amax(-1, keepdim=True), s1.amax(-1, keepdim=True))
    p0 = torch.exp(s0 - m)
    p1 = torch.exp(s1 - m)
    l = p0.sum(-1, keepdim=True) + p1.sum(-1, keepdim=True)
    o = torch.einsum(f'shqk,{sub0}->shqd', p0, v0f)
    o = o + torch.einsum('shqk,shkd->shqd', p1, v1.float())
    return (o / l).to(v1.dtype)


def prefix_block_one(p, h, num_heads: int, use_flash: bool):
    """One pre-norm ViT block over prefix tokens; returns (h, (k, v))."""
    scale = (h.shape[-1] // num_heads) ** -0.5
    b, n, _ = h.shape
    ln = _ln(h, p['norm1'])
    q, k, v = _qkv(p['attn'], ln, num_heads)
    if use_flash:
        o = flash_attention(q * scale, k, v)
    else:
        o = _dense_attention(q * scale, k, v)
    o = _proj(p['attn'], o, b, n)
    if 'gamma_1' in p:
        o = p['gamma_1'] * o
    h = h + o
    m = _mlp(p['mlp'], _ln(h, p['norm2']))
    if 'gamma_2' in p:
        m = p['gamma_2'] * m
    return h + m, (k, v)


def _pool_kv_grid(x, pool: int, grid):
    """Average-pool per-sample K/V [S, H, N, d] pool x pool over the
    (gh, gw) token grid (N = gh*gw row-major); f32 mean, then cast."""
    gh, gw = grid
    s, h, n, d = x.shape
    p = x.reshape(s, h, gh // pool, pool, gw // pool, pool, d)
    p = p.float().mean(dim=(3, 5))
    return p.reshape(s, h, (gh // pool) * (gw // pool), d).to(x.dtype)


def suffix_block_one(p, kv0, h, num_heads: int, use_flash: bool,
                     two_source: bool, prefix_weight: float = 1.0,
                     suffix_pool: int = 1, grid=None, gelu: str = 'erf',
                     key_valid=None):
    """One pre-norm ViT block: per-sample tokens attend [cached prefix kv0 ;
    own kv].

    prefix_weight: key multiplicity of the prefix panel (pooled prefix).
    suffix_pool: >1 pools the per-sample keys/values pool x pool over the
    token ``grid`` and weights them pool^2-fold (queries stay full-res).
    key_valid: optional bool [S, N] pad-key mask (sfx_bucket); it forces
    the dense two-source attention and cannot be combined with pooling."""
    scale = (h.shape[-1] // num_heads) ** -0.5
    s, n, _ = h.shape
    k0, v0 = kv0
    ln = _ln(h, p['norm1'])
    q, k, v = _qkv(p['attn'], ln, num_heads)
    suffix_weight = 1.0
    if suffix_pool > 1:
        if key_valid is not None:
            raise ValueError('bucketed pad keys cannot be pooled')
        k = _pool_kv_grid(k, suffix_pool, grid)
        v = _pool_kv_grid(v, suffix_pool, grid)
        suffix_weight = float(suffix_pool * suffix_pool)
    if two_source and use_flash and key_valid is None:
        o = flash_attention_prefix(q * scale, k0, v0, k, v,
                                   prefix_weight=prefix_weight,
                                   suffix_weight=suffix_weight)
    elif (two_source or prefix_weight != 1.0 or suffix_weight != 1.0
          or key_valid is not None):
        o = _dense_attention_prefix(q * scale, k0, v0, k, v,
                                    weight0=prefix_weight,
                                    weight1=suffix_weight,
                                    own_valid=key_valid)
    else:
        kf = torch.cat([k0.expand(s, *k0.shape[1:]), k], dim=2)
        vf = torch.cat([v0.expand(s, *v0.shape[1:]), v], dim=2)
        if use_flash:
            o = flash_attention(q * scale, kf, vf)
        else:
            o = _dense_attention(q * scale, kf, vf)
    o = _proj(p['attn'], o, s, n)
    if 'gamma_1' in p:
        o = p['gamma_1'] * o
    h = h + o
    m = _mlp(p['mlp'], _ln(h, p['norm2']), gelu)
    if 'gamma_2' in p:
        m = p['gamma_2'] * m
    return h + m


def _num_layers(stacked) -> int:
    return stacked['norm1']['scale'].shape[0]


def _prefix_blocks(stacked, h0, num_heads: int, use_flash: bool):
    """Full self-attention over the prefix; returns (h, (k, v)) with the
    per-layer keys/values stacked [L, B, H, N, d]."""
    ks, vs = [], []
    h = h0
    for i in range(_num_layers(stacked)):
        h, (k, v) = prefix_block_one(_layer(stacked, i), h, num_heads,
                                     use_flash)
        ks.append(k)
        vs.append(v)
    return h, (torch.stack(ks), torch.stack(vs))


def resolve_two_source(use_flash: bool, two_source=None) -> bool:
    """``None`` reads CWM_FLASH_TWO_SOURCE (default on)."""
    if two_source is None:
        two_source = os.environ.get('CWM_FLASH_TWO_SOURCE', '1') != '0'
    return bool(use_flash and two_source)


def _suffix_blocks(stacked, kvs, hs, num_heads: int, use_flash: bool,
                   two_source: bool, prefix_weight: float = 1.0,
                   suffix_pool: int = 1, grid=None, gelu: str = 'erf',
                   key_valid=None):
    """Per-sample tokens attending to [cached prefix kv ; own kv]."""
    k0s, v0s = kvs
    for i in range(_num_layers(stacked)):
        hs = suffix_block_one(_layer(stacked, i), (k0s[i], v0s[i]), hs,
                              num_heads, use_flash, two_source, prefix_weight,
                              suffix_pool, grid, gelu, key_valid)
    return hs


def _pool_panel(panel, pool: int, gh: int, gw: int):
    """Average-pool one [L, S0, H, N0, d] prefix K/V panel pool x pool over
    its (gh, gw) token grid (N0 = t * gh * gw, row-major); f32 mean, then
    cast back to the panel dtype."""
    l, s0, h, n0, d = panel.shape
    t = n0 // (gh * gw)
    p = panel.reshape(l, s0, h, t, gh // pool, pool, gw // pool, pool, d)
    p = p.float().mean(dim=(5, 7))
    return p.reshape(l, s0, h, t * (gh // pool) * (gw // pool),
                     d).to(panel.dtype)


def pool_dec_prefix(dec_kvs, pool: int, gh: int, gw: int):
    """Pooled-prefix mode: shrink the decoder prefix K/V panels pool^2-fold;
    attention then weights each pooled key as pool^2 identical keys."""
    if gh % pool or gw % pool:
        raise ValueError(f'prefix grid {gh}x{gw} not divisible by '
                         f'pool={pool}')
    k0, v0 = dec_kvs
    return (_pool_panel(k0, pool, gh, gw), _pool_panel(v0, pool, gh, gw))


class PrefixCache(NamedTuple):
    """Sample-independent state for one 2-frame scene: per-layer prefix
    (k, v) of the encoder and the decoder, [L, 1, H, N0, d] each."""
    enc_kvs: Any
    dec_kvs: Any


def encode_prefix(model: PretrainVisionTransformer, fp: FastParams,
                  use_flash: bool, x0n) -> PrefixCache:
    """Run the shared frame-0 pass once. x0n: [1, C, H, W] normalized
    frame 0. Returns the per-layer encoder/decoder prefix KV caches."""
    n0 = model.num_patches_per_frame
    dtype = fp.patch_kernel.dtype
    dev = x0n.device

    p0 = patch_ops.patchify(x0n[:, :, None], model.full_patch_size,
                            temporal_dim=2, squeeze_channel_dim=True)
    tokens0 = (torch.matmul(p0.to(dtype), fp.patch_kernel).to(dtype)
               + fp.patch_bias)
    pos_enc = sinusoid_encoding_table(
        model.num_patches, model.encoder_embed_dim, device=dev)[:, :n0]
    tokens0 = tokens0 + pos_enc.to(dtype)

    h0, enc_kvs = _prefix_blocks(fp.enc_blocks, tokens0,
                                 model.encoder_num_heads, use_flash)
    h0 = _ln(h0, fp.enc_norm)

    z0 = torch.matmul(h0, fp.e2d_kernel).to(dtype)
    pos_dec = sinusoid_encoding_table(
        model.num_patches, model.decoder_embed_dim, device=dev).to(dtype)
    z0 = z0 + pos_dec[:, :n0]
    _, dec_kvs = _prefix_blocks(fp.dec_blocks, z0, model.decoder_num_heads,
                                use_flash)
    return PrefixCache(enc_kvs=enc_kvs, dec_kvs=dec_kvs)


def predict_frame1_from_prefix(model: PretrainVisionTransformer,
                               fp: FastParams, use_flash: bool,
                               cache: PrefixCache, x1n, vis1_idx,
                               two_source: Optional[bool] = None,
                               prefix_pool: int = 1, suffix_pool: int = 1,
                               gelu: Optional[str] = None):
    """Per-sample pass: encode the visible frame-1 tokens against the cached
    prefix, decode every frame-1 position. x1n: [S, C, H, W] normalized
    frame 1; vis1_idx: int [S, n_sfx] visible patch indices within frame 1
    (sentinel N1 in pad slots). Returns [S, N1, out_dim]."""
    return _predict_frame1_core(model, fp, use_flash,
                                resolve_two_source(use_flash, two_source),
                                cache, x1n, vis1_idx, int(prefix_pool),
                                int(suffix_pool), resolve_gelu(gelu))


def _predict_frame1_core(model: PretrainVisionTransformer, fp: FastParams,
                         use_flash: bool, two_source: bool,
                         cache: PrefixCache, x1n, vis1_idx,
                         prefix_pool: int = 1, suffix_pool: int = 1,
                         gelu: str = 'erf'):
    n0 = model.num_patches_per_frame
    n1 = model.num_patches - n0
    dtype = fp.patch_kernel.dtype
    dev = x1n.device
    s = x1n.shape[0]
    n_sfx = vis1_idx.shape[1]

    pos_dec = sinusoid_encoding_table(
        model.num_patches, model.decoder_embed_dim, device=dev)[0].to(dtype)
    cd = pos_dec.shape[-1]
    base = (fp.mask_token.to(dtype) + pos_dec[n0:]).expand(s, n1, cd)
    if n_sfx == 0:
        # frame 1 fully masked: no suffix tokens, the decoder rows are pure
        # mask tokens (exact, not an approximation)
        z1 = base
    else:
        # pad slots carry the sentinel n1: gather them at slot 0, mask
        # their keys out of attention, drop them at the scatter
        valid = vis1_idx < n1
        idx_safe = torch.where(valid, vis1_idx, torch.zeros_like(vis1_idx))
        p1 = patch_ops.patchify(x1n[:, :, None], model.full_patch_size,
                                temporal_dim=2, squeeze_channel_dim=True)
        p1v = torch.gather(
            p1, 1, idx_safe[..., None].expand(-1, -1, p1.shape[-1]))
        tok = (torch.matmul(p1v.to(dtype), fp.patch_kernel).to(dtype)
               + fp.patch_bias)
        pos_enc = sinusoid_encoding_table(
            model.num_patches, model.encoder_embed_dim,
            device=dev)[0].to(dtype)
        tok = tok + pos_enc[n0 + idx_safe]

        # encoder suffix: ~n_sfx queries per sample, dense two-source
        hs = _suffix_blocks(fp.enc_blocks, cache.enc_kvs, tok,
                            model.encoder_num_heads, False, True, gelu=gelu,
                            key_valid=valid)
        hs = _ln(hs, fp.enc_norm)
        zs = torch.matmul(hs, fp.e2d_kernel).to(dtype)

        # decoder frame-1 rows: mask tokens everywhere, encoded tokens at the
        # visible slots; the scatter goes into an [n1 + 1]-row buffer whose
        # last (sentinel) row takes the pad slots and is dropped
        vals = zs + pos_dec[n0 + idx_safe]
        buf = torch.cat([base, base.new_zeros(s, 1, cd)], dim=1)
        buf.scatter_(1, vis1_idx[..., None].expand(-1, -1, cd), vals)
        z1 = buf[:, :n1]

    dec_kvs, pw = cache.dec_kvs, 1.0
    ph, pw_ = model.full_patch_size[-2:]
    gh, gw = x1n.shape[-2] // ph, x1n.shape[-1] // pw_
    if prefix_pool > 1:
        dec_kvs = pool_dec_prefix(dec_kvs, prefix_pool, gh, gw)
        pw = float(prefix_pool * prefix_pool)
    y1 = _suffix_blocks(fp.dec_blocks, dec_kvs, z1, model.decoder_num_heads,
                        use_flash, two_source, pw, suffix_pool, (gh, gw),
                        gelu)
    y1 = _ln(y1, fp.dec_norm)
    return torch.matmul(y1, fp.head_kernel).to(dtype) + fp.head_bias


def stack_prefix_caches(caches) -> PrefixCache:
    """Stack the caches of S different scenes into ONE cache whose batch
    dim is S (the multi-scene warm path): each sample's suffix then attends
    its own scene's prefix, and the two-source kernel reads the per-sample
    panels in place (flash_attention_prefix with s0 = S)."""
    caches = list(caches)
    if len(caches) == 1:
        return caches[0]
    return PrefixCache(*(tuple(torch.cat(parts, dim=1)
                               for parts in zip(*kvs))
                         for kvs in zip(*caches)))


def make_prefix_cache(model: PretrainVisionTransformer, fp: FastParams,
                      use_flash: bool, normalize: bool, x0) -> PrefixCache:
    """Build the reusable frame-0 cache for a scene. x0: [1, C, H, W] raw
    frame 0 (same normalization flag as the later prediction calls)."""
    if normalize:
        x0 = imagenet_normalize(x0[:, None], temporal_dim=1)[:, 0]
    return encode_prefix(model, fp, use_flash, x0)


class HashLru:
    """sha1-keyed LRU over tensors; subclasses define ``_build(*tensors)``
    (and optionally ``_key_arrays`` to key on a subset of the inputs). Keys
    cover shape + dtype + bytes, so reinterpreted buffers never collide.
    A key reads its tensors on the host: a tensor on the card is copied
    back first, as the JAX package's ``np.asarray`` does.

    Thread-safe: get() holds an internal lock across lookup AND build, so
    concurrent callers with a cold key cannot build it twice or corrupt
    the eviction order."""

    def __init__(self, size: int = 4):
        self.size = size
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(*arrays):
        hsh = hashlib.sha1()
        for arr in arrays:
            a = torch.as_tensor(arr).detach().cpu().contiguous()
            hsh.update(repr((tuple(a.shape), str(a.dtype))).encode())
            hsh.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
        return hsh.hexdigest()

    def _key_arrays(self, *arrays):
        return arrays

    def get(self, *arrays):
        """-> (entry, hit: bool)."""
        key = self._key(*self._key_arrays(*arrays))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key], True
            entry = self._build(*arrays)
            self._entries[key] = entry
            if len(self._entries) > self.size:
                self._entries.popitem(last=False)
            self.misses += 1
        return entry, False


class PrefixLru(HashLru):
    """LRU of PrefixCache entries keyed on the raw frame 0: repeat prompts
    on one scene (the interactive workload) skip the prefix passes.
    get(x0) with x0 [1, C, H, W] raw frame 0 -> (PrefixCache, hit)."""

    def __init__(self, model: PretrainVisionTransformer, fp: FastParams,
                 use_flash: bool, normalize: bool, size: int = 4):
        super().__init__(size)
        self.model, self.fp = model, fp
        self.use_flash, self.normalize = use_flash, normalize

    def _build(self, x0):
        return make_prefix_cache(self.model, self.fp, self.use_flash,
                                 self.normalize, x0)


def predict_videos_shared_prefix(model: PretrainVisionTransformer,
                                 fp: FastParams, use_flash: bool,
                                 n_vis: int, normalize: bool,
                                 x_mocos, mask_mocos,
                                 cache: Optional[PrefixCache] = None,
                                 two_source: Optional[bool] = None,
                                 prefix_pool: int = 1,
                                 suffix_pool: int = 1,
                                 gelu: Optional[str] = None):
    """See _predict_videos_core. Also verifies that no frame-0 patch is
    masked: the shared-prefix engine requires frame 0 fully visible."""
    n0 = model.num_patches_per_frame
    n1 = model.num_patches - n0
    if bool(mask_mocos[..., :n0].any()):
        raise ValueError(
            'predict_videos_shared_prefix: mask touches frame 0; the '
            'shared-prefix engine requires frame 0 fully visible — use '
            'the exact path for such prompts')
    if n_vis < n0:
        raise ValueError(
            f'n_vis={n_vis} < num_patches_per_frame={n0}: the shared-prefix '
            'engine requires frame 0 fully visible in every prompt (the '
            'fix_passive construction)')
    return _predict_videos_core(model, fp, use_flash,
                                resolve_two_source(use_flash, two_source),
                                sfx_bucket(n_vis - n0, n1), normalize,
                                x_mocos, mask_mocos, cache,
                                int(prefix_pool), int(suffix_pool),
                                resolve_gelu(gelu))


def _predict_videos_core(model: PretrainVisionTransformer, fp: FastParams,
                         use_flash: bool, two_source: bool, n_sfx_pad: int,
                         normalize: bool, x_mocos, mask_mocos,
                         cache: Optional[PrefixCache] = None,
                         prefix_pool: int = 1, suffix_pool: int = 1,
                         gelu: str = 'erf'):
    """Fast path of video prediction on the counterfactual workload:
    x_mocos [S, T, C, H, W] share frame 0 (only sample 0's is read), frame
    0 fully visible, per-sample visibility in frame 1 only; n_sfx_pad is
    the bucketed suffix width (each row's visible count must be <= it).

    Returns [S, T, C, H, W]: input patches at visible positions,
    predictions at masked ones. cache: optional make_prefix_cache(...) of
    this scene's frame 0, which skips the prefix passes."""
    s, t, c, h, w = x_mocos.shape
    n0 = model.num_patches_per_frame

    xm = imagenet_normalize(x_mocos, temporal_dim=1) if normalize else x_mocos
    if cache is None:
        cache = encode_prefix(model, fp, use_flash, xm[0:1, 0])

    mask1 = mask_mocos[:, n0:]
    vis1_idx = pad_vis1_idx(mask1, n_sfx_pad)
    y1 = _predict_frame1_core(model, fp, use_flash, two_source, cache,
                              xm[:, 1], vis1_idx, prefix_pool, suffix_pool,
                              gelu)

    raw1 = patch_ops.patchify(x_mocos[:, 1:2], model.full_patch_size,
                              temporal_dim=1)
    full1 = torch.where(mask1[..., None], y1.to(raw1.dtype), raw1)
    frame1 = patch_ops.unpatchify(full1, model.full_patch_size,
                                  (s, 1, c, h, w), temporal_dim=1)
    return torch.cat([x_mocos[:, 0:1], frame1], dim=1)
