"""Shared-prefix counterfactual engine for the conjoined (IMU-conditioned)
predictor.

Port of counterfactualworldmodels_tpu/models/fast_conjoined.py. The
movability workload runs one scene through the IMU-conditioned predictor
S times, varying only a frame-1 motion prompt; frame 0 is fully visible
and the IMU context (a few dozen tokens) is the same in every sample. The
engine extends the prefix-isolated factorization of models/fast_vmae.py
across the cross-attention coupling:

* the frame-0 (prefix) main tokens run ONCE per (scene, IMU) pair, coupled
  to a scene-level context stream, recording every main block's K/V and,
  at each cross block, the prefix rows' context-direction keys/values;
* per sample, the visible frame-1 (suffix) tokens attend [cached prefix ;
  own] in the main blocks, and the context stream is RECOMPUTED EXACTLY
  per sample: at each cross block it attends over [cached prefix keys ;
  suffix keys] and the suffix tokens read it.

The deviation from the exact model is the frozen main prefix only, as in
the plain engine. The main blocks are fast_vmae's ``prefix_block_one`` /
``suffix_block_one`` (one block body for both engines, each handing its
MLP output pending to the next norm, a cross block's norm1_cross
included): K1 runs the prefix blocks, K2 the suffix encoder blocks (the
bucketing pads masked by own-key lengths) and the suffix decoder blocks
(the exact rung: no pooling), each on the card or as its plain version by
the tensors' device (ops/flash_attention), and the tiny context stream
runs K1's plain version, ``dense_attention``, on every device, as in the
JAX engine.

The engine reads its weights from ``cast_params``: the reference-layout
state dict re-laid-out (kernels [in, out], blocks as fast_vmae's dicts) and
cast once to the compute dtype, which then rides every product.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops import patches as patch_ops
from ..ops.flash_attention import dense_attention
from ..ops.normalization import imagenet_normalize
from ..ops.pos_embed import sinusoid_encoding_table
from ..utils import profiling
from .conjoined import ConjoinedVMAE
from .fast_vmae import (HashLru, _add_ln, _block_params, _ln, pad_vis1_idx,
                        prefix_block_one, sfx_bucket, suffix_block_one)


def conjoined_fast_supported(model: ConjoinedVMAE) -> bool:
    """The engine's preconditions on the MODEL (the prompt-shape gate is
    the caller's): an IMU context, a 2-frame / 1-tubelet main stream, cross
    blocks without self-attention or a shared similarity (every released
    conjoined checkpoint), and no visible null tokens (min_padding_tokens
    0: the engine never builds them)."""
    return (model.context.is_imu
            and not model.with_self_attention
            and not model.shared_similarity
            and model.main.num_frames == 2
            and model.main.tubelet_size == 1
            and model.main.min_padding_tokens == 0
            and model.context.min_padding_tokens == 0)


def _lin(sd, prefix, bias=True):
    p = {'kernel': sd[prefix + '.weight'].t()}
    if bias:
        p['bias'] = sd[prefix + '.bias']
    return p


def _norm(sd, prefix):
    return {'scale': sd[prefix + '.weight'], 'bias': sd[prefix + '.bias']}


def _cross_params(sd, prefix):
    ca = prefix + '.cross_attention'
    p = {'norm1_cross': _norm(sd, prefix + '.norm1_cross'),
         'norm1_src_cross': _norm(sd, prefix + '.norm1_src_cross'),
         'qk': _lin(sd, ca + '.qk', False)['kernel'],
         'qk_src': _lin(sd, ca + '.qk_src', False)['kernel'],
         'v': _lin(sd, ca + '.v', False)['kernel'],
         'v_src': _lin(sd, ca + '.v_src', False)['kernel'],
         'projection': _lin(sd, ca + '.projection'),
         'projection_src': _lin(sd, ca + '.projection_src'),
         'norm2': _norm(sd, prefix + '.norm2'),
         'norm2_src': _norm(sd, prefix + '.norm2_src'),
         'mlp_trg': [_lin(sd, f'{prefix}.mlp.trg.layers.{i}') for i in (0, 2)],
         'mlp_src': [_lin(sd, f'{prefix}.mlp.src.layers.{i}') for i in (0, 2)]}
    for g in ('gamma_1_cross', 'gamma_1_src_cross', 'gamma_2', 'gamma_2_src'):
        if f'{prefix}.{g}' in sd:
            p[g] = sd[f'{prefix}.{g}']
    return p


def cast_params(model: ConjoinedVMAE, state_dict, dtype=None,
                device=None) -> Dict[str, Any]:
    """The engine's weights: a reference-layout conjoined state dict
    re-laid-out (kernels [in, out]; blocks as fast_vmae's dicts) and cast
    ONCE to the compute dtype (default the model's) on ``device`` (default
    the model's). The engine reads its compute dtype off these tensors."""
    if not conjoined_fast_supported(model):
        raise ValueError('the conjoined shared-prefix engine does not '
                         'support this model (conjoined_fast_supported)')
    dtype = dtype or model.dtype
    device = torch.device(device) if device is not None else model.device
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    m, c = model.main, model.context

    def blocks(prefix, depth):
        return [_block_params(sd, f'{prefix}.{i}') for i in range(depth)]

    w = sd['main_stream.encoder.patch_embed.proj.weight']  # [E,C,pt,ph,pw]
    wc = sd['context_stream.encoder.patch_embed.proj.weight'][..., 0, 0]
    tree = {
        'main_encoder': {
            'proj': {'kernel': w.permute(2, 3, 4, 1, 0).reshape(-1,
                                                                w.shape[0]),
                     'bias': sd['main_stream.encoder.patch_embed.proj.bias']},
            'blocks': blocks('main_stream.encoder.blocks', m.encoder_depth),
            'norm': _norm(sd, 'main_stream.encoder.norm')},
        'context_encoder': {
            # [E, C, pt] -> the [(pt c), E] kernel of (pt, c)-ordered patches
            'proj': {'kernel': wc.permute(2, 1, 0).reshape(-1, wc.shape[0]),
                     'bias': sd[
                         'context_stream.encoder.patch_embed.proj.bias']},
            'blocks': blocks('context_stream.encoder.blocks',
                             c.encoder_depth),
            'norm': _norm(sd, 'context_stream.encoder.norm')},
        'main_decoder': {
            'blocks': blocks('main_stream.decoder.blocks', m.decoder_depth),
            'norm': _norm(sd, 'main_stream.decoder.norm'),
            'head': _lin(sd, 'main_stream.decoder.head')},
        'context_decoder': {
            'blocks': blocks('context_stream.decoder.blocks',
                             c.decoder_depth)},
        'main_e2d': sd['main_stream.encoder_to_decoder.weight'].t(),
        'context_e2d': sd['context_stream.encoder_to_decoder.weight'].t(),
        'main_mask_token': sd['main_stream.mask_token'],
        'context_mask_token': sd['context_stream.mask_token'],
        'encoder_cross': [
            _cross_params(sd, f'encoder_conjoining_blocks.{i}-{j}')
            for i, j in model.enc_pairs],
        'decoder_cross': [
            _cross_params(sd, f'decoder_conjoining_blocks.{i}-{j}')
            for i, j in model.dec_pairs],
    }
    if c.concat_dummy_token:
        tree['context_encoder']['dummy_token'] = sd[
            'context_stream.encoder.dummy_token']
    for name in ('main', 'context'):
        if f'{name}_stream.null_token_dec' in sd:
            tree[f'{name}_null_dec'] = sd[f'{name}_stream.null_token_dec']

    def cast(t):
        return t.to(device=device, dtype=dtype).contiguous()

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return cast(node)

    return walk(tree)


# ---------------------------------------------------------------------------
# Single-block primitives
# ---------------------------------------------------------------------------

def _dense_b(p, x):
    return torch.matmul(x, p['kernel']).to(x.dtype) + p['bias']


def _gmlp(p, x):
    """GenericMlp: layers.0 -> exact gelu -> layers.2."""
    return _dense_b(p[1], F.gelu(_dense_b(p[0], x), approximate='none'))


def _g(pc, name):
    return pc[name] if name in pc else 1.0


def _proj_heads(z, kernel, num_heads: int, width: int):
    """[B, N, D] @ kernel -> [B, H, N, width]."""
    out = torch.matmul(z, kernel).to(z.dtype)
    return out.reshape(z.shape[0], z.shape[1], num_heads, width).transpose(1,
                                                                           2)


def _cross_dims(pc, num_heads: int):
    inner = pc['qk'].shape[1] // 2
    d = inner // num_heads
    return inner, d, d ** -0.5


def _attend(attn, v, spec):
    """attn probabilities in v's dtype, f32 product (cast by the caller)."""
    return torch.einsum(spec, attn.to(v.dtype).float(), v.float())


def _merge(y, b, n, inner):
    return y.transpose(1, 2).reshape(b, n, inner)


def _cross_full(pc, x, src, num_heads: int, r=None):
    """The bidirectional cross block (no self-attention) over prefix main
    tokens x + r (r: the main block's pending MLP output, or None) and the
    scene-level context stream. Returns (x, src, (k_pre, v_pre)): the
    prefix rows' context-direction keys/values, cached so a per-sample
    context can attend the full key set later."""
    inner, d, scale = _cross_dims(pc, num_heads)
    b, n, _ = x.shape
    m = src.shape[1]
    x, lx = _add_ln(x, r, pc['norm1_cross'])
    ls = _ln(src, pc['norm1_src_cross'])
    qk_x = _proj_heads(lx, pc['qk'], num_heads, 2 * d)
    qk_s = _proj_heads(ls, pc['qk_src'], num_heads, 2 * d)
    v_x = _proj_heads(lx, pc['v'], num_heads, d)
    v_s = _proj_heads(ls, pc['v_src'], num_heads, d)

    # main <- context (the scale rides the main-side queries)
    attn = torch.softmax(torch.einsum(
        'bhnd,bhmd->bhnm', (qk_x[..., :d] * scale).float(),
        qk_s[..., :d].float()), -1)
    y = _attend(attn, v_s, 'bhnm,bhmd->bhnd').to(v_s.dtype)
    y = _dense_b(pc['projection'], _merge(y, b, n, inner))
    # context <- main, frozen to the prefix keys
    attn_src = torch.softmax(torch.einsum(
        'bhnd,bhmd->bhmn', (qk_x[..., d:] * scale).float(),
        qk_s[..., d:].float()), -1)
    y_src = _attend(attn_src, v_x, 'bhmn,bhnd->bhmd').to(v_x.dtype)
    y_src = _dense_b(pc['projection_src'], _merge(y_src, b, m, inner))

    x = x + _g(pc, 'gamma_1_cross') * y
    x = x + _g(pc, 'gamma_2') * _gmlp(pc['mlp_trg'], _ln(x, pc['norm2']))
    src = src + _g(pc, 'gamma_1_src_cross') * y_src
    src = src + _g(pc, 'gamma_2_src') * _gmlp(pc['mlp_src'],
                                              _ln(src, pc['norm2_src']))
    return x, src, (qk_x[..., d:].contiguous(), v_x.contiguous())


def _cross_suffix(pc, h, src, ckv, num_heads: int, suffix_valid=None,
                  r=None):
    """The cross block for the per-sample suffix: suffix main tokens h + r
    (r pending, as in _cross_full) read the PER-SAMPLE context, and the
    context attends the full main key set, the cached prefix (k_pre,
    v_pre) [1 or S, H, N0, d] from _cross_full and the suffix's own keys.
    suffix_valid: optional bool [S, n]; False
    marks bucketing pad rows of h, whose keys score -inf in the
    context <- main softmax (a context row always keeps the prefix keys,
    so no row is left without one)."""
    inner, d, scale = _cross_dims(pc, num_heads)
    s, n, _ = h.shape
    m = src.shape[1]
    k_pre, v_pre = ckv
    h, lh = _add_ln(h, r, pc['norm1_cross'])
    ls = _ln(src, pc['norm1_src_cross'])
    qk_x = _proj_heads(lh, pc['qk'], num_heads, 2 * d)
    qk_s = _proj_heads(ls, pc['qk_src'], num_heads, 2 * d)
    v_x = _proj_heads(lh, pc['v'], num_heads, d)
    v_s = _proj_heads(ls, pc['v_src'], num_heads, d)

    # main (suffix) <- per-sample context: exact
    attn = torch.softmax(torch.einsum(
        'shnd,shmd->shnm', (qk_x[..., :d] * scale).float(),
        qk_s[..., :d].float()), -1)
    y = _attend(attn, v_s, 'shnm,shmd->shnd').to(v_s.dtype)
    y = _dense_b(pc['projection'], _merge(y, s, n, inner))

    # context <- main over [cached prefix ; own suffix] keys; the scale
    # rides the main-side keys here, so the queries are pre-scaled
    q_s = (qk_s[..., d:] * scale).float()
    pre = 'hkd' if k_pre.shape[0] == 1 else 'shkd'
    k0 = k_pre[0] if k_pre.shape[0] == 1 else k_pre
    v0 = v_pre[0] if v_pre.shape[0] == 1 else v_pre
    sim_pre = torch.einsum(f'shmd,{pre}->shmk', q_s, k0.float())
    sim_sfx = torch.einsum('shmd,shnd->shmn', q_s, qk_x[..., d:].float())
    if suffix_valid is not None:
        sim_sfx = sim_sfx.masked_fill(~suffix_valid[:, None, None, :],
                                      float('-inf'))
    attn_src = torch.softmax(torch.cat([sim_pre, sim_sfx], -1), -1)
    n_pre = k_pre.shape[2]
    y_src = (_attend(attn_src[..., :n_pre], v0, f'shmk,{pre}->shmd')
             + _attend(attn_src[..., n_pre:], v_x, 'shmn,shnd->shmd')
             ).to(v_x.dtype)
    y_src = _dense_b(pc['projection_src'], _merge(y_src, s, m, inner))

    h = h + _g(pc, 'gamma_1_cross') * y
    h = h + _g(pc, 'gamma_2') * _gmlp(pc['mlp_trg'], _ln(h, pc['norm2']))
    src = src + _g(pc, 'gamma_1_src_cross') * y_src
    src = src + _g(pc, 'gamma_2_src') * _gmlp(pc['mlp_src'],
                                              _ln(src, pc['norm2_src']))
    return h, src


# ---------------------------------------------------------------------------
# Prefix pass
# ---------------------------------------------------------------------------

class ConjoinedPrefixCache(NamedTuple):
    """Sample-independent state of one (scene frame 0, IMU context) pair."""
    ctx_tokens: Any     # [1, M, E] initial context tokens (embed + pos)
    enc_kvs: Any        # per main encoder block (k, v), application order
    enc_cross_kv: Any   # per encoder cross block prefix (k_pre, v_pre)
    dec_kvs: Any        # per main decoder block (k, v)
    dec_cross_kv: Any   # per decoder cross block prefix (k_pre, v_pre)


def _ctx_tokens(model: ConjoinedVMAE, params, x_c):
    """The IMU context tokens, all visible (ImuEncoder.tokenize with the
    dummy token appended). x_c: [B, C, L] raw IMU."""
    c = model.context
    ce = params['context_encoder']
    b = x_c.shape[0]
    if c.concat_dummy_token:
        dummy = ce['dummy_token'][:, :, :, 0, 0].to(x_c.dtype)
        x_c = torch.cat([x_c, dummy.expand(b, -1, -1)], dim=2)
    _, ch, l = x_c.shape
    t = l // c.imu_tubelet
    patches = x_c.reshape(b, ch, t, c.imu_tubelet).movedim(1, -1)
    tok = _dense_b(ce['proj'],
                   patches.reshape(b, t, -1).to(ce['proj']['kernel'].dtype))
    pos = sinusoid_encoding_table(t, c.encoder_embed_dim, device=x_c.device)
    return tok + pos.to(tok.dtype)


def _ctx_block(p, z, heads):
    z, r, _ = prefix_block_one(p, z, heads, attention=dense_attention)
    return z + r


def _ctx_dec_tokens(model, params, ctx, dtype):
    """The context decoder's rows: the encoded context projected, with the
    positions, then the masked null-padding rows."""
    c = model.context
    zc = torch.matmul(ctx, params['context_e2d']).to(dtype)
    zc = zc + sinusoid_encoding_table(c.total_tokens, c.decoder_embed_dim,
                                      device=ctx.device).to(dtype)
    if c.padded and c.max_padding_tokens:
        nulls = (params['context_mask_token']
                 + params['context_null_dec']).to(dtype)
        zc = torch.cat([zc, nulls.expand(zc.shape[0], c.max_padding_tokens,
                                         zc.shape[-1])], dim=1)
    return zc


@torch.no_grad()
def encode_conjoined_prefix(model: ConjoinedVMAE, params, x0,
                            x_c) -> ConjoinedPrefixCache:
    """The shared (frame 0 + context) conjoined pass of one scene.

    x0: [1, C, H, W] preprocessed main frame 0; x_c: [1, C, L] raw IMU
    (before the dummy token), all visible. The pass is the span
    ``cf.prefix_build``."""
    with profiling.span('cf.prefix_build'):
        return _encode_prefix(model, params, x0, x_c)


def _encode_prefix(model: ConjoinedVMAE, params, x0,
                   x_c) -> ConjoinedPrefixCache:
    m, c = model.main, model.context
    n0 = m.num_patches // m.num_frames
    enc = params['main_encoder']
    ce = params['context_encoder']
    dtype = enc['proj']['kernel'].dtype
    dev = x0.device

    p0 = patch_ops.patchify(x0[:, :, None], (m.tubelet_size,) + m.patch_size,
                            temporal_dim=2, squeeze_channel_dim=True)
    h = _dense_b(enc['proj'], p0.to(dtype))
    h = h + sinusoid_encoding_table(m.num_patches, m.encoder_embed_dim,
                                    device=dev)[:, :n0].to(dtype)
    ctx0 = _ctx_tokens(model, params, x_c).to(dtype)
    s_ctx = ctx0

    enc_kvs, enc_cross_kv = [], []
    i = j = 0
    r = None
    for idx, (pi, pj) in enumerate(model.enc_pairs):
        while i < pi:
            h, r, kv = prefix_block_one(enc['blocks'][i], h,
                                        m.encoder_num_heads, r)
            enc_kvs.append(kv)
            i += 1
        while j < pj:
            s_ctx = _ctx_block(ce['blocks'][j], s_ctx, c.encoder_num_heads)
            j += 1
        h, s_ctx, ckv = _cross_full(params['encoder_cross'][idx], h, s_ctx,
                                    model.cross_num_heads, r)
        r = None
        enc_cross_kv.append(ckv)
    for k in range(i, m.encoder_depth):
        h, r, kv = prefix_block_one(enc['blocks'][k], h, m.encoder_num_heads,
                                    r)
        enc_kvs.append(kv)
    for k in range(j, c.encoder_depth):
        s_ctx = _ctx_block(ce['blocks'][k], s_ctx, c.encoder_num_heads)
    _, h = _add_ln(h, r, enc['norm'])
    s_ctx = _ln(s_ctx, ce['norm'])

    z0 = torch.matmul(h, params['main_e2d']).to(dtype)
    z0 = z0 + sinusoid_encoding_table(m.num_patches, m.decoder_embed_dim,
                                      device=dev)[:, :n0].to(dtype)
    zc = _ctx_dec_tokens(model, params, s_ctx, dtype)

    dec = params['main_decoder']
    cd = params['context_decoder']
    dec_kvs, dec_cross_kv = [], []
    i = j = 0
    r = None
    for idx, (pi, pj) in enumerate(model.dec_pairs):
        while i <= pi:
            z0, r, kv = prefix_block_one(dec['blocks'][i], z0,
                                         m.decoder_num_heads, r)
            dec_kvs.append(kv)
            i += 1
        while j <= pj:
            zc = _ctx_block(cd['blocks'][j], zc, c.decoder_num_heads)
            j += 1
        z0, zc, ckv = _cross_full(params['decoder_cross'][idx], z0, zc,
                                  model.cross_num_heads, r)
        r = None
        dec_cross_kv.append(ckv)
    for k in range(i, m.decoder_depth):
        z0, r, kv = prefix_block_one(dec['blocks'][k], z0,
                                     m.decoder_num_heads, r)
        dec_kvs.append(kv)
    return ConjoinedPrefixCache(
        ctx_tokens=ctx0, enc_kvs=tuple(enc_kvs),
        enc_cross_kv=tuple(enc_cross_kv), dec_kvs=tuple(dec_kvs),
        dec_cross_kv=tuple(dec_cross_kv))


# ---------------------------------------------------------------------------
# Per-sample suffix pass
# ---------------------------------------------------------------------------

@torch.no_grad()
def predict_frame1_conjoined(model: ConjoinedVMAE, params,
                             cache: ConjoinedPrefixCache, x1n, vis1_idx,
                             key_valid=None):
    """Encode the visible frame-1 tokens against the cached prefix with an
    exact per-sample context stream alongside, then decode every frame-1
    position.

    x1n: [S, C, H, W] normalized frame 1; vis1_idx: int64 [S, n_sfx]
    visible patch indices within frame 1. key_valid: optional bool
    [S, n_sfx]; False marks bucketing pad slots (sentinel index N1,
    fast_vmae.pad_vis1_idx): they gather at 0, their keys are masked out of
    the main self-attention and the context <- main direction, and their
    rows drop at the decoder scatter. Returns [S, N1, out_dim].

    Spans: ``cf.suffix`` > ``cf.suffix.encoder``, ``cf.suffix.decoder``
    (the plain engine's stages), and inside them ``cf.suffix.cross``
    around each cross block and ``cf.suffix.context`` around the
    per-sample context stream's blocks."""
    with profiling.span('cf.suffix'):
        with profiling.span('cf.suffix.encoder'):
            z1, ctx = _suffix_encoder(model, params, cache, x1n, vis1_idx,
                                      key_valid)
        with profiling.span('cf.suffix.decoder'):
            return _suffix_decoder(model, params, cache, z1, ctx)


def _ctx_blocks(blocks, ctx, heads: int, lo: int, hi: int):
    """The per-sample context stream through its blocks [lo, hi)."""
    if lo >= hi:
        return ctx
    with profiling.span('cf.suffix.context'):
        for k in range(lo, hi):
            ctx = _ctx_block(blocks[k], ctx, heads)
    return ctx


def _suffix_encoder(model: ConjoinedVMAE, params,
                    cache: ConjoinedPrefixCache, x1n, vis1_idx, key_valid):
    """The encoder suffix: the visible frame-1 tokens against the cached
    prefix beside the per-sample context stream; its self-attention runs
    on K2 (the pad keys masked by own-key lengths). Returns (the main
    decoder's frame-1 rows and null-padding rows [S, N1 (+ pads), Cd], the
    encoded context [S, M, Ec])."""
    m, c = model.main, model.context
    n0 = m.num_patches // m.num_frames
    n1 = m.num_patches - n0
    enc = params['main_encoder']
    ce = params['context_encoder']
    dtype = enc['proj']['kernel'].dtype
    dev = x1n.device
    s = x1n.shape[0]

    idx_safe = (vis1_idx if key_valid is None
                else torch.where(key_valid, vis1_idx,
                                 torch.zeros_like(vis1_idx)))
    p1 = patch_ops.patchify(x1n[:, :, None], (m.tubelet_size,) + m.patch_size,
                            temporal_dim=2, squeeze_channel_dim=True)
    p1v = torch.gather(p1, 1,
                       idx_safe[..., None].expand(-1, -1, p1.shape[-1]))
    h = _dense_b(enc['proj'], p1v.to(dtype))
    pos_enc = sinusoid_encoding_table(m.num_patches, m.encoder_embed_dim,
                                      device=dev)[0].to(dtype)
    h = h + pos_enc[n0 + idx_safe]
    ctx = cache.ctx_tokens.expand(s, *cache.ctx_tokens.shape[1:])

    # encoder suffix: a few queries per sample, two-source attention
    i = j = 0
    r = None
    for idx, (pi, pj) in enumerate(model.enc_pairs):
        while i < pi:
            h, r = suffix_block_one(enc['blocks'][i], cache.enc_kvs[i], h,
                                    m.encoder_num_heads, key_valid=key_valid,
                                    r=r)
            i += 1
        ctx = _ctx_blocks(ce['blocks'], ctx, c.encoder_num_heads, j, pj)
        j = max(j, pj)
        with profiling.span('cf.suffix.cross'):
            h, ctx = _cross_suffix(params['encoder_cross'][idx], h, ctx,
                                   cache.enc_cross_kv[idx],
                                   model.cross_num_heads,
                                   suffix_valid=key_valid, r=r)
        r = None
    for k in range(i, m.encoder_depth):
        h, r = suffix_block_one(enc['blocks'][k], cache.enc_kvs[k], h,
                                m.encoder_num_heads, key_valid=key_valid,
                                r=r)
    ctx = _ctx_blocks(ce['blocks'], ctx, c.encoder_num_heads, j,
                      c.encoder_depth)
    _, h = _add_ln(h, r, enc['norm'])
    ctx = _ln(ctx, ce['norm'])
    zs = torch.matmul(h, params['main_e2d']).to(dtype)

    # decoder rows: every frame-1 position (mask token + position, the
    # visible slots overwritten with encoded tokens), then the masked
    # null-padding rows. The scatter goes into an [n1 + 1]-row buffer whose
    # last (sentinel) row takes the pad slots and is dropped.
    pos_dec = sinusoid_encoding_table(m.num_patches, m.decoder_embed_dim,
                                      device=dev)[0].to(dtype)
    cd_ = pos_dec.shape[-1]
    mt = params['main_mask_token'].to(dtype)
    base = (mt + pos_dec[n0:]).expand(s, n1, cd_)
    vals = zs + pos_dec[n0 + idx_safe]
    buf = torch.cat([base, base.new_zeros(s, 1, cd_)], dim=1)
    buf.scatter_(1, vis1_idx[..., None].expand(-1, -1, cd_), vals)
    z1 = buf[:, :n1]
    if m.padded and m.max_padding_tokens:
        nulls = mt + params['main_null_dec'].to(dtype)
        z1 = torch.cat([z1, nulls.expand(s, m.max_padding_tokens, cd_)], 1)
    return z1, ctx


def _suffix_decoder(model: ConjoinedVMAE, params,
                    cache: ConjoinedPrefixCache, z1, ctx):
    """Every frame-1 row through the decoder against the cached prefix
    (the exact rung: no pooling) beside the per-sample context decoder;
    the head's output [S, N1, out_dim]."""
    m, c = model.main, model.context
    n1 = m.num_patches - m.num_patches // m.num_frames
    dtype = z1.dtype
    with profiling.span('cf.suffix.context'):
        zc = _ctx_dec_tokens(model, params, ctx, dtype)
    dec = params['main_decoder']
    cd = params['context_decoder']
    i = j = 0
    r = None
    for idx, (pi, pj) in enumerate(model.dec_pairs):
        while i <= pi:
            z1, r = suffix_block_one(dec['blocks'][i], cache.dec_kvs[i], z1,
                                     m.decoder_num_heads, r=r)
            i += 1
        zc = _ctx_blocks(cd['blocks'], zc, c.decoder_num_heads, j, pj + 1)
        j = max(j, pj + 1)
        with profiling.span('cf.suffix.cross'):
            z1, zc = _cross_suffix(params['decoder_cross'][idx], z1, zc,
                                   cache.dec_cross_kv[idx],
                                   model.cross_num_heads, r=r)
        r = None
    for k in range(i, m.decoder_depth):
        z1, r = suffix_block_one(dec['blocks'][k], cache.dec_kvs[k], z1,
                                 m.decoder_num_heads, r=r)
    # LayerNorm is per row: the null-padding rows are normalised and dropped
    y1 = _add_ln(z1, r, dec['norm'])[1][:, :n1]
    return _dense_b(dec['head'], y1)


# ---------------------------------------------------------------------------
# Video-level entry points
# ---------------------------------------------------------------------------

def predict_videos_conjoined_prefix(wrapper, params, x_mocos, mask_mocos,
                                    x_context, mask_context, n_vis: int,
                                    normalize: bool,
                                    cache: Optional[ConjoinedPrefixCache]
                                    = None):
    """The fast path of the IMU-conditioned counterfactual forward:
    x_mocos [S, 2, C, H, W] sharing frame 0, frame 0 fully visible, the IMU
    context [1, C, L] shared and fully visible. Returns [S, 2, C, H, W]:
    input patches at visible positions, predictions at masked ones.

    Raises (one host read each) on a mask touching frame 0, a masked IMU
    context or n_vis below the frame-0 count: the engine does not
    implement them, and the exact path does."""
    m = wrapper.model.main
    n0 = m.num_patches // m.num_frames
    if bool(torch.as_tensor(mask_mocos)[..., :n0].any()):
        raise ValueError(
            'predict_videos_conjoined_prefix: mask touches frame 0; the '
            'conjoined shared-prefix engine requires frame 0 fully visible '
            '— use the exact path (pipelines.imu._conjoined_predict_video)')
    if mask_context is not None and bool(torch.as_tensor(mask_context).any()):
        raise ValueError(
            'predict_videos_conjoined_prefix: mask_context marks IMU tokens '
            'masked, which this engine does not implement (it conditions '
            'on the FULL context) — use the exact path')
    if n_vis < n0:
        raise ValueError(
            f'n_vis={n_vis} < frame-0 patches={n0}: the conjoined '
            'shared-prefix engine requires frame 0 fully visible')
    return _conjoined_videos_core(
        wrapper, params, x_mocos, mask_mocos, x_context, mask_context,
        sfx_bucket(n_vis - n0, m.num_patches - n0), normalize, cache)


@torch.no_grad()
def _conjoined_videos_core(wrapper, params, x_mocos, mask_mocos, x_context,
                           mask_context, n_sfx_pad: int, normalize: bool,
                           cache: Optional[ConjoinedPrefixCache] = None):
    """n_sfx_pad: the bucketed suffix width (fast_vmae.sfx_bucket); each
    row's visible frame-1 count must be at most it."""
    model = wrapper.model
    m = model.main
    s, _, ch, hh, ww = x_mocos.shape
    n0 = m.num_patches // m.num_frames

    with profiling.span('cf.assemble'):
        xm = (imagenet_normalize(x_mocos, temporal_dim=1) if normalize
              else x_mocos)
        (x_m, mask_m), (x_c, _) = wrapper.get_stream_inputs(
            xm.transpose(1, 2), mask_mocos, x_context, mask_context)
        x_c = x_c[..., 0, 0]  # [1 or S, C, L]
        mask1 = mask_m[:, n0:]
        vis1_idx = pad_vis1_idx(mask1, n_sfx_pad)
    if cache is None:
        cache = encode_conjoined_prefix(model, params, x_m[0:1, :, 0], x_c)
    y1 = predict_frame1_conjoined(model, params, cache, x_m[:, :, 1],
                                  vis1_idx,
                                  key_valid=vis1_idx < mask1.shape[-1])
    with profiling.span('cf.assemble'):
        patch = (m.tubelet_size,) + m.patch_size
        raw1 = patch_ops.patchify(x_mocos[:, 1:2], patch, temporal_dim=1)
        full1 = torch.where(mask1[..., None], y1.to(raw1.dtype), raw1)
        frame1 = patch_ops.unpatchify(full1, patch, (s, 1, ch, hh, ww),
                                      temporal_dim=1)
        return torch.cat([x_mocos[:, 0:1], frame1], dim=1)


@torch.no_grad()
def make_conjoined_prefix_cache(wrapper, params, x, x_context,
                                normalize: bool):
    """The prefix cache of one scene. x: [1, 2, C, H, W] raw scene;
    x_context: [1, C, L] raw IMU."""
    model = wrapper.model
    xm = imagenet_normalize(x, temporal_dim=1) if normalize else x
    dev = x.device
    (x_m, _), (x_c, _) = wrapper.get_stream_inputs(
        xm.transpose(1, 2),
        torch.zeros((1, model.main.num_patches), dtype=torch.bool,
                    device=dev),
        x_context,
        torch.zeros((1, model.context.num_patches), dtype=torch.bool,
                    device=dev))
    return encode_conjoined_prefix(model, params, x_m[0:1, :, 0],
                                   x_c[..., 0, 0])


def stack_conjoined_prefix_caches(caches) -> ConjoinedPrefixCache:
    """Stack the caches of S (scene, IMU) pairs into ONE cache of batch S:
    the multi-scene dispatch, where each sample reads its own scene's
    prefix rows (the per-sample routes of _cross_suffix and of
    suffix_block_one, K2 with s0 = S)."""
    caches = list(caches)
    if len(caches) == 1:
        return caches[0]

    def cat(*xs):
        if isinstance(xs[0], (tuple, list)):
            return type(xs[0])(cat(*parts) for parts in zip(*xs))
        return torch.cat(xs, dim=0)

    return ConjoinedPrefixCache(*(cat(*parts) for parts in zip(*caches)))


class ConjoinedPrefixLru(HashLru):
    """LRU of ConjoinedPrefixCache entries keyed on the (frame 0, IMU
    context) pair: a new IMU embedding on the same frame misses.
    get(x, x_context) with x [1, 2, C, H, W] raw scene and x_context
    [1, C, L] raw IMU -> (ConjoinedPrefixCache, hit)."""

    def __init__(self, wrapper, params, normalize: bool, size: int = 4):
        super().__init__(size)
        self.wrapper, self.params = wrapper, params
        self.normalize = normalize

    def _key_arrays(self, x, x_context):
        # the prefix depends on frame 0 and the context, not on frame 1
        return x[0:1, 0], x_context

    def _build(self, x, x_context):
        return make_conjoined_prefix_cache(self.wrapper, self.params, x,
                                           x_context, self.normalize)

