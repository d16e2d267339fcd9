"""Shared-prefix counterfactual engine for the VMAE predictor.

Port of counterfactualworldmodels_tpu/models/fast_vmae.py. The counterfactual
workload runs one 2-frame scene through the predictor S times, varying
only a motion prompt: frame 0 is fully visible and identical across the
samples. Prefix-isolated attention computes frame 0's encoder and decoder
states ONCE (frame-0 queries attend frame-0 keys only) and caches their
per-layer keys/values; per-sample (suffix) tokens then attend
[cached prefix K/V ; own K/V].

Every block's attention is one call into ops/flash_attention, which runs
the hand-written kernel on CUDA tensors and its plain version on CPU ones:
``flash_attention`` (K1) for the prefix blocks, ``flash_attention_prefix``
(K2) for the suffix encoder, its bucketing pads masked by own-key lengths,
and the suffix decoder. Every LayerNorm goes through
``ops.layer_norm.add_layer_norm`` (the one-pass kernel of
``csrc/layer_norm.cu`` on CUDA) with the residual add before it folded in:
a block returns its stream h and its MLP output m pending, and the next
block's norm1 (or the final norm) takes (h, m) and returns h + m beside
the normalised rows; inside a block norm2 takes (h, o) likewise. The
qkv product goes through ``ops.linear.qkv_heads`` (the one-pass kernel of
``csrc/qkv_heads.cu`` on CUDA), which adds the q and v biases, scales q,
splits the heads and, in a pooled suffix, pools k and v; the other linears
take their bias, and fc1 on the card its tanh GELU, in the product's
epilogue (``ops.linear.linear``, ``linear_gelu``). The layer loop is a
Python loop over parameters stacked [L, ...] (``jax.lax.scan`` in the JAX
engine). bf16 cast points: the qkv product accumulates in f32 and casts
back, then its bias and ``q * scale`` each round, as in the JAX engine;
on the card the other products round once with their bias added (the JAX
engine rounds the product, then adds); residual sums round to the compute
dtype and the norms take their f32 statistics of the rounded sum; pooled
means are f32 and then cast.
"""
from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Any, Dict, NamedTuple, Optional

import torch

from .._device import resolve_device
from ..ops import patches as patch_ops
from ..ops.flash_attention import (flash_attention, flash_attention_prefix,
                                   own_lengths)
from ..ops.layer_norm import add_layer_norm
from ..ops.linear import linear, linear_gelu, qkv_heads
from ..ops.normalization import imagenet_normalize
from ..ops.pos_embed import sinusoid_encoding_table
from ..utils import profiling
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


def _add_ln(h, r, p, eps=1e-6):
    """(h + r, LayerNorm(h + r)) with the norm's parameters p; r None:
    (h, LayerNorm(h))."""
    return add_layer_norm(h, r, p['scale'], p['bias'], eps)


def _ln(x, p, eps=1e-6):
    return _add_ln(x, None, p, eps)[1]


def _qkv(p_attn, h, num_heads: int, scale: float, pool: int = 1,
         grid=None):
    """h [B, N, D] -> q (its bias added, scaled by ``scale``), k, v [B, H,
    N, d] contiguous, k and v pooled pool x pool over the token ``grid``
    when pool > 1: the plain qkv product, then one ``qkv_heads`` pass."""
    return qkv_heads(torch.matmul(h, p_attn['qkv_kernel']),
                     p_attn.get('q_bias'), p_attn.get('v_bias'), num_heads,
                     scale, pool, grid)


def _proj(p_attn, out, b, n):
    a = out.shape[1] * out.shape[3]
    return linear(out.transpose(1, 2).reshape(b, n, a),
                  p_attn['proj']['kernel'], p_attn['proj']['bias'])


def _mlp(p_mlp, x, gelu: str = 'erf'):
    # 'erf' is the reference's exact nn.GELU; 'tanh' the cheap approximation
    h = linear_gelu(x, p_mlp['fc1']['kernel'], p_mlp['fc1']['bias'],
                    'tanh' if gelu == 'tanh' else 'none')
    return linear(h, p_mlp['fc2']['kernel'], p_mlp['fc2']['bias'])


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
    attention and drops at the scatter, so bucketing is numerics-neutral."""
    if n_sfx <= 0:
        return 0
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


def prefix_block_one(p, h, num_heads: int, r=None,
                     attention=flash_attention):
    """One pre-norm ViT block over prefix tokens whose stream is h + r (r:
    the previous block's pending MLP output, or None). Returns (h, m,
    (k, v)): the block's output stream is h + m, m left pending.
    attention(q, k, v): the block's attention, K1 unless the caller names
    another (the conjoined engine's context stream)."""
    scale = (h.shape[-1] // num_heads) ** -0.5
    b, n, _ = h.shape
    h, ln = _add_ln(h, r, p['norm1'])
    q, k, v = _qkv(p['attn'], ln, num_heads, scale)
    o = _proj(p['attn'], attention(q, k, v), b, n)
    if 'gamma_1' in p:
        o = p['gamma_1'] * o
    h, ln = _add_ln(h, o, p['norm2'])
    m = _mlp(p['mlp'], ln)
    if 'gamma_2' in p:
        m = p['gamma_2'] * m
    return h, m, (k, v)


def suffix_block_one(p, kv0, h, num_heads: int, prefix_weight: float = 1.0,
                     suffix_pool: int = 1, grid=None, gelu: str = 'erf',
                     key_valid=None, r=None):
    """One pre-norm ViT block: per-sample tokens attend [cached prefix kv0 ;
    own kv]. The stream is h + r (r: the previous block's pending MLP
    output, or None); returns (h, m), the output stream h + m with m
    pending.

    prefix_weight: key multiplicity of the prefix panel (pooled prefix).
    suffix_pool: >1 pools the per-sample keys/values pool x pool over the
    token ``grid`` and weights them pool^2-fold (queries stay full-res).
    key_valid: optional bool [S, N] pad-key mask (sfx_bucket: the pads
    trail), which goes to K2 as own-key lengths. It cannot be combined
    with pooling."""
    scale = (h.shape[-1] // num_heads) ** -0.5
    s, n, _ = h.shape
    k0, v0 = kv0
    if suffix_pool > 1 and key_valid is not None:
        raise ValueError('bucketed pad keys cannot be pooled')
    h, ln = _add_ln(h, r, p['norm1'])
    q, k, v = _qkv(p['attn'], ln, num_heads, scale, suffix_pool, grid)
    o = flash_attention_prefix(
        q, k0, v0, k, v, prefix_weight=prefix_weight,
        suffix_weight=float(suffix_pool * suffix_pool),
        own_len=None if key_valid is None else own_lengths(key_valid))
    o = _proj(p['attn'], o, s, n)
    if 'gamma_1' in p:
        o = p['gamma_1'] * o
    h, ln = _add_ln(h, o, p['norm2'])
    m = _mlp(p['mlp'], ln, gelu)
    if 'gamma_2' in p:
        m = p['gamma_2'] * m
    return h, m


def _num_layers(stacked) -> int:
    return stacked['norm1']['scale'].shape[0]


def _prefix_blocks(stacked, h0, num_heads: int):
    """Full self-attention over the prefix; returns (h, m, (k, v)): the
    output stream h + m (m the last block's pending MLP output) and the
    per-layer keys/values stacked [L, B, H, N, d]."""
    ks, vs = [], []
    h, m = h0, None
    for i in range(_num_layers(stacked)):
        h, m, (k, v) = prefix_block_one(_layer(stacked, i), h, num_heads,
                                        m)
        ks.append(k)
        vs.append(v)
    return h, m, (torch.stack(ks), torch.stack(vs))


def _suffix_blocks(stacked, kvs, hs, num_heads: int,
                   prefix_weight: float = 1.0, suffix_pool: int = 1,
                   grid=None, gelu: str = 'erf', key_valid=None):
    """Per-sample tokens attending to [cached prefix kv ; own kv]; returns
    (hs, m), the output stream hs + m with m pending."""
    k0s, v0s = kvs
    m = None
    for i in range(_num_layers(stacked)):
        hs, m = suffix_block_one(_layer(stacked, i), (k0s[i], v0s[i]), hs,
                                 num_heads, prefix_weight, suffix_pool, grid,
                                 gelu, key_valid, m)
    return hs, m


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
                  x0n) -> PrefixCache:
    """Run the shared frame-0 pass once. x0n: [1, C, H, W] normalized
    frame 0. Returns the per-layer encoder/decoder prefix KV caches."""
    with profiling.span('cf.prefix_build'):
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

        h0, m0, enc_kvs = _prefix_blocks(fp.enc_blocks, tokens0,
                                         model.encoder_num_heads)
        _, h0 = _add_ln(h0, m0, fp.enc_norm)

        z0 = torch.matmul(h0, fp.e2d_kernel).to(dtype)
        pos_dec = sinusoid_encoding_table(
            model.num_patches, model.decoder_embed_dim, device=dev).to(dtype)
        z0 = z0 + pos_dec[:, :n0]
        _, _, dec_kvs = _prefix_blocks(fp.dec_blocks, z0,
                                       model.decoder_num_heads)
        return PrefixCache(enc_kvs=enc_kvs, dec_kvs=dec_kvs)


def predict_frame1_from_prefix(model: PretrainVisionTransformer,
                               fp: FastParams, cache: PrefixCache, x1n,
                               vis1_idx, prefix_pool: int = 1,
                               suffix_pool: int = 1,
                               gelu: Optional[str] = None):
    """Per-sample pass: encode the visible frame-1 tokens against the cached
    prefix, decode every frame-1 position. x1n: [S, C, H, W] normalized
    frame 1; vis1_idx: int [S, n_sfx] visible patch indices within frame 1
    (sentinel N1 in pad slots). Returns [S, N1, out_dim]."""
    return _predict_frame1_core(model, fp, cache, x1n, vis1_idx,
                                int(prefix_pool), int(suffix_pool),
                                resolve_gelu(gelu))


def _predict_frame1_core(model: PretrainVisionTransformer, fp: FastParams,
                         cache: PrefixCache, x1n, vis1_idx,
                         prefix_pool: int = 1, suffix_pool: int = 1,
                         gelu: str = 'erf'):
    with profiling.span('cf.suffix'):
        dtype = fp.patch_kernel.dtype
        pos_dec = sinusoid_encoding_table(
            model.num_patches, model.decoder_embed_dim,
            device=x1n.device)[0].to(dtype)
        with profiling.span('cf.suffix.encoder'):
            z1 = _encode_suffix(model, fp, cache, x1n, vis1_idx, pos_dec,
                                gelu)
        with profiling.span('cf.suffix.decoder'):
            dec_kvs, pw = cache.dec_kvs, 1.0
            ph, pw_ = model.full_patch_size[-2:]
            gh, gw = x1n.shape[-2] // ph, x1n.shape[-1] // pw_
            if prefix_pool > 1:
                dec_kvs = pool_dec_prefix(dec_kvs, prefix_pool, gh, gw)
                pw = float(prefix_pool * prefix_pool)
            y1, m1 = _suffix_blocks(fp.dec_blocks, dec_kvs, z1,
                                    model.decoder_num_heads, pw, suffix_pool,
                                    (gh, gw), gelu)
            _, y1 = _add_ln(y1, m1, fp.dec_norm)
            return (torch.matmul(y1, fp.head_kernel).to(dtype)
                    + fp.head_bias)


def _encode_suffix(model: PretrainVisionTransformer, fp: FastParams,
                   cache: PrefixCache, x1n, vis1_idx, pos_dec, gelu: str):
    """The decoder's frame-1 input rows [S, N1, Cd]: the visible frame-1
    tokens encoded against the cached encoder prefix, at their slots among
    mask tokens. pos_dec: the decoder's position table [N, Cd]."""
    n0 = model.num_patches_per_frame
    n1 = model.num_patches - n0
    dtype = fp.patch_kernel.dtype
    s = x1n.shape[0]
    n_sfx = vis1_idx.shape[1]
    cd = pos_dec.shape[-1]
    base = (fp.mask_token.to(dtype) + pos_dec[n0:]).expand(s, n1, cd)
    if n_sfx == 0:
        # frame 1 fully masked: no suffix tokens, the decoder rows are pure
        # mask tokens (exact, not an approximation)
        return base
    # pad slots carry the sentinel n1: gather them at slot 0, mask their
    # keys out of attention, drop them at the scatter
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
        device=x1n.device)[0].to(dtype)
    tok = tok + pos_enc[n0 + idx_safe]

    # encoder suffix: ~n_sfx queries per sample, two-source, its pad keys
    # masked by own-key lengths
    hs, ms = _suffix_blocks(fp.enc_blocks, cache.enc_kvs, tok,
                            model.encoder_num_heads, gelu=gelu,
                            key_valid=valid)
    _, hs = _add_ln(hs, ms, fp.enc_norm)
    zs = torch.matmul(hs, fp.e2d_kernel).to(dtype)

    # decoder frame-1 rows: mask tokens everywhere, encoded tokens at the
    # visible slots; the scatter goes into an [n1 + 1]-row buffer whose
    # last (sentinel) row takes the pad slots and is dropped
    vals = zs + pos_dec[n0 + idx_safe]
    buf = torch.cat([base, base.new_zeros(s, 1, cd)], dim=1)
    buf.scatter_(1, vis1_idx[..., None].expand(-1, -1, cd), vals)
    return buf[:, :n1]


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
                      normalize: bool, x0) -> PrefixCache:
    """Build the reusable frame-0 cache for a scene. x0: [1, C, H, W] raw
    frame 0 (same normalization flag as the later prediction calls)."""
    if normalize:
        x0 = imagenet_normalize(x0[:, None], temporal_dim=1)[:, 0]
    return encode_prefix(model, fp, x0)


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
            profiling.count('host_sync.lru_key')
            a = torch.as_tensor(arr).detach().cpu().contiguous()
            hsh.update(repr((tuple(a.shape), str(a.dtype))).encode())
            hsh.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
        return hsh.hexdigest()

    def _key_arrays(self, *arrays):
        return arrays

    def get(self, *arrays):
        """-> (entry, hit: bool)."""
        with profiling.span('cf.prefix_lookup'):
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
                 normalize: bool, size: int = 4):
        super().__init__(size)
        self.model, self.fp, self.normalize = model, fp, normalize

    def _build(self, x0):
        return make_prefix_cache(self.model, self.fp, self.normalize, x0)


def predict_videos_shared_prefix(model: PretrainVisionTransformer,
                                 fp: FastParams, n_vis: int, normalize: bool,
                                 x_mocos, mask_mocos,
                                 cache: Optional[PrefixCache] = None,
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
    return _predict_videos_core(model, fp, sfx_bucket(n_vis - n0, n1),
                                normalize,
                                x_mocos, mask_mocos, cache,
                                int(prefix_pool), int(suffix_pool),
                                resolve_gelu(gelu))


def _predict_videos_core(model: PretrainVisionTransformer, fp: FastParams,
                         n_sfx_pad: int, normalize: bool, x_mocos, mask_mocos,
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

    with profiling.span('cf.assemble'):
        xm = (imagenet_normalize(x_mocos, temporal_dim=1) if normalize
              else x_mocos)
        mask1 = mask_mocos[:, n0:]
        vis1_idx = pad_vis1_idx(mask1, n_sfx_pad)
    if cache is None:
        cache = encode_prefix(model, fp, xm[0:1, 0])
    y1 = _predict_frame1_core(model, fp, cache, xm[:, 1], vis1_idx,
                              prefix_pool, suffix_pool, gelu)
    with profiling.span('cf.assemble'):
        raw1 = patch_ops.patchify(x_mocos[:, 1:2], model.full_patch_size,
                                  temporal_dim=1)
        full1 = torch.where(mask1[..., None], y1.to(raw1.dtype), raw1)
        frame1 = patch_ops.unpatchify(full1, model.full_patch_size,
                                      (s, 1, c, h, w), temporal_dim=1)
        return torch.cat([x_mocos[:, 0:1], frame1], dim=1)
