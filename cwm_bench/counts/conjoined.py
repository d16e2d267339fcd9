"""FLOPs and attention-kernel work of the conjoined (IMU-conditioned)
shared-prefix engine, from the configuration's shapes.

A dispatch of S samples runs the frame-0 prefix once (both streams'
encoders and decoders with their cross blocks, the context stream over the
scene's IMU tokens) and then, per sample, the visible frame-1 tokens
through the main encoder against [prefix ; own] keys beside the sample's
own context stream, and every frame-1 row plus the main stream's null rows
through the decoder against [prefix ; own] keys beside the sample's
context decoder (its IMU tokens and null rows). The context decoder runs
up to its last cross block. Counts are 2 x multiply-adds; norms, softmax
and element-wise work are left out, as in vit.py."""
from __future__ import annotations

from typing import Dict, Tuple

from . import attention, vit


def _tokens(s: Dict) -> int:
    """The encoder's tokens of a stream: patches of one frame for the
    video, IMU tubelets (and the dummy token) for the context."""
    if s['is_imu']:
        return (s['sequence_length'] // s['imu_tubelet']
                + int(s['concat_dummy_token']))
    return (s['img_size'] // s['patch_size']) ** 2


def _pads(s: Dict) -> int:
    return s['max_padding_tokens'] if s['padded'] else 0


def _patch_dim(s: Dict) -> int:
    if s['is_imu']:
        return s['in_chans'] * s['imu_tubelet']
    return s['in_chans'] * s['tubelet_size'] * s['patch_size'] ** 2


def cross_flops(n: int, d: int, m: int, d_src: int, heads: int,
                ratio: float, keys: int) -> float:
    """One bidirectional cross block: n main tokens of width d read m
    context tokens of width d_src, which read ``keys`` main keys (n, or the
    cached prefix's and their own); the heads are (d // heads) wide."""
    inner = (d // heads) * heads
    proj = 2.0 * n * d * 3 * inner + 2.0 * m * d_src * 3 * inner
    attn = 4.0 * n * m * inner + 4.0 * m * keys * inner
    out = 2.0 * n * inner * d + 2.0 * m * inner * d_src
    mlp = 4.0 * n * d * int(d * ratio) + 4.0 * m * d_src * int(d_src * ratio)
    return proj + attn + out + mlp


def dispatch_flops(cfg: Dict, s: int, n_sfx: int) -> float:
    """One dispatch of S samples with ``n_sfx`` visible frame-1 tokens
    each."""
    m, c = cfg['main'], cfg['context']
    heads, ratio = cfg['cross_num_heads'], cfg['cross_mlp_ratio']
    n0, mc = _tokens(m), _tokens(c)
    rows = n0 + _pads(m)                 # decoder rows of a sample
    mcd = mc + _pads(c)                  # context decoder rows
    e, cd, ec, cdc = (m['encoder_embed_dim'], m['decoder_embed_dim'],
                      c['encoder_embed_dim'], c['decoder_embed_dim'])
    n_enc, n_dec = (len(cfg['conjoin_encoder_layers']),
                    len(cfg['conjoin_decoder_layers']))
    ctx_dec_depth = 1 + max(j % c['decoder_depth']
                            for _, j in cfg['conjoin_decoder_layers'])
    ctx_enc = c['encoder_depth'] * vit._block(mc, mc, ec, c['mlp_ratio'])
    ctx_dec = ctx_dec_depth * vit._block(mcd, mcd, cdc, c['mlp_ratio'])
    e2d_ctx = 2.0 * mc * ec * cdc

    prefix = (2.0 * n0 * _patch_dim(m) * e + 2.0 * mc * _patch_dim(c) * ec
              + m['encoder_depth'] * vit._block(n0, n0, e, m['mlp_ratio'])
              + m['decoder_depth'] * vit._block(n0, n0, cd, m['mlp_ratio'])
              + ctx_enc + ctx_dec + 2.0 * n0 * e * cd + e2d_ctx
              + n_enc * cross_flops(n0, e, mc, ec, heads, ratio, n0)
              + n_dec * cross_flops(n0, cd, mcd, cdc, heads, ratio, n0))
    sample = (2.0 * n_sfx * _patch_dim(m) * e
              + m['encoder_depth'] * vit._block(n_sfx, n0 + n_sfx, e,
                                                m['mlp_ratio'])
              + m['decoder_depth'] * vit._block(rows, n0 + rows, cd,
                                                m['mlp_ratio'])
              + ctx_enc + ctx_dec + 2.0 * n_sfx * e * cd + e2d_ctx
              + n_enc * cross_flops(n_sfx, e, mc, ec, heads, ratio,
                                    n0 + n_sfx)
              + n_dec * cross_flops(rows, cd, mcd, cdc, heads, ratio,
                                    n0 + rows)
              + 2.0 * n0 * cd * m['decoder_num_classes'])
    return prefix + s * sample


def dispatch_kernels(cfg: Dict, s: int) -> Tuple[float, float]:
    """(ops, bytes) of the attention that one dispatch of S samples runs on
    the attention kernels: K1 over the frame-0 prefix in every main encoder
    and decoder block, and K2 over each sample's decoder rows (frame 1 and
    the null rows) against the shared prefix panel and their own. The
    encoder suffix and the context stream attend through dense products,
    which these kernels do not run."""
    m = cfg['main']
    n0 = _tokens(m)
    rows = n0 + _pads(m)
    ops = nbytes = 0.0
    for depth, dim, heads in ((m['encoder_depth'], m['encoder_embed_dim'],
                               m['encoder_num_heads']),
                              (m['decoder_depth'], m['decoder_embed_dim'],
                               m['decoder_num_heads'])):
        o, b = attention.fwd(1, heads, n0, dim // heads, [(1, n0)])
        ops += depth * o
        nbytes += depth * b
    hd, cd = m['decoder_num_heads'], m['decoder_embed_dim']
    o, b = attention.fwd(s, hd, rows, cd // hd, [(1, n0), (s, rows)])
    return ops + m['decoder_depth'] * o, nbytes + m['decoder_depth'] * b
