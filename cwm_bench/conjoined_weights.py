"""Seeded weights of a conjoined (two-stream) VMAE in the reference layout
(ConjoinedPaddedVisionTransformer's state dict: ``main_stream.*``,
``context_stream.*``, ``{encoder,decoder}_conjoining_blocks.{i}-{j}.*``),
made on the device as weights.py makes the VMAE's: one draw from the
seed's own stream, matrices lecun-normal, norm scales 1 + 0.1 n, biases and
tokens 0.02 n. The configuration's ``main`` and ``context`` groups are the
streams' StreamSpec fields; ``conjoin_encoder_layers`` and
``conjoin_decoder_layers`` the cross blocks' layer pairs."""
from __future__ import annotations

from typing import Dict

import torch

from cwm_bench.reference.conjoined import layer_pairs
from cwm_bench.weights import Spec, draw, lecun, scale_, small

STREAM = 3          # weights.py draws the VMAE from stream 1, RAFT from 2


def _norm(spec: Spec, name: str, d: int):
    spec.extend([(f'{name}.weight', (d,), scale_), (f'{name}.bias', (d,),
                                                    small)])


def _linear(spec: Spec, name: str, n_out: int, n_in: int, bias=True):
    spec.append((f'{name}.weight', (n_out, n_in), lecun(n_in)))
    if bias:
        spec.append((f'{name}.bias', (n_out,), small))


def _block(spec: Spec, pre: str, d: int, mlp_ratio: float):
    hid = int(d * mlp_ratio)
    _norm(spec, f'{pre}.norm1', d)
    spec.extend([(f'{pre}.attn.qkv.weight', (3 * d, d), lecun(d)),
                 (f'{pre}.attn.q_bias', (d,), small),
                 (f'{pre}.attn.v_bias', (d,), small)])
    _linear(spec, f'{pre}.attn.proj', d, d)
    _norm(spec, f'{pre}.norm2', d)
    _linear(spec, f'{pre}.mlp.fc1', hid, d)
    _linear(spec, f'{pre}.mlp.fc2', d, hid)


def _stream(spec: Spec, s: Dict):
    name = 'context_stream' if s['is_imu'] else 'main_stream'
    e, cd, c = s['encoder_embed_dim'], s['decoder_embed_dim'], s['in_chans']
    spec.append((f'{name}.mask_token', (1, 1, cd), small))
    if s['padded']:
        spec.extend([(f'{name}.null_token_enc', (1, 1, e), small),
                     (f'{name}.null_token_dec', (1, 1, cd), small)])
    if s['is_imu']:
        pt = s['imu_tubelet']
        spec.append((f'{name}.encoder.patch_embed.proj.weight',
                     (e, c, pt, 1, 1), lecun(c * pt)))
    else:
        pt, p = s['tubelet_size'], s['patch_size']
        spec.append((f'{name}.encoder.patch_embed.proj.weight',
                     (e, c, pt, p, p), lecun(c * pt * p * p)))
    spec.append((f'{name}.encoder.patch_embed.proj.bias', (e,), small))
    if s['is_imu'] and s['concat_dummy_token']:
        spec.append((f'{name}.encoder.dummy_token',
                     (1, c, s['imu_tubelet'], 1, 1), small))
    for i in range(s['encoder_depth']):
        _block(spec, f'{name}.encoder.blocks.{i}', e, s['mlp_ratio'])
    _norm(spec, f'{name}.encoder.norm', e)
    for i in range(s['decoder_depth']):
        _block(spec, f'{name}.decoder.blocks.{i}', cd, s['mlp_ratio'])
    _norm(spec, f'{name}.decoder.norm', cd)
    _linear(spec, f'{name}.decoder.head', s['decoder_num_classes'], cd)
    _linear(spec, f'{name}.encoder_to_decoder', cd, e, bias=False)


def _cross(spec: Spec, pre: str, d: int, d_src: int, heads: int,
           ratio: float):
    """A bidirectional cross block without self-attention: the width of
    its heads is the main stream's, d // heads."""
    inner = (d // heads) * heads
    ca = f'{pre}.cross_attention'
    _norm(spec, f'{pre}.norm1_cross', d)
    _norm(spec, f'{pre}.norm1_src_cross', d_src)
    _linear(spec, f'{ca}.qk', 2 * inner, d, bias=False)
    _linear(spec, f'{ca}.qk_src', 2 * inner, d_src, bias=False)
    _linear(spec, f'{ca}.v', inner, d, bias=False)
    _linear(spec, f'{ca}.v_src', inner, d_src, bias=False)
    _linear(spec, f'{ca}.projection', d, inner)
    _linear(spec, f'{ca}.projection_src', d_src, inner)
    _norm(spec, f'{pre}.norm2', d)
    _norm(spec, f'{pre}.norm2_src', d_src)
    for side, w in (('trg', d), ('src', d_src)):
        hid = int(w * ratio)
        _linear(spec, f'{pre}.mlp.{side}.layers.0', hid, w)
        _linear(spec, f'{pre}.mlp.{side}.layers.2', w, hid)


def conjoined_spec(cfg: Dict) -> Spec:
    spec: Spec = []
    m, c = cfg['main'], cfg['context']
    _stream(spec, m)
    _stream(spec, c)
    for which in ('encoder', 'decoder'):
        d, d_src = m[f'{which}_embed_dim'], c[f'{which}_embed_dim']
        for i, j in layer_pairs(cfg, which):
            _cross(spec, f'{which}_conjoining_blocks.{i}-{j}', d, d_src,
                   cfg['cross_num_heads'], cfg['cross_mlp_ratio'])
    return spec


def conjoined_state_dict(cfg: Dict, seed: int, device
                         ) -> Dict[str, torch.Tensor]:
    return draw(conjoined_spec(cfg), seed, STREAM, device)
