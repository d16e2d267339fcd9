"""Weight bridge: the port's models load reference-layout (torch) state dicts.

* ``vmae_state_dict_from_jax`` / ``raft_state_dict_from_jax``: the JAX
  package's flax parameter trees (nested dicts of arrays) -> reference
  state dicts. This is the port's own copy of the inverse rules of the JAX
  package's torch export (flax Dense kernel [in, out] -> Linear weight
  [out, in]; conv kernel [kh, kw, in, out] -> [out, in, kh, kw]; matmul
  patch embed [(pt ph pw c), E] -> Conv3d weight [E, C, pt, ph, pw];
  scale/bias -> norm weight/bias).
* ``conjoined_state_dict_from_jax``: the JAX package's ConjoinedVMAE
  parameters -> the reference Conjoined(Padded)PretrainVisionTransformer
  state dict (the port's own copy of the JAX package's
  ``export_conjoined`` rules; the IMU patch embedding becomes a Conv3d
  weight [E, C, pt, 1, 1], cross blocks are keyed '{i}-{j}' by their
  resolved layer pair).
* ``init_vmae_state_dict`` / ``init_conjoined_state_dict`` / ``init_raft``:
  seeded random weights drawn from the JAX initialisers' distributions,
  for runs without a checkpoint.

fast_vmae.stack_vmae_params, fast_conjoined.cast_params and the modules'
load_state_dict(strict=True) consume these state dicts; a released
checkpoint in the reference layout loads the same way.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..models.raft.layers import Conv2d, FrozenBatchNorm
from ..models.vmae import PretrainVisionTransformer


def _t(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v))


def _linear(out, prefix, node):
    out[prefix + '.weight'] = _t(np.asarray(node['kernel']).T)
    if 'bias' in node:
        out[prefix + '.bias'] = _t(node['bias'])


def _layernorm(out, prefix, node):
    out[prefix + '.weight'] = _t(node['scale'])
    out[prefix + '.bias'] = _t(node['bias'])


def _block(out, prefix, node):
    _layernorm(out, prefix + '.norm1', node['norm1'])
    _layernorm(out, prefix + '.norm2', node['norm2'])
    attn = node['attn']
    w = np.asarray(attn['qkv_kernel'])                # [D, 3, A]
    out[prefix + '.attn.qkv.weight'] = _t(w.reshape(w.shape[0], -1).T)
    for b in ('q_bias', 'v_bias'):
        if b in attn:
            out[f'{prefix}.attn.{b}'] = _t(attn[b])
    _linear(out, prefix + '.attn.proj', attn['proj'])
    _linear(out, prefix + '.mlp.fc1', node['mlp']['fc1'])
    _linear(out, prefix + '.mlp.fc2', node['mlp']['fc2'])
    for g in ('gamma_1', 'gamma_2'):
        if g in node:
            out[f'{prefix}.{g}'] = _t(node[g])


def _blocks(out, prefix, tree):
    for name in sorted(k for k in tree if k.startswith('blocks_')):
        _block(out, f'{prefix}.blocks.{int(name.split("_")[1])}', tree[name])


def _patch_embed(out, prefix, node, in_chans, patch_size):
    """[(pt ph pw c), E] matmul kernel -> Conv3d weight [E, C, pt, ph, pw]."""
    k = np.asarray(node['kernel'])
    pt, ph, pw = patch_size
    out[prefix + '.proj.weight'] = _t(
        k.reshape(pt, ph, pw, in_chans, k.shape[-1]).transpose(4, 3, 0, 1, 2))
    out[prefix + '.proj.bias'] = _t(node['bias'])


def vmae_state_dict_from_jax(params: Dict, in_chans: int = 3,
                             patch_size=(1, 8, 8)) -> Dict[str, torch.Tensor]:
    """Flax PretrainVisionTransformer params -> reference VMAE state dict.
    ``patch_size`` is (pt, ph, pw), the model's full_patch_size."""
    out: Dict[str, torch.Tensor] = {}
    enc = params['encoder']
    _patch_embed(out, 'encoder.patch_embed', enc['patch_embed']['proj'],
                 in_chans, patch_size)
    _blocks(out, 'encoder', enc)
    _layernorm(out, 'encoder.norm', enc['norm'])
    if 'pos_embed' in enc:
        out['encoder.pos_embed'] = _t(enc['pos_embed'])
    if 'decoder' in params:
        dec = params['decoder']
        _blocks(out, 'decoder', dec)
        _layernorm(out, 'decoder.norm', dec['norm'])
        _linear(out, 'decoder.head', dec['head'])
        _linear(out, 'encoder_to_decoder', params['encoder_to_decoder'])
    if 'mask_token' in params:
        out['mask_token'] = _t(params['mask_token'])
    return out


def _cross_block(out, prefix, node):
    """One CrossAttentionTransformerBlock (either direction mode, with or
    without its self-attention branch, mlps and gammas)."""
    for ln in ('norm1_cross', 'norm1_src_cross', 'norm1', 'norm1_src',
               'norm2', 'norm2_src'):
        if ln in node:
            _layernorm(out, f'{prefix}.{ln}', node[ln])
    ca = node['cross_attention']
    for lin in ('qk', 'qk_src', 'v', 'v_src', 'k', 'projection',
                'projection_src'):
        if lin in ca:
            _linear(out, f'{prefix}.cross_attention.{lin}', ca[lin])
    if 'qv_kernel' in ca:
        out[f'{prefix}.cross_attention.qv.weight'] = _t(
            np.asarray(ca['qv_kernel']).T)
    for b in ('q_bias', 'v_bias'):
        if b in ca:
            out[f'{prefix}.cross_attention.{b}'] = _t(ca[b])
    for side in ('trg', 'src'):
        if f'mlp_{side}' in node:
            mlp = node[f'mlp_{side}']
            _linear(out, f'{prefix}.mlp.{side}.layers.0', mlp['layers_0'])
            _linear(out, f'{prefix}.mlp.{side}.layers.2', mlp['layers_2'])
        sa = node.get(f'self_attention_{side}')
        if sa is not None:
            w = np.asarray(sa['qkv_kernel'])          # [D, 3, A]
            out[f'{prefix}.self_attention.{side}.qkv.weight'] = _t(
                w.reshape(w.shape[0], -1).T)
            for b in ('q_bias', 'v_bias'):
                if b in sa:
                    out[f'{prefix}.self_attention.{side}.{b}'] = _t(sa[b])
            _linear(out, f'{prefix}.self_attention.{side}.projection',
                    sa['projection'])
        if f'shortcut_{side}' in node:
            _linear(out, f'{prefix}.shortcut_{side}', node[f'shortcut_{side}'])
    for g in ('gamma_1', 'gamma_1_cross', 'gamma_1_src', 'gamma_1_src_cross',
              'gamma_2', 'gamma_2_src'):
        if g in node:
            out[f'{prefix}.{g}'] = _t(node[g])


def _stream(out, prefix, params, name, spec):
    enc = params[f'{name}_encoder']
    if spec.is_imu:
        k = np.asarray(enc['proj']['kernel'])          # [(pt c), E]
        w = k.reshape(spec.imu_tubelet, spec.in_chans, k.shape[-1])
        out[f'{prefix}.encoder.patch_embed.proj.weight'] = _t(
            w.transpose(2, 1, 0)[:, :, :, None, None])
        out[f'{prefix}.encoder.patch_embed.proj.bias'] = _t(
            enc['proj']['bias'])
        if 'dummy_token' in enc:
            out[f'{prefix}.encoder.dummy_token'] = _t(enc['dummy_token'])
    else:
        _patch_embed(out, f'{prefix}.encoder.patch_embed',
                     enc['patch_embed']['proj'], spec.in_chans,
                     (spec.tubelet_size,) + tuple(spec.patch_size))
    _blocks(out, f'{prefix}.encoder', enc)
    _layernorm(out, f'{prefix}.encoder.norm', enc['norm'])
    dec = params[f'{name}_decoder']
    _blocks(out, f'{prefix}.decoder', dec)
    _layernorm(out, f'{prefix}.decoder.norm', dec['norm'])
    _linear(out, f'{prefix}.decoder.head', dec['head'])
    _linear(out, f'{prefix}.encoder_to_decoder', params[f'{name}_e2d'])
    out[f'{prefix}.mask_token'] = _t(params[f'{name}_mask_token'])
    for tname, fname in (('null_token_enc', 'null_enc'),
                         ('null_token_dec', 'null_dec')):
        if f'{name}_{fname}' in params:
            out[f'{prefix}.{tname}'] = _t(params[f'{name}_{fname}'])


def conjoined_state_dict_from_jax(model, params: Dict
                                  ) -> Dict[str, torch.Tensor]:
    """Flax ConjoinedVMAE params -> the reference conjoined state dict.
    ``model`` (the port's ConjoinedVMAE, or the JAX module: anything with
    ``main``, ``context`` and the conjoin layer pairs) gives the stream
    specs and the '{i}-{j}' keys of the cross blocks, in declaration
    order."""
    out: Dict[str, torch.Tensor] = {}
    _stream(out, 'main_stream', params, 'main', model.main)
    _stream(out, 'context_stream', params, 'context', model.context)
    m, c = model.main, model.context
    for what, pairs, dm, dc in (
            ('encoder', model.conjoin_encoder_layers, m.encoder_depth,
             c.encoder_depth),
            ('decoder', model.conjoin_decoder_layers, m.decoder_depth,
             c.decoder_depth)):
        for idx, p in enumerate(pairs):
            i, j = p if hasattr(p, '__len__') else (p, p)
            _cross_block(out, f'{what}_conjoining_blocks.{i % dm}-{j % dc}',
                         params[f'{what}_cross_blocks_{idx}'])
    return out


def _conv(out, prefix, node):
    out[prefix + '.weight'] = _t(np.asarray(node['kernel']).transpose(3, 2, 0, 1))
    if 'bias' in node:
        out[prefix + '.bias'] = _t(node['bias'])


def _bn(out, prefix, node):
    out[prefix + '.weight'] = _t(node['scale'])
    out[prefix + '.bias'] = _t(node['bias'])
    out[prefix + '.running_mean'] = _t(node['mean'])
    out[prefix + '.running_var'] = _t(node['var'])
    out[prefix + '.num_batches_tracked'] = torch.zeros((), dtype=torch.long)


def _encoder(out, prefix, tree, norm_fn, bottleneck=False):
    """A BasicEncoder (residual blocks of 2 convs) or, with bottleneck, a
    SmallEncoder (3 convs). Only 'batch' norms carry weights ('instance'
    and 'none' have none)."""
    n_convs = 3 if bottleneck else 2
    _conv(out, prefix + '.conv1', tree['conv1'])
    if norm_fn == 'batch':
        _bn(out, prefix + '.norm1', tree['norm1'])
    for layer in (1, 2, 3):
        for blk in (0, 1):
            node = tree[f'layer{layer}_{blk}']
            p = f'{prefix}.layer{layer}.{blk}'
            for i in range(1, n_convs + 1):
                _conv(out, f'{p}.conv{i}', node[f'conv{i}'])
                if norm_fn == 'batch':
                    _bn(out, f'{p}.norm{i}', node[f'norm{i}'])
            if 'downsample_conv' in node:
                _conv(out, f'{p}.downsample.0', node['downsample_conv'])
                if norm_fn == 'batch':
                    # the reference registers this norm twice (norm{n+1}
                    # and downsample.1): emit both aliases of the tensors
                    last = f'norm{n_convs + 1}'
                    _bn(out, f'{p}.downsample.1', node[last])
                    _bn(out, f'{p}.{last}', node[last])
    _conv(out, prefix + '.conv2', tree['conv2'])


def raft_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax RAFT params -> reference RAFT state dict: the large or the small
    model (told apart by the GRU's convolutions), with the output head's
    ``output_block.0`` / ``.2`` when the tree has one."""
    out: Dict[str, torch.Tensor] = {}
    ub = params['update_step']['update_block']
    small = 'convz' in ub['gru']
    _encoder(out, 'fnet', params['fnet'], 'instance', small)
    _encoder(out, 'cnet', params['cnet'], 'none' if small else 'batch', small)
    enc = (('convc1', 'convf1', 'convf2', 'conv') if small
           else ('convc1', 'convc2', 'convf1', 'convf2', 'conv'))
    for c in enc:
        _conv(out, f'update_block.encoder.{c}', ub['encoder'][c])
    gru = (('convz', 'convr', 'convq') if small else
           ('convz1', 'convr1', 'convq1', 'convz2', 'convr2', 'convq2'))
    for c in gru:
        _conv(out, f'update_block.gru.{c}', ub['gru'][c])
    for c in ('conv1', 'conv2'):
        _conv(out, f'update_block.flow_head.{c}', ub['flow_head'][c])
    if not small:
        _conv(out, 'update_block.mask.0', ub['mask_0'])
        _conv(out, 'update_block.mask.2', ub['mask_2'])
    if 'output_block_0' in params:
        _conv(out, 'output_block.0', params['output_block_0'])
        _conv(out, 'output_block.2', params['output_block_2'])
    return out


# ---------------------------------------------------------------------------
# Seeded initialisers (flax's defaults: Dense/Conv kernels lecun_normal,
# the attention qkv kernel xavier_uniform, biases zeros, norms ones/zeros,
# the mask token truncated_normal(0.02)).
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, generator: torch.Generator):
    """Normal(0, std) truncated to +-2 std, by inverse-CDF sampling."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    u = torch.rand(shape, generator=generator, device=generator.device)
    x = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    return x.clamp_(-2.0, 2.0) * std


def _lecun(shape, fan_in: int, generator):
    # flax's lecun_normal: truncated normal rescaled to variance 1/fan_in
    return _trunc_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                         generator)


def _init_block(sd, prefix, d, mlp_ratio, qkv_bias, init_values, generator):
    """One pre-norm ViT block (models/layers.Block) in the reference
    layout."""
    dev = generator.device
    a = d  # all_head_dim
    hidden = int(d * mlp_ratio)
    for n in ('norm1', 'norm2'):
        sd[f'{prefix}.{n}.weight'] = torch.ones(d, device=dev)
        sd[f'{prefix}.{n}.bias'] = torch.zeros(d, device=dev)
    # flax fans of the [D, 3, A] kernel: fan_in = 3*D, fan_out = A*D
    limit = math.sqrt(6.0 / (3 * d + a * d))
    u = torch.rand((3 * a, d), generator=generator, device=dev)
    sd[prefix + '.attn.qkv.weight'] = (u * 2 - 1) * limit
    if qkv_bias:
        sd[prefix + '.attn.q_bias'] = torch.zeros(a, device=dev)
        sd[prefix + '.attn.v_bias'] = torch.zeros(a, device=dev)
    sd[prefix + '.attn.proj.weight'] = _lecun((d, a), a, generator)
    sd[prefix + '.attn.proj.bias'] = torch.zeros(d, device=dev)
    sd[prefix + '.mlp.fc1.weight'] = _lecun((hidden, d), d, generator)
    sd[prefix + '.mlp.fc1.bias'] = torch.zeros(hidden, device=dev)
    sd[prefix + '.mlp.fc2.weight'] = _lecun((d, hidden), hidden, generator)
    sd[prefix + '.mlp.fc2.bias'] = torch.zeros(d, device=dev)
    if (init_values or 0) > 0:
        sd[prefix + '.gamma_1'] = torch.full((d,), float(init_values),
                                             device=dev)
        sd[prefix + '.gamma_2'] = torch.full((d,), float(init_values),
                                             device=dev)


def init_vmae_state_dict(model: PretrainVisionTransformer,
                         generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random VMAE weights in the reference layout, on generator.device."""
    dev = generator.device
    sd: Dict[str, torch.Tensor] = {}

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def block(prefix, d):
        _init_block(sd, prefix, d, model.mlp_ratio, model.qkv_bias,
                    model.init_values, generator)

    e, cd = model.encoder_embed_dim, model.decoder_embed_dim
    pt, ph, pw = model.full_patch_size
    c = model.encoder_in_chans
    sd['encoder.patch_embed.proj.weight'] = _lecun((e, c, pt, ph, pw),
                                                   pt * ph * pw * c, generator)
    sd['encoder.patch_embed.proj.bias'] = zeros(e)
    for i in range(model.encoder_depth):
        block(f'encoder.blocks.{i}', e)
    sd['encoder.norm.weight'], sd['encoder.norm.bias'] = ones(e), zeros(e)
    for i in range(model.decoder_depth):
        block(f'decoder.blocks.{i}', cd)
    sd['decoder.norm.weight'], sd['decoder.norm.bias'] = ones(cd), zeros(cd)
    sd['decoder.head.weight'] = _lecun((model.out_dim, cd), cd, generator)
    sd['decoder.head.bias'] = zeros(model.out_dim)
    sd['encoder_to_decoder.weight'] = _lecun((cd, e), e, generator)
    sd['mask_token'] = _trunc_normal((1, 1, cd), 0.02, generator)
    if model.use_learnable_pos_emb:
        sd['encoder.pos_embed'] = _trunc_normal((1, model.num_patches, e),
                                                0.02, generator)
    return sd


def init_conjoined_state_dict(model, generator: torch.Generator
                              ) -> Dict[str, torch.Tensor]:
    """Random ConjoinedVMAE weights in the reference layout, on
    generator.device: the streams' patch embeddings, projections and heads
    lecun_normal, the attention qkv kernels xavier_uniform, the mask, null
    and dummy tokens normal(0.02), biases zeros and norms ones/zeros (the
    JAX initialisers' distributions). Cross blocks with self-attention
    (no released checkpoint has them) take a state dict instead."""
    if model.with_self_attention:
        raise NotImplementedError('seeded weights for cross blocks with '
                                  'self-attention: load a state dict')
    dev = generator.device
    sd: Dict[str, torch.Tensor] = {}

    def lin(prefix, n_out, n_in, bias=True):
        sd[prefix + '.weight'] = _lecun((n_out, n_in), n_in, generator)
        if bias:
            sd[prefix + '.bias'] = torch.zeros(n_out, device=dev)

    def norm(prefix, d):
        sd[prefix + '.weight'] = torch.ones(d, device=dev)
        sd[prefix + '.bias'] = torch.zeros(d, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev) * 0.02

    for name, spec in (('main_stream', model.main),
                       ('context_stream', model.context)):
        e, cd = spec.encoder_embed_dim, spec.decoder_embed_dim
        c = spec.in_chans
        if spec.is_imu:
            pt = spec.imu_tubelet
            sd[f'{name}.encoder.patch_embed.proj.weight'] = _lecun(
                (e, c, pt, 1, 1), pt * c, generator)
        else:
            pt, (ph, pw) = spec.tubelet_size, spec.patch_size
            sd[f'{name}.encoder.patch_embed.proj.weight'] = _lecun(
                (e, c, pt, ph, pw), pt * ph * pw * c, generator)
        sd[f'{name}.encoder.patch_embed.proj.bias'] = torch.zeros(
            e, device=dev)
        if spec.is_imu and spec.concat_dummy_token:
            sd[f'{name}.encoder.dummy_token'] = normal(1, c, spec.imu_tubelet,
                                                       1, 1)
        for i in range(spec.encoder_depth):
            _init_block(sd, f'{name}.encoder.blocks.{i}', e, spec.mlp_ratio,
                        spec.qkv_bias, 0.0, generator)
        norm(f'{name}.encoder.norm', e)
        for i in range(spec.decoder_depth):
            _init_block(sd, f'{name}.decoder.blocks.{i}', cd, spec.mlp_ratio,
                        spec.qkv_bias, 0.0, generator)
        norm(f'{name}.decoder.norm', cd)
        lin(f'{name}.decoder.head', spec.decoder_num_classes, cd)
        lin(f'{name}.encoder_to_decoder', cd, e, bias=False)
        sd[f'{name}.mask_token'] = normal(1, 1, cd)
        if spec.padded:
            sd[f'{name}.null_token_enc'] = normal(1, 1, e)
            sd[f'{name}.null_token_dec'] = normal(1, 1, cd)

    for what, pairs, dm, dc in (
            ('encoder', model.enc_pairs, model.main.encoder_embed_dim,
             model.context.encoder_embed_dim),
            ('decoder', model.dec_pairs, model.main.decoder_embed_dim,
             model.context.decoder_embed_dim)):
        blocks = getattr(model, f'{what}_conjoining_blocks')
        for i, j in pairs:
            p = f'{what}_conjoining_blocks.{i}-{j}'
            ca = blocks[f'{i}-{j}'].cross_attention
            inner = ca.num_heads * ca.head_dim
            norm(p + '.norm1_cross', dm)
            norm(p + '.norm1_src_cross', dc)
            lin(p + '.cross_attention.qk', 2 * inner, dm, bias=False)
            lin(p + '.cross_attention.qk_src', 2 * inner, dc, bias=False)
            lin(p + '.cross_attention.v', inner, dm, bias=False)
            lin(p + '.cross_attention.v_src', inner, dc, bias=False)
            lin(p + '.cross_attention.projection', dm, inner)
            lin(p + '.cross_attention.projection_src', dc, inner)
            for side, d in (('trg', dm), ('src', dc)):
                mlp = blocks[f'{i}-{j}'].mlp
                if mlp is None:
                    continue
                hidden = mlp[side].layers[0].out_features
                norm(p + ('.norm2' if side == 'trg' else '.norm2_src'), d)
                lin(f'{p}.mlp.{side}.layers.0', hidden, d)
                lin(f'{p}.mlp.{side}.layers.2', d, hidden)
    return sd


@torch.no_grad()
def init_raft(model: torch.nn.Module, generator: torch.Generator):
    """Fill a RAFT module's weights in place from the JAX initialisers'
    distributions (conv kernels lecun_normal, biases zeros, frozen batch
    norms at identity statistics, group norms ones and zeros): the large or
    the small model, with or without the output head. Returns the
    module."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            o, i, kh, kw = m.weight.shape
            m.weight.copy_(_lecun(m.weight.shape, i * kh * kw, generator))
            m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, torch.nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
