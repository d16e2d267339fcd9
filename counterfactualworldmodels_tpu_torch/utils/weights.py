"""Weight bridge: the port's models load reference-layout (torch) state dicts.

* ``vmae_state_dict_from_jax`` / ``raft_state_dict_from_jax``: the JAX
  package's flax parameter trees (nested dicts of arrays) -> reference
  state dicts. This is the port's own copy of the inverse rules of the JAX
  package's torch export (flax Dense kernel [in, out] -> Linear weight
  [out, in]; conv kernel [kh, kw, in, out] -> [out, in, kh, kw]; matmul
  patch embed [(pt ph pw c), E] -> Conv3d weight [E, C, pt, ph, pw];
  scale/bias -> norm weight/bias).
* ``init_vmae_state_dict`` / ``init_raft``: seeded random weights drawn
  from the JAX initialisers' distributions, for runs without a checkpoint.

fast_vmae.stack_vmae_params and RAFT.load_state_dict(strict=True) consume
these state dicts; a released checkpoint in the reference layout loads the
same way.
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


def vmae_state_dict_from_jax(params: Dict, in_chans: int = 3,
                             patch_size=(1, 8, 8)) -> Dict[str, torch.Tensor]:
    """Flax PretrainVisionTransformer params -> reference VMAE state dict.
    ``patch_size`` is (pt, ph, pw), the model's full_patch_size."""
    out: Dict[str, torch.Tensor] = {}
    enc = params['encoder']
    node = enc['patch_embed']['proj']
    k = np.asarray(node['kernel'])
    pt, ph, pw = patch_size
    out['encoder.patch_embed.proj.weight'] = _t(
        k.reshape(pt, ph, pw, in_chans, k.shape[-1]).transpose(4, 3, 0, 1, 2))
    out['encoder.patch_embed.proj.bias'] = _t(node['bias'])
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


def init_vmae_state_dict(model: PretrainVisionTransformer,
                         generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random VMAE weights in the reference layout, on generator.device."""
    dev = generator.device
    sd: Dict[str, torch.Tensor] = {}

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def block(prefix, d, heads):
        a = d  # all_head_dim
        hidden = int(d * model.mlp_ratio)
        sd[prefix + '.norm1.weight'], sd[prefix + '.norm1.bias'] = ones(d), zeros(d)
        sd[prefix + '.norm2.weight'], sd[prefix + '.norm2.bias'] = ones(d), zeros(d)
        # flax fans of the [D, 3, A] kernel: fan_in = 3*D, fan_out = A*D
        limit = math.sqrt(6.0 / (3 * d + a * d))
        sd[prefix + '.attn.qkv.weight'] = (
            torch.rand((3 * a, d), generator=generator, device=dev) * 2 - 1) * limit
        if model.qkv_bias:
            sd[prefix + '.attn.q_bias'] = zeros(a)
            sd[prefix + '.attn.v_bias'] = zeros(a)
        sd[prefix + '.attn.proj.weight'] = _lecun((d, a), a, generator)
        sd[prefix + '.attn.proj.bias'] = zeros(d)
        sd[prefix + '.mlp.fc1.weight'] = _lecun((hidden, d), d, generator)
        sd[prefix + '.mlp.fc1.bias'] = zeros(hidden)
        sd[prefix + '.mlp.fc2.weight'] = _lecun((d, hidden), hidden, generator)
        sd[prefix + '.mlp.fc2.bias'] = zeros(d)
        if (model.init_values or 0) > 0:
            sd[prefix + '.gamma_1'] = ones(d) * model.init_values
            sd[prefix + '.gamma_2'] = ones(d) * model.init_values

    e, cd = model.encoder_embed_dim, model.decoder_embed_dim
    pt, ph, pw = model.full_patch_size
    c = model.encoder_in_chans
    sd['encoder.patch_embed.proj.weight'] = _lecun((e, c, pt, ph, pw),
                                                   pt * ph * pw * c, generator)
    sd['encoder.patch_embed.proj.bias'] = zeros(e)
    for i in range(model.encoder_depth):
        block(f'encoder.blocks.{i}', e, model.encoder_num_heads)
    sd['encoder.norm.weight'], sd['encoder.norm.bias'] = ones(e), zeros(e)
    for i in range(model.decoder_depth):
        block(f'decoder.blocks.{i}', cd, model.decoder_num_heads)
    sd['decoder.norm.weight'], sd['decoder.norm.bias'] = ones(cd), zeros(cd)
    sd['decoder.head.weight'] = _lecun((model.out_dim, cd), cd, generator)
    sd['decoder.head.bias'] = zeros(model.out_dim)
    sd['encoder_to_decoder.weight'] = _lecun((cd, e), e, generator)
    sd['mask_token'] = _trunc_normal((1, 1, cd), 0.02, generator)
    if model.use_learnable_pos_emb:
        sd['encoder.pos_embed'] = _trunc_normal((1, model.num_patches, e),
                                                0.02, generator)
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
