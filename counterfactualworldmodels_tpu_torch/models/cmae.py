"""ChannelMAE: masked autoencoding over the channel groups of one image.

Port of counterfactualworldmodels_tpu/models/cmae.py. Each channel group is
patch-embedded separately and treated as a 'frame'; group-specific heads
decode each group's masked patches. The Soft variants replace the hard
token drop with a differentiable lerp towards a mask token over all tokens.

The models are ``nn.Module``s in the reference ChannelMae state-dict layout
(``encoder.patch_embed.{g}.proj`` as a Conv2d weight [E, c, ph, pw],
``encoder.blocks.{i}``, ``decoder.blocks.{i}``, ``encoder_to_decoder``,
``mask_token``, ``channel_heads.{g}``; ``decoder_mask_token`` for
SoftInputChannelMae), so the JAX package's parameters bridged by
``utils/weights.channel_mae_state_dict_from_jax`` load with strict=True.
They carry their weights: the functions below take the module where the
JAX ones take (model, params). Self-attention runs ``attn_impl``: 'flash'
(the default) launches K1, or K5/K6 when a gradient is asked for, on the
card and runs their plain versions on the CPU.

Masks are bool [B, N], True = masked, group-major (token n of group g is
g * patches_per_group + n), with the same per-group popcounts in every row
(``group_masked_counts``); ``group_uniform_mask`` draws them from uniform
scores that the caller passes in (or from a ``torch.Generator``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.patches import patchify, unpatchify
from ..ops.pos_embed import sinusoid_encoding_table
from .layers import Block, LayerNorm, dense, interpolate_with_mask_token
from .vmae import mask_order, take_tokens


def _partition(channel_partition, in_channels: int) -> Tuple[int, ...]:
    if channel_partition is None:
        return (1,) * in_channels
    return tuple(channel_partition)


def _group_patches(group, patch_size):
    """[B, c, H, W] -> [B, n_per, ph*pw*c] patch vectors, (ph, pw, c)
    ordered."""
    return patchify(group[:, :, None], (1,) + tuple(patch_size),
                    temporal_dim=2)


class _GroupPatchEmbed(nn.Module):
    """One channel group's patch embedding: the reference's Conv2d weight
    [E, c, ph, pw], applied as one matmul on patch vectors."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size, dtype,
                 device):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, tuple(patch_size),
                              stride=tuple(patch_size), device=device)
        self.dtype = dtype

    def forward(self, patches):
        w = self.proj.weight                              # [E, c, ph, pw]
        kernel = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        out = F.linear(patches.to(self.dtype), kernel.to(self.dtype))
        return out + self.proj.bias.to(self.dtype)


def _blocks(dim, depth, num_heads, mlp_ratio, qkv_bias, init_values, dtype,
            attn_impl, device):
    return nn.ModuleList([
        Block(dim, num_heads, mlp_ratio, qkv_bias, init_values=init_values,
              dtype=dtype, attn_impl=attn_impl, device=device)
        for _ in range(depth)])


class ChannelMaeDecoder(nn.Module):
    """Transformer stack with an optional head over the last N tokens."""

    def __init__(self, embed_dim: int = 384, num_classes: int = 0,
                 depth: int = 4, num_heads: int = 6, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, init_values: Optional[float] = None,
                 dtype=torch.float32, attn_impl: str = 'flash',
                 device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              qkv_bias, init_values, dtype, attn_impl, device)
        self.norm = LayerNorm(embed_dim, 1e-6, dtype, device)
        self.head = (nn.Linear(embed_dim, num_classes, device=device)
                     if num_classes > 0 else None)
        self.dtype = dtype

    def get_last_tokens(self, x, return_token_num: int):
        if return_token_num > 0:
            x = x[:, -return_token_num:]
        elif return_token_num == 0:
            x = x[:, :0]
        x = self.norm(x)
        return x if self.head is None else dense(x, self.head, self.dtype)

    def forward(self, x, return_token_num: int = -1):
        for blk in self.blocks:
            x = blk(x)
        return self.get_last_tokens(x, return_token_num)


class ChannelMaeEncoder(nn.Module):
    """Per-channel-group patch embedding + a ViT over the visible tokens."""

    def __init__(self, image_size=(224, 224), patch_size=(32, 32),
                 in_channels: int = 3,
                 channel_partition: Optional[Sequence[int]] = None,
                 concat_base_channels: Sequence[int] = (),
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = None, dtype=torch.float32,
                 attn_impl: str = 'flash', device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.image_size = tuple(image_size)
        self.patch_size = tuple(patch_size)
        self.in_channels = in_channels
        self.partition = _partition(channel_partition, in_channels)
        self.concat_base_channels = tuple(concat_base_channels)
        self.embed_dim = embed_dim
        n_base = len(self.concat_base_channels)
        self.patch_embed = nn.ModuleList([
            _GroupPatchEmbed(c + n_base, embed_dim, self.patch_size, dtype,
                             device)
            for c in self.partition])
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              qkv_bias, init_values, dtype, attn_impl, device)
        self.norm = LayerNorm(embed_dim, 1e-6, dtype, device)

    @property
    def num_channel_groups(self):
        return len(self.partition)

    @property
    def patches_per_group(self):
        return ((self.image_size[0] // self.patch_size[0]) *
                (self.image_size[1] // self.patch_size[1]))

    @property
    def num_patches(self):
        return self.patches_per_group * self.num_channel_groups

    @property
    def mask_size(self):
        return (self.num_channel_groups,
                self.image_size[0] // self.patch_size[0],
                self.image_size[1] // self.patch_size[1])

    def tokenize(self, x):
        """x [B, C, H, W] -> [B, N, E]: each channel group patch-embedded
        separately, tokens concatenated group-major, plus the sin/cos
        table."""
        if x.dim() == 5:
            x = x[:, :, 0]
        groups = torch.split(x, list(self.partition), dim=1)
        if self.concat_base_channels:
            base = x[:, list(self.concat_base_channels)]
            groups = [torch.cat([g, base], dim=1) for g in groups]
        tokens = torch.cat([embed(_group_patches(g, self.patch_size))
                            for g, embed in zip(groups, self.patch_embed)],
                           dim=1)
        pos = sinusoid_encoding_table(tokens.shape[1], self.embed_dim,
                                      device=tokens.device)
        return tokens + pos.to(tokens.dtype)

    def forward(self, x, mask, n_vis: int):
        tokens = self.tokenize(x)
        x_vis = take_tokens(tokens, mask_order(mask)[:, :n_vis])
        for blk in self.blocks:
            x_vis = blk(x_vis)
        return self.norm(x_vis)


class _ChannelMaeBase(nn.Module):
    """The configuration, encoder, decoder, projection and per-group heads
    shared by ChannelMae and the Soft variants; ``mask_token_dim`` is the
    width of the mask token (the decoder's, or the encoder's for the Soft
    ones)."""

    def __init__(self, image_size, patch_size, in_channels, channel_partition,
                 concat_base_channels, encoder_embed_dim, encoder_depth,
                 encoder_num_heads, decoder_embed_dim, decoder_depth,
                 decoder_num_heads, mlp_ratio, qkv_bias, dtype, attn_impl,
                 device, soft: bool):
        super().__init__()
        device = resolve_device(device)
        self.image_size = tuple(image_size)
        self.patch_size = tuple(patch_size)
        self.concat_base_channels = tuple(concat_base_channels)
        self.encoder_embed_dim = encoder_embed_dim
        self.decoder_embed_dim = decoder_embed_dim
        self.mlp_ratio = mlp_ratio
        self.qkv_bias = qkv_bias
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.encoder = ChannelMaeEncoder(
            image_size, patch_size, in_channels, channel_partition,
            concat_base_channels, encoder_embed_dim, encoder_depth,
            encoder_num_heads, mlp_ratio, qkv_bias, dtype=dtype,
            attn_impl=attn_impl, device=device)
        self.decoder = ChannelMaeDecoder(
            decoder_embed_dim, 0, decoder_depth, decoder_num_heads,
            mlp_ratio, qkv_bias, dtype=dtype, attn_impl=attn_impl,
            device=device)
        self.encoder_to_decoder = nn.Linear(encoder_embed_dim,
                                            decoder_embed_dim, bias=False,
                                            device=device)
        dim = encoder_embed_dim if soft else decoder_embed_dim
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.channel_heads = nn.ModuleList([
            nn.Linear(decoder_embed_dim, self.patch_dim * g, device=device)
            for g in self.partition])

    @property
    def device(self):
        return self.mask_token.device

    # the token layout is the encoder's
    partition = property(lambda self: self.encoder.partition)
    num_channel_groups = property(lambda self: self.encoder.num_channel_groups)
    patches_per_group = property(lambda self: self.encoder.patches_per_group)
    num_patches = property(lambda self: self.encoder.num_patches)
    mask_size = property(lambda self: self.encoder.mask_size)

    @property
    def patch_dim(self):
        return self.patch_size[0] * self.patch_size[1]

    @property
    def channel_group_start_inds(self):
        return [0] + [int(v) for v in np.cumsum(self.partition)]

    def _decoder_pos(self, device):
        return sinusoid_encoding_table(self.num_patches,
                                       self.decoder_embed_dim, device=device)


class ChannelMae(_ChannelMaeBase):
    """Encoder + decoder + per-group channel heads. forward(x, mask, n_vis,
    group_masked_counts) is ``forward_groups``."""

    def __init__(self, image_size=(224, 224), patch_size=(32, 32),
                 in_channels: int = 3,
                 channel_partition: Optional[Sequence[int]] = None,
                 concat_base_channels: Sequence[int] = (),
                 encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12, decoder_embed_dim: int = 384,
                 decoder_depth: int = 4, decoder_num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dtype=torch.float32, attn_impl: str = 'flash',
                 device='cuda'):
        super().__init__(image_size, patch_size, in_channels,
                         channel_partition, concat_base_channels,
                         encoder_embed_dim, encoder_depth, encoder_num_heads,
                         decoder_embed_dim, decoder_depth, decoder_num_heads,
                         mlp_ratio, qkv_bias, dtype, attn_impl, device,
                         soft=False)

    def forward(self, x, mask, n_vis: int,
                group_masked_counts: Sequence[int]):
        return self.forward_groups(x, mask, n_vis, group_masked_counts)

    def forward_groups(self, x, mask, n_vis: int,
                       group_masked_counts: Sequence[int]) -> List[torch.Tensor]:
        """x [B, C, H, W]; mask [B, N] group-major with the same per-group
        popcounts in every row. Returns the per-group predictions of the
        masked patches [B, n_masked_g, patch_dim * c_g], in token order."""
        x_vis = dense(self.encoder(x, mask, n_vis), self.encoder_to_decoder,
                      self.dtype)
        b, _, c = x_vis.shape
        pos = self._decoder_pos(x.device).expand(b, -1, c).to(x_vis.dtype)
        order = mask_order(mask)
        pos_vis = take_tokens(pos, order[:, :n_vis])
        pos_mask = take_tokens(pos, order[:, n_vis:])
        x_full = torch.cat([x_vis + pos_vis,
                            self.mask_token.to(x_vis.dtype) + pos_mask], 1)
        y_masked = self.decoder(x_full, return_token_num=-1)[:, n_vis:]
        outs, start = [], 0
        for head, cnt in zip(self.channel_heads, group_masked_counts):
            outs.append(dense(y_masked[:, start:start + cnt], head,
                              self.dtype))
            start += cnt
        return outs

    def compute_labels(self, x, mask, group_masked_counts: Sequence[int]):
        """The masked ground-truth patches per group [B, n_masked_g,
        patch_dim * c_g]."""
        inds = self.channel_group_start_inds
        n_per = self.patches_per_group
        n_vis = self.num_patches - sum(group_masked_counts)
        masked_idx = mask_order(mask)[:, n_vis:]
        outs, start = [], 0
        for g, cnt in enumerate(group_masked_counts):
            p = _group_patches(x[:, inds[g]:inds[g + 1]], self.patch_size)
            idx = masked_idx[:, start:start + cnt] - g * n_per
            outs.append(take_tokens(p, idx))
            start += cnt
        return outs


def group_uniform_mask(draws, mask_size, mask_ratio: float,
                       batch_size: int = 1):
    """Group-major [B, G * n_per] mask with ``int(mask_ratio * n_per)``
    masked tokens in every group of every row: each group masks the tokens
    of its lowest uniform scores. ``draws``: the scores [B, G, n_per] (the
    JAX package draws them with ``jax.random.uniform`` on B * G split
    keys) or a ``torch.Generator`` to draw them from. Returns (mask,
    group_masked_counts)."""
    g, h, w = mask_size
    n_per = h * w
    num_masked = int(mask_ratio * n_per)
    if isinstance(draws, torch.Generator):
        scores = torch.rand((batch_size, g, n_per), generator=draws,
                            device=draws.device)
    else:
        scores = torch.as_tensor(draws)
        if tuple(scores.shape) != (batch_size, g, n_per):
            raise ValueError(f'draws of shape {tuple(scores.shape)}, '
                             f'expected {(batch_size, g, n_per)}')
    order = torch.argsort(scores, dim=-1, stable=True)
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    mask.scatter_(-1, order[..., :num_masked], True)
    return mask.reshape(batch_size, g * n_per), (num_masked,) * g


def apply_channel_mae(model: ChannelMae, x, mask, n_vis: int,
                      group_masked_counts: Sequence[int]):
    return model.forward_groups(x, mask, n_vis, group_masked_counts)


def channel_mae_train_loss(model: ChannelMae, x, mask, n_vis: int,
                           group_masked_counts: Sequence[int]):
    """MSE over masked patches, summed over groups."""
    preds = apply_channel_mae(model, x, mask, n_vis, group_masked_counts)
    labels = model.compute_labels(x, mask, group_masked_counts)
    loss = 0.0
    for p, l in zip(preds, labels):
        if p.shape[1] > 0:
            loss = loss + ((p - l) ** 2).mean()
    return loss


def channel_mae_predict_image(model: ChannelMae, x, mask, n_vis: int,
                              group_masked_counts: Sequence[int]):
    """The per-group predictions recombined into a full image [B, C, H, W];
    visible patches come from the input."""
    preds = apply_channel_mae(model, x, mask, n_vis, group_masked_counts)
    inds = model.channel_group_start_inds
    n_per = model.patches_per_group
    masked_idx = mask_order(mask)[:, n_vis:]
    out_groups, start = [], 0
    for g, cg in enumerate(model.partition):
        p = _group_patches(x[:, inds[g]:inds[g + 1]], model.patch_size)
        cnt = group_masked_counts[g]
        idx = masked_idx[:, start:start + cnt] - g * n_per
        p = p.scatter(1, idx[..., None].expand(-1, -1, p.shape[-1]),
                      preds[g].to(p.dtype))
        out_groups.append(unpatchify(p, (1,) + model.patch_size,
                                     (x.shape[0], cg, *model.image_size)))
        start += cnt
    return torch.cat(out_groups, dim=1)


class SoftChannelMae(_ChannelMaeBase):
    """Differentiable masking: every token is a lerp between its embedding
    and the mask token (at the encoder's width), weighted by a soft mask in
    [0, 1]; no token is dropped, so there is no gather."""

    def __init__(self, image_size=(224, 224), patch_size=(32, 32),
                 in_channels: int = 3,
                 channel_partition: Optional[Sequence[int]] = None,
                 concat_base_channels: Sequence[int] = (),
                 encoder_embed_dim: int = 768, encoder_depth: int = 12,
                 encoder_num_heads: int = 12, decoder_embed_dim: int = 384,
                 decoder_depth: int = 4, decoder_num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dtype=torch.float32, attn_impl: str = 'flash',
                 device='cuda'):
        super().__init__(image_size, patch_size, in_channels,
                         channel_partition, concat_base_channels,
                         encoder_embed_dim, encoder_depth, encoder_num_heads,
                         decoder_embed_dim, decoder_depth, decoder_num_heads,
                         mlp_ratio, qkv_bias, dtype, attn_impl, device,
                         soft=True)

    def _encode(self, x, soft_mask):
        tokens = self.encoder.tokenize(x)
        tokens = interpolate_with_mask_token(
            tokens, soft_mask, self.mask_token.to(tokens.dtype), invert=True)
        for blk in self.encoder.blocks:
            tokens = blk(tokens)
        return self.encoder.norm(tokens)

    def _decode(self, z, soft_mask):
        """Decoder-width positions added, every token decoded. (The
        reference's _decode names an undefined ``mask``; this is that
        method without the unused argument.)"""
        z = z + self._decoder_pos(z.device).to(z.dtype)
        return self.decoder(z, return_token_num=-1)

    def forward(self, x, soft_mask):
        """x [B, C, H, W]; soft_mask float [B, N] in [0, 1] (1 = fully
        masked). Returns the per-group predictions of every token
        [B, n_per, patch_dim * c_g], differentiable in soft_mask."""
        z = dense(self._encode(x, soft_mask), self.encoder_to_decoder,
                  self.dtype)
        y = self._decode(z, soft_mask)
        n_per = self.patches_per_group
        return [dense(y[:, g * n_per:(g + 1) * n_per], head, self.dtype)
                for g, head in enumerate(self.channel_heads)]

    def compute_labels(self, x):
        """Every token's ground-truth patch per group."""
        inds = self.channel_group_start_inds
        return [_group_patches(x[:, inds[g]:inds[g + 1]], self.patch_size)
                for g in range(self.num_channel_groups)]


class SoftInputChannelMae(SoftChannelMae):
    """Soft tokens route the inputs; the decoder reads off every position's
    prediction from a fresh set of hard mask tokens (``decoder_mask_token``
    plus positions) appended to the sequence."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.decoder_mask_token = nn.Parameter(
            torch.zeros(1, 1, self.decoder_embed_dim, device=self.device))

    def _decode(self, z, soft_mask):
        b = z.shape[0]
        pos = self._decoder_pos(z.device).to(z.dtype)
        mask_tok = self.decoder_mask_token.to(z.dtype) + pos
        z = torch.cat([z + pos, mask_tok.expand(b, -1, -1)], dim=1)
        return self.decoder(z, return_token_num=self.num_patches)


def soft_channel_mae_recombine(model: SoftChannelMae, ys):
    """The per-group head outputs stacked into [B, n_per, patch_dim, C]."""
    b = ys[0].shape[0]
    n_per, pd = model.patches_per_group, model.patch_dim
    return torch.cat([y.reshape(b, n_per, pd, cg)
                      for y, cg in zip(ys, model.partition)], dim=-1)


def soft_channel_mae_predict_image(model: SoftChannelMae, x, soft_mask,
                                   replace_visible_patches_with_input=True):
    """The per-group soft predictions recombined into a full image; each
    patch lerps between prediction and input by its soft mask value (the
    group-major layout the loss uses, for every number of groups)."""
    preds = model(x, soft_mask)
    n_per = model.patches_per_group
    inds = model.channel_group_start_inds
    out_groups = []
    for g, cg in enumerate(model.partition):
        p = preds[g]
        if replace_visible_patches_with_input:
            xp = _group_patches(x[:, inds[g]:inds[g + 1]],
                                model.patch_size).to(p.dtype)
            m = soft_mask[:, g * n_per:(g + 1) * n_per].to(p.dtype)[..., None]
            p = p * m + xp * (1 - m)
        out_groups.append(unpatchify(p, (1,) + model.patch_size,
                                     (x.shape[0], cg, *model.image_size)))
    return torch.cat(out_groups, dim=1)


def soft_channel_mae_train_loss(model: SoftChannelMae, x, soft_mask):
    """Mask-weighted per-group MSE: fully revealed patches add no loss."""
    preds = model(x, soft_mask)
    labels = model.compute_labels(x)
    n_per = model.patches_per_group
    loss = 0.0
    for g, (p, l) in enumerate(zip(preds, labels)):
        m = soft_mask[:, g * n_per:(g + 1) * n_per].to(p.dtype)
        per_tok = ((p - l) ** 2).mean(-1) * m
        num_masked = torch.clamp(m.sum(1, keepdim=True), min=1.0)
        loss = loss + (per_tok.sum(1, keepdim=True) / num_masked).mean()
    return loss
