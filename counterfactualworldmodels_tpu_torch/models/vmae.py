"""VideoMAE-style masked predictor: configuration, token ordering and the
exact model.

Port of counterfactualworldmodels_tpu/models/vmae.py. The configuration
``PretrainVisionTransformer`` is a frozen dataclass with the flax module's
fields, properties and factories; the shared-prefix engine
(models/fast_vmae.py) reads it. ``PretrainVisionTransformerModule`` is the
flax module's ``__call__`` / ``encode`` as an ``nn.Module`` built from that
configuration, with the reference state-dict layout (utils/weights.py), so
a released checkpoint or the JAX package's parameters bridged by
``vmae_state_dict_from_jax`` load with ``load_state_dict``.

The visible-token gather is the JAX package's: a stable argsort of the mask
puts visible tokens first in original row-major order, and ``n_vis`` (the
number of visible tokens per row) is given by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..ops.pos_embed import sinusoid_encoding_table
from .layers import Block, LayerNorm, PatchEmbed, dense


def mask_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable ordering of token indices, visible first: the first n_vis
    entries of each row index the visible tokens in original order, the
    rest the masked tokens in original order. int64 [B, N]."""
    return torch.argsort(mask.to(torch.uint8), dim=-1, stable=True)


def take_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather [B, K, C] token rows by [B, K] indices."""
    return torch.gather(tokens, 1,
                        idx[..., None].expand(-1, -1, tokens.shape[-1]))


@dataclasses.dataclass(frozen=True)
class PretrainVisionTransformer:
    """Configuration of the full masked video predictor (the JAX flax
    module's fields and properties)."""
    img_size: Tuple[int, int] = (224, 224)
    patch_size: Tuple[int, int] = (8, 8)
    encoder_in_chans: int = 3
    encoder_embed_dim: int = 768
    encoder_depth: int = 12
    encoder_num_heads: int = 12
    decoder_embed_dim: int = 384
    decoder_depth: int = 4
    decoder_num_heads: int = 6
    decoder_num_classes: Optional[int] = None
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    init_values: float = 0.0
    tubelet_size: int = 1
    num_frames: int = 2
    use_learnable_pos_emb: bool = False
    dtype: torch.dtype = torch.float32
    attn_impl: str = 'dense'  # 'dense' | 'flash'

    @property
    def full_patch_size(self):
        return (self.tubelet_size,) + tuple(self.patch_size)

    @property
    def num_patches(self):
        h, w = self.img_size
        return ((h // self.patch_size[0]) * (w // self.patch_size[1]) *
                (self.num_frames // self.tubelet_size))

    @property
    def num_patches_per_frame(self):
        return self.num_patches // self.num_frames

    @property
    def mask_size(self):
        return (self.num_frames // self.tubelet_size,
                self.img_size[0] // self.patch_size[0],
                self.img_size[1] // self.patch_size[1])

    # alias used throughout the reference wrappers
    mask_shape = mask_size

    @property
    def out_dim(self):
        if self.decoder_num_classes is not None:
            return self.decoder_num_classes
        return (self.encoder_in_chans * self.tubelet_size *
                self.patch_size[0] * self.patch_size[1])


def _blocks(cfg: PretrainVisionTransformer, dim: int, heads: int, depth: int,
            device):
    return nn.ModuleList([
        Block(dim, heads, cfg.mlp_ratio, cfg.qkv_bias, cfg.qk_scale,
              cfg.init_values, dtype=cfg.dtype, attn_impl=cfg.attn_impl,
              device=device)
        for _ in range(depth)])


class VMAEEncoder(nn.Module):
    """ViT encoder over the visible tokens only."""

    def __init__(self, cfg: PretrainVisionTransformer, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder_embed_dim
        self.patch_embed = PatchEmbed(cfg.full_patch_size,
                                      cfg.encoder_in_chans, e, cfg.dtype,
                                      device)
        self.pos_embed = (nn.Parameter(torch.zeros(1, cfg.num_patches, e,
                                                   device=device))
                          if cfg.use_learnable_pos_emb else None)
        self.blocks = _blocks(cfg, e, cfg.encoder_num_heads,
                              cfg.encoder_depth, device)
        self.norm = LayerNorm(e, 1e-6, cfg.dtype, device)

    def tokenize(self, x):
        tokens = self.patch_embed(x)
        pos = self.pos_embed
        if pos is None:
            pos = sinusoid_encoding_table(tokens.shape[1], tokens.shape[2],
                                          device=tokens.device)
        return tokens + pos.to(tokens.dtype)

    def forward(self, x, mask, n_vis: int):
        tokens = self.tokenize(x)
        x_vis = take_tokens(tokens, mask_order(mask)[:, :n_vis])
        for blk in self.blocks:
            x_vis = blk(x_vis)
        return self.norm(x_vis)


class VMAEDecoder(nn.Module):
    """Narrow decoder over visible + mask tokens."""

    def __init__(self, cfg: PretrainVisionTransformer, device=None):
        super().__init__()
        d = cfg.decoder_embed_dim
        self.blocks = _blocks(cfg, d, cfg.decoder_num_heads,
                              cfg.decoder_depth, device)
        self.norm = LayerNorm(d, 1e-6, cfg.dtype, device)
        self.head = nn.Linear(d, cfg.out_dim, device=device)
        self.dtype = cfg.dtype

    def get_last_tokens(self, x, return_token_num: int):
        """Head over the trailing (masked) tokens: 0 gives an empty output,
        a negative count all tokens, as in the reference."""
        if return_token_num > 0:
            x = x[:, -return_token_num:]
        elif return_token_num == 0:
            x = x[:, :0]
        return dense(self.norm(x), self.head, self.dtype)

    def forward(self, x, return_token_num: int):
        for blk in self.blocks:
            x = blk(x)
        return self.get_last_tokens(x, return_token_num)


class PretrainVisionTransformerModule(nn.Module):
    """The JAX package's flax ``PretrainVisionTransformer`` module (its
    ``__call__`` and ``encode``), built from the configuration of the same
    name. x [B, C, T, H, W]; mask bool [B, N], True = masked, with exactly
    N - n_vis masked tokens per row; returns the predicted patch vectors of
    the masked tokens [B, N - n_vis, out_dim] in ``cfg.dtype``."""

    def __init__(self, cfg: PretrainVisionTransformer, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = VMAEEncoder(cfg, device)
        self.decoder = VMAEDecoder(cfg, device)
        self.encoder_to_decoder = nn.Linear(
            cfg.encoder_embed_dim, cfg.decoder_embed_dim, bias=False,
            device=device)
        self.mask_token = nn.Parameter(
            torch.zeros(1, 1, cfg.decoder_embed_dim, device=device))

    def forward(self, x, mask, n_vis: int):
        cfg = self.cfg
        x_vis = dense(self.encoder(x, mask, n_vis), self.encoder_to_decoder,
                      cfg.dtype)
        b, _, c = x_vis.shape
        pos = sinusoid_encoding_table(cfg.num_patches, c, device=x.device)
        pos = pos.expand(b, -1, -1).to(x_vis.dtype)
        order = mask_order(mask)
        pos_vis = take_tokens(pos, order[:, :n_vis])
        pos_mask = take_tokens(pos, order[:, n_vis:])
        mask_tok = self.mask_token.to(x_vis.dtype)
        x_full = torch.cat([x_vis + pos_vis, mask_tok + pos_mask], dim=1)
        return self.decoder(x_full, pos_mask.shape[1])

    def encode(self, x, mask, n_vis: int):
        return self.encoder(x, mask, n_vis)


def init_params(model: PretrainVisionTransformer, seed: int = 0,
                device='cuda') -> PretrainVisionTransformerModule:
    """The model with seeded random weights (the JAX initialisers'
    distributions, utils/weights.init_vmae_state_dict) on ``device``."""
    from ..utils.weights import init_vmae_state_dict
    device = resolve_device(device)
    module = PretrainVisionTransformerModule(model, device)
    g = torch.Generator(device=device).manual_seed(seed)
    module.load_state_dict(init_vmae_state_dict(model, g), strict=True)
    return module


@torch.no_grad()
def apply_vmae(module: PretrainVisionTransformerModule, x, mask, n_vis: int):
    """Forward without gradients (the JAX package's jitted ``apply_vmae``;
    the module carries its parameters)."""
    return module(x, mask, n_vis)


def pretrain_videomae_base_224_scaffold(**kwargs):
    return PretrainVisionTransformer(
        img_size=(224, 224), encoder_embed_dim=768, encoder_depth=12,
        encoder_num_heads=12, decoder_embed_dim=384, decoder_num_heads=6,
        decoder_depth=4, mlp_ratio=4.0, qkv_bias=True, **kwargs)


def pretrain_videomae_large_224_scaffold(**kwargs):
    return PretrainVisionTransformer(
        img_size=(224, 224), encoder_embed_dim=1024, encoder_depth=24,
        encoder_num_heads=16, decoder_embed_dim=512, decoder_num_heads=8,
        decoder_depth=12, mlp_ratio=4.0, qkv_bias=True, **kwargs)


def base_16x16patch_2frames_1tube(**kwargs):
    return pretrain_videomae_base_224_scaffold(
        patch_size=(16, 16), num_frames=2, tubelet_size=1, **kwargs)


def base_8x8patch_2frames_1tube(**kwargs):
    """ViT-B/8x8 2-frame config (checkpoint cwm_baseVMAE_224px_8x8patches)."""
    return pretrain_videomae_base_224_scaffold(
        patch_size=(8, 8), num_frames=2, tubelet_size=1, **kwargs)


def large_4x4patch_2frames_1tube(**kwargs):
    """ViT-L/4x4 2-frame config (checkpoint cwm_largeVMAE_224px_4x4patches)."""
    return pretrain_videomae_large_224_scaffold(
        patch_size=(4, 4), num_frames=2, tubelet_size=1, **kwargs)
