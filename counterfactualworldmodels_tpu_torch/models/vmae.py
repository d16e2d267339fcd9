"""VideoMAE-style masked predictor: configuration and token ordering.

Port of counterfactualworldmodels_tpu/models/vmae.py. The configuration is
a plain dataclass with the same fields, properties and factories; the
weights live in a reference-layout state dict (utils/weights.py) that the
shared-prefix engine (models/fast_vmae.py) re-lays out. The exact forward
(encoder/decoder modules) comes in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def mask_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable ordering of token indices, visible first: the first n_vis
    entries of each row index the visible tokens in original order, the
    rest the masked tokens in original order. int64 [B, N]."""
    return torch.argsort(mask.to(torch.uint8), dim=-1, stable=True)


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
