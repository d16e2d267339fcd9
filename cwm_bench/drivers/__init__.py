"""One driver per kind of traffic; ``harness.load_driver`` finds each by
the name a cell's file gives. What the drivers share is here."""
from __future__ import annotations

import math
from typing import Dict

import torch


def port_vmae(v: Dict, dtype: torch.dtype, attn_impl: str = 'dense'):
    """The port's VMAE configuration for the configuration file's ``vmae``
    group."""
    from counterfactualworldmodels_tpu_torch.models import vmae
    return vmae.PretrainVisionTransformer(
        img_size=(v['img_size'],) * 2, patch_size=(v['patch_size'],) * 2,
        encoder_in_chans=v['in_chans'],
        encoder_embed_dim=v['encoder_embed_dim'],
        encoder_depth=v['encoder_depth'],
        encoder_num_heads=v['encoder_num_heads'],
        decoder_embed_dim=v['decoder_embed_dim'],
        decoder_depth=v['decoder_depth'],
        decoder_num_heads=v['decoder_num_heads'],
        mlp_ratio=v['mlp_ratio'], qkv_bias=v['qkv_bias'],
        tubelet_size=v['tubelet_size'], num_frames=v['num_frames'],
        dtype=dtype, attn_impl=attn_impl)


def port_raft(r: Dict, sd, dtype: torch.dtype, device):
    """The port's RAFT for the configuration's ``raft`` group, with the
    weights ``sd`` loaded strictly."""
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    raft = RAFT(corr_levels=r['corr_levels'], corr_radius=r['corr_radius'],
                iters=r['iters'], dtype=dtype, device=device)
    raft.load_state_dict(sd, strict=True)
    return raft


def merge_worst(worst: Dict[str, float], got: Dict[str, float]) -> None:
    """Keep, per number, the largest reading; a NaN stays."""
    for k, val in got.items():
        old = worst.get(k, float('-inf'))
        worst[k] = val if math.isnan(val) or val > old else old
