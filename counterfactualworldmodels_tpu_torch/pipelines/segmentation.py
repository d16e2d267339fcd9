"""Counterfactual flow sampling — the core Spelke-segmentation workload.

Port of counterfactualworldmodels_tpu/pipelines/segmentation.py
(``counterfactual_videos_and_flows_fast`` so far: the shared-prefix
dispatch that the benchmark times).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..models.fast_vmae import _predict_videos_core
from ..models.raft.raft import apply_raft_shared0
from . import perturbation as perturb


def counterfactual_videos_and_flows_fast(
        vmae_model, fast_params, raft_model, x, passive, active, shifts,
        noise: Union[torch.Tensor, torch.Generator],
        n_sfx_pad: int, normalize: bool, raft_iters: int, fix_passive: bool,
        use_flash: bool, two_source: bool = False, prefix_cache=None,
        prefix_pool: int = 1, suffix_pool: int = 1, gelu: str = 'erf',
        n_vis: Optional[int] = None):
    """Shared-prefix fast path for one scene: B = 1, frame 0 fully visible
    and identical across samples (fix_passive). The ViT runs through the
    prefix-isolated engine (models/fast_vmae.py) and RAFT shares the
    frame-0 feature/context encoders across samples.

    x [1, T, C, H, W]; passive/active bool [1, N, S]; shifts int [1, S, 2]
    (patch units). noise replaces the JAX package's per-sample keys: the
    rectangularizer's uniform [0, 0.999) draws, [1, S, N1] (or [S, N1]),
    or a torch.Generator to draw them from. raft_model is a
    models.raft.raft.RAFT module (it carries its weights, so there is no
    separate raft_params). fast_params: fast_vmae.stack_vmae_params(...).
    n_sfx_pad: bucketed suffix width (fast_vmae.sfx_bucket(n_vis - n0,
    n1)); n_vis: the rectangularizer's per-sample visible-count target.

    Returns (videos [S, T, C, H, W], flows [S, 1, 2, H, W],
    masks [S, N] bool)."""
    if n_vis is None:
        raise TypeError(
            'counterfactual_videos_and_flows_fast: n_vis is required — '
            'pass the rectangularizer target as n_vis=<count> and the '
            'bucketed width (fast_vmae.sfx_bucket(n_vis - n0, n1)) '
            'positionally as n_sfx_pad; without it per-sample visible '
            'counts are data-dependent and can exceed the bucket width')
    b = x.shape[0]
    if b != 1:
        raise ValueError(f'fast path is per-scene (B == 1), got B={b}')
    s = passive.shape[-1]
    n0 = vmae_model.num_patches_per_frame
    n1 = vmae_model.num_patches - n0
    if isinstance(noise, torch.Generator):
        noise = torch.rand(s, n1, generator=noise, device=x.device) * 0.999
    noise = noise.reshape(s, n1)

    x_mocos, mask_mocos = perturb.make_motion_counterfactual(
        x[0], passive[0].T, active[0].T, shifts[0], noise,
        vmae_model.full_patch_size, n_vis_target=n_vis,
        fix_passive=fix_passive)

    y = _predict_videos_core(vmae_model, fast_params, use_flash, two_source,
                             n_sfx_pad, normalize, x_mocos, mask_mocos,
                             prefix_cache, prefix_pool, suffix_pool, gelu)
    flows = apply_raft_shared0(raft_model, y, raft_iters, True)
    return y, flows, mask_mocos
