"""Mask manipulation ops. Port of counterfactualworldmodels_tpu/masking/
mask_ops.py. Mask convention: bool, True = masked.

Where the JAX functions draw from a key, the port takes the uniform draws
as ``noise`` or draws them from a ``torch.Generator``; given the JAX draws,
the masks are bitwise the JAX masks.
"""
from __future__ import annotations

from typing import Optional

import torch


def upsample_masks(masks: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbor resize of a [..., h, w] mask to (H, W); integer
    up/down factors only."""
    h, w = masks.shape[-2:]
    H, W = size
    if (H, W) == (h, w):
        return masks
    if H < h and W < w:
        return masks[..., ::h // H, ::w // W]
    if H % h or W % w:
        raise ValueError(f'non-integer upsampling {(h, w)} -> {(H, W)}')
    masks = masks.repeat_interleave(H // h, dim=-2)
    return masks.repeat_interleave(W // w, dim=-1)


def patch_distance_transform(masks: torch.Tensor,
                             self_mask: bool = True) -> torch.Tensor:
    """Normalized L-inf distance from each patch to the nearest visible
    patch. masks: bool [B,T,H,W], True = masked. Returns f32 [B,T,H,W]."""
    b, t, h, w = masks.shape
    dev = masks.device
    m = masks.reshape(b * t, h * w)
    hh = torch.arange(h, dtype=torch.float32, device=dev)
    ww = torch.arange(w, dtype=torch.float32, device=dev)
    dh = (hh[:, None] - hh[None, :]).abs() / max((h - 1) // 2, 1)
    dw = (ww[:, None] - ww[None, :]).abs() / max((w - 1) // 2, 1)
    dist = torch.maximum(dh[:, None, :, None], dw[None, :, None, :])
    dist = dist.reshape(h * w, h * w)
    vis = ~m
    inf = torch.tensor(float('inf'), device=dev)
    d_to_vis = torch.where(vis[:, None, :], dist[None], inf).amin(-1)
    any_vis = vis.any(-1, keepdim=True)
    d_to_vis = torch.where(any_vis, d_to_vis, torch.zeros_like(d_to_vis))
    if self_mask:
        row_max = d_to_vis.amax(-1, keepdim=True)
        d_to_vis = torch.where(vis, row_max, d_to_vis)
    return d_to_vis.reshape(b, t, h, w)


def patches_adjacent_to_visible(masks: torch.Tensor, radius=1, size=None):
    """Patches within ``radius`` (in patch units) of a visible patch.
    radius=None returns the mask unchanged; radius=0 returns a graded
    (float) map."""
    if size is not None:
        masks = masks.reshape(-1, 1, *size)
    if radius is None:
        return masks
    h, w = masks.shape[-2:]
    dists = patch_distance_transform(masks)
    if radius != 0:
        r = 1.0 / max((min(h, w) - 1) // 2, 1)
        return dists <= (r * radius)
    rmax = dists.amax((-1, -2), keepdim=True)
    return (rmax - dists) / torch.clamp(rmax, min=1.0)


def _uniform(shape, noise, generator, device, maxval: float = 1.0):
    if noise is not None:
        return torch.as_tensor(noise, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    return u * maxval if maxval != 1.0 else u


def partition_masks(masks: torch.Tensor, num_samples: int = 2,
                    leave_one_out: bool = False,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Split each row's visible set into S disjoint (or leave-one-out)
    masks. masks: bool [B, N]; noise: [B, N] uniform [0, 1) draws (the JAX
    package's per-row ``uniform(k, (n,))``). Returns a list of S bool
    [B, N] masks."""
    b, n = masks.shape
    s = num_samples
    u = _uniform((b, n), noise, generator, masks.device)
    order = torch.argsort(torch.where(masks, 2.0 + u, u), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    group = rank % s
    num_vis = (~masks).sum(-1, keepdim=True)
    in_vis = rank < num_vis
    out = []
    for i in range(s):
        sel = in_vis & (group == i)
        out.append(torch.where(sel, torch.ones_like(masks), masks)
                   if leave_one_out else ~sel)
    return out


def rectangularize(masks: torch.Tensor, num_visible=None, mode: str = 'min',
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Equalize visible counts across a batch of masks [B, N].

    Rows with surplus visible patches have random visible patches
    re-masked; rows with deficits have random masked patches revealed.
    ``num_visible`` overrides the target; otherwise it follows ``mode`` in
    {'min', 'max', 'mean'} over the batch's MASKED counts ('min' equalizes
    to the least-masked row). noise: [B, N] uniform [0, 0.999) draws (the
    JAX package's ``uniform(key, (b, n), 0, 0.999)``)."""
    if mode in (None, 'none'):
        return masks
    if mode == 'full':
        return torch.ones_like(masks)
    b, n = masks.shape
    if num_visible is None:
        masked_counts = masks.sum(-1)
        if mode == 'min':
            target_masked = masked_counts.min()
        elif mode == 'max':
            target_masked = masked_counts.max()
        else:
            target_masked = masked_counts.float().mean().to(torch.int32)
        num_visible = n - target_masked
    u = _uniform((b, n), noise, generator, masks.device, maxval=0.999)
    priority = (~masks).float() + u
    order = torch.argsort(-priority, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank >= num_visible


def invert_mask_frame(mask: torch.Tensor, size, frame: int = -1
                      ) -> torch.Tensor:
    """Invert one temporal frame of a flat [B, N] mask."""
    shape = mask.shape
    m = mask.reshape(shape[0], -1, *size).clone()
    t = frame % m.shape[1]
    m[:, t] = ~m[:, t]
    return m.reshape(shape)
