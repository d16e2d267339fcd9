"""Video <-> patch-vector conversion.

Port of counterfactualworldmodels_tpu/ops/patches.py, same layout:
    video  [B, T, C, H, W]   (temporal_dim=1) or [B, C, T, H, W] (temporal_dim=2)
    patches [B, N, D*C] with N = (T/pt)*(H/ph)*(W/pw), D = pt*ph*pw,
    flattened frame-major then row-major: n = t*(H'*W') + i*W' + j,
    and within a patch the layout is (pt, ph, pw, c) flattened.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def canonical_patch_size(patch_size) -> Tuple[int, int, int]:
    """Normalize an int / 2-tuple / 3-tuple patch size to (pt, ph, pw)."""
    if isinstance(patch_size, int):
        return (1, patch_size, patch_size)
    patch_size = tuple(patch_size)
    if len(patch_size) == 2:
        return (1, patch_size[0], patch_size[1])
    if len(patch_size) != 3:
        raise ValueError(f'patch size must have 1, 2 or 3 entries: {patch_size}')
    return patch_size


def num_patches(video_shape: Sequence[int], patch_size) -> int:
    """Number of patch tokens for a [B,T,C,H,W] video shape."""
    pt, ph, pw = canonical_patch_size(patch_size)
    _, t, _, h, w = video_shape
    return (t // pt) * (h // ph) * (w // pw)


def mask_shape(video_shape: Sequence[int], patch_size) -> Tuple[int, int, int]:
    """(T', H', W') grid of patch tokens for a [B,T,C,H,W] video shape."""
    pt, ph, pw = canonical_patch_size(patch_size)
    _, t, _, h, w = video_shape
    return (t // pt, h // ph, w // pw)


def patchify(x: torch.Tensor, patch_size, temporal_dim: int = 1,
             squeeze_channel_dim: bool = True) -> torch.Tensor:
    """Video [B,T,C,H,W] (or image [B,C,H,W]) -> patch vectors
    [B, N, pt*ph*pw*C] (or [B, N, pt*ph*pw, C] if not squeeze_channel_dim)."""
    pt, ph, pw = canonical_patch_size(patch_size)
    if x.dim() == 4:
        if pt != 1:
            raise ValueError(f'image input needs pt == 1, got {pt}')
        b, c, h, w = x.shape
        out = x.reshape(b, c, h // ph, ph, w // pw, pw)
        out = out.permute(0, 2, 4, 3, 5, 1)          # b h w ph pw c
        out = out.reshape(b, (h // ph) * (w // pw), ph * pw, c)
    else:
        if temporal_dim == 1:
            b, t, c, h, w = x.shape
            out = x.reshape(b, t // pt, pt, c, h // ph, ph, w // pw, pw)
            out = out.permute(0, 1, 4, 6, 2, 5, 7, 3)  # b t h w pt ph pw c
        else:
            b, c, t, h, w = x.shape
            out = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw)
            out = out.permute(0, 2, 4, 6, 3, 5, 7, 1)
        out = out.reshape(b, (t // pt) * (h // ph) * (w // pw),
                          pt * ph * pw, c)
    if squeeze_channel_dim:
        out = out.reshape(out.shape[0], out.shape[1], -1)
    return out


def unpatchify(patches: torch.Tensor, patch_size, video_shape: Sequence[int],
               temporal_dim: int = 1) -> torch.Tensor:
    """Inverse of :func:`patchify` for a full set of N patches;
    ``video_shape`` is the original [B,T,C,H,W] (or [B,C,H,W]) shape."""
    pt, ph, pw = canonical_patch_size(patch_size)
    if len(video_shape) == 4:
        b, c, h, w = video_shape
        t = 1
    elif temporal_dim == 1:
        b, t, c, h, w = video_shape
    else:
        b, c, t, h, w = video_shape
    gt, gh, gw = t // pt, h // ph, w // pw
    vid = patches.reshape(b, gt, gh, gw, pt, ph, pw, c)
    vid = vid.permute(0, 7, 1, 4, 2, 5, 3, 6)           # b c t pt h ph w pw
    vid = vid.reshape(b, c, gt * pt, gh * ph, gw * pw)
    if len(video_shape) == 4:
        return vid[:, :, 0]
    if temporal_dim == 1:
        vid = vid.transpose(1, 2)
    return vid


def average_within_patches(z: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Mean over the intra-patch dim, broadcast back: z [B, N, D*C] (as
    [B, N, D, C]) or [B, N, D, C]."""
    if z.dim() == 3:
        z = z.reshape(z.shape[0], z.shape[1], -1, num_channels)
    return z.mean(-2, keepdim=True).expand(z.shape)
