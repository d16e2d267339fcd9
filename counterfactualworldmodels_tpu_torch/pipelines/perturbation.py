"""Counterfactual prompt construction: pure tensor edits of (video, mask).

Port of counterfactualworldmodels_tpu/pipelines/perturbation.py. Where the
JAX package builds one sample and vmaps it, these functions take the
sample axis S explicitly: per-sample shifts are a batched gather over S,
and the rectangularizer's uniform noise (jax.random.uniform(key, (n,), 0,
0.999) in JAX) is an input tensor, so tests can inject the JAX draws.

Conventions: video [T, C, H, W] (shared by the samples) or
[S, T, C, H, W]; masks bool, True = masked, frame-major; shifts in patch
units [dy, dx].
"""
from __future__ import annotations

from typing import Optional

import torch

from ..masking.mask_ops import upsample_masks
from ..ops.patches import canonical_patch_size


def translate2d(img: torch.Tensor, shift: torch.Tensor, fill) -> torch.Tensor:
    """Translate the last two dims of img [S, ..., H, W] by per-sample
    shift [S, 2] = (dy, dx), filling with ``fill``:
    out[s, ..., y, x] = img[s, ..., y - dy, x - dx], out of bounds -> fill."""
    s = img.shape[0]
    h, w = img.shape[-2:]
    flat = img.reshape(s, -1, h, w)
    m = flat.shape[1]
    dev = img.device
    ys = torch.arange(h, device=dev)[None] - shift[:, 0:1].long()   # [S, H]
    xs = torch.arange(w, device=dev)[None] - shift[:, 1:2].long()   # [S, W]
    rows = torch.gather(flat, 2, ys.clamp(0, h - 1)[:, None, :, None]
                        .expand(s, m, h, w))
    out = torch.gather(rows, 3, xs.clamp(0, w - 1)[:, None, None, :]
                       .expand(s, m, h, w))
    valid = (((ys >= 0) & (ys < h))[:, None, :, None]
             & ((xs >= 0) & (xs < w))[:, None, None, :])
    out = torch.where(valid, out, torch.full_like(out, fill))
    return out.reshape(img.shape)


def shift_frame_and_mask(x: torch.Tensor, mask_frame: torch.Tensor,
                         shift_patches: torch.Tensor, patch_size,
                         frame: int = 1):
    """Shift one frame's pixels and its (active) mask by per-sample
    patch-unit vectors.

    x: [S, T, C, H, W]; mask_frame: bool [S, h, w] (True = masked);
    shift_patches: int [S, 2] (dy, dx). Returns (x_out [S,T,C,H,W],
    shifted_mask [S,h,w]). The shifted content appears only where the
    SHIFTED mask is visible; elsewhere the original frame stays."""
    _, ph, pw = canonical_patch_size(patch_size)
    scale = torch.tensor([ph, pw], device=shift_patches.device)
    x_f = x[:, frame]
    x_shifted = translate2d(x_f, shift_patches * scale, fill=0.0)
    m_shifted = translate2d(mask_frame, shift_patches, fill=True)
    m_pix = upsample_masks(m_shifted, x_f.shape[-2:]).to(x_f.dtype)[:, None]
    merged = x_shifted * (1.0 - m_pix) + x_f * m_pix
    x_out = x.clone()
    x_out[:, frame] = merged
    return x_out, m_shifted


def rectangularize_row(noise: torch.Tensor, mask_row: torch.Tensor,
                       num_visible) -> torch.Tensor:
    """Force flat bool mask rows [S, n] to exactly ``num_visible`` (int or
    [S]) visible entries by randomly revealing masked / re-masking visible
    entries. noise: [S, n] uniform in [0, 0.999) (the JAX draws)."""
    priority = (~mask_row).float() + noise
    order = torch.argsort(-priority, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    num_visible = torch.as_tensor(num_visible, device=mask_row.device)
    if num_visible.dim() == 1:
        num_visible = num_visible[:, None]
    return rank >= num_visible


def make_motion_counterfactual(x: torch.Tensor, passive: torch.Tensor,
                               active: torch.Tensor, shift: torch.Tensor,
                               noise: Optional[torch.Tensor], patch_size,
                               n_vis_target: Optional[int] = None,
                               frame: int = 1, fix_passive: bool = True):
    """Build S counterfactual (video, mask) pairs of one scene.

    x: [T, C, H, W] (made static from frame 0 when ``fix_passive``);
    passive / active: bool [S, N], True = masked: their visible entries are
    the passive / active patches; shift: int [S, 2] patch-unit motion of
    the active patches; noise: [S, H'*W'] rectangularizer noise for the
    target frame; n_vis_target: total visible count to rectangularize to
    (None skips it). Returns (x_out [S, T, C, H, W], mask [S, N] bool)."""
    _, ph, pw = canonical_patch_size(patch_size)
    t, c, h, w = x.shape
    s = passive.shape[0]
    gh, gw = h // ph, w // pw
    n_per_frame = gh * gw

    if fix_passive:
        x = x[0:1].expand(t, c, h, w)
    xs = x[None].expand(s, t, c, h, w)

    a = active.reshape(s, -1, gh, gw)
    p = passive.reshape(s, -1, gh, gw)
    x_out, a_f_shifted = shift_frame_and_mask(xs, a[:, frame], shift,
                                              patch_size, frame)

    # frame != target: visible = vis(P) | vis(A); target frame:
    # visible = (vis(P) & masked(A)) | vis(shift(A))
    mask = p & a
    mask[:, frame] = (p[:, frame] | ~a[:, frame]) & a_f_shifted
    mask = mask.reshape(s, -1)

    if n_vis_target is not None:
        lead = mask[:, :frame * n_per_frame]
        tail = mask[:, (frame + 1) * n_per_frame:]
        # visible counts outside the target frame are exact already; the
        # target frame absorbs the remaining quota
        quota = n_vis_target - (~lead).sum(-1) - (~tail).sum(-1)
        f_mask = rectangularize_row(
            noise, mask[:, frame * n_per_frame:(frame + 1) * n_per_frame],
            quota)
        mask = torch.cat([lead, f_mask, tail], dim=1)
    return x_out, mask
