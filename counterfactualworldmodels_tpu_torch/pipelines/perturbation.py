"""Counterfactual prompt construction: pure tensor edits of (video, mask).

Port of counterfactualworldmodels_tpu/pipelines/perturbation.py. Where the
JAX package builds one sample and vmaps it, these functions take the
sample axis S explicitly: per-sample shifts are a batched gather over S,
and the rectangularizer's uniform noise (jax.random.uniform(key, (n,), 0,
0.999) in JAX) is an input tensor, so tests can inject the JAX draws.

Conventions: video [T, C, H, W] (shared by the samples) or
[S, T, C, H, W]; masks bool, True = masked, frame-major; shifts in patch
units [dy, dx]. ``random_shift`` takes its integer draws as an input (or a
``torch.Generator``) where the JAX function takes a key.
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

    x: [T, C, H, W] shared by the samples, or [S, T, C, H, W], one scene
    per sample (made static from frame 0 when ``fix_passive``);
    passive / active: bool [S, N], True = masked: their visible entries are
    the passive / active patches; shift: int [S, 2] patch-unit motion of
    the active patches; noise: [S, H'*W'] rectangularizer noise for the
    target frame; n_vis_target: total visible count to rectangularize to
    (None skips it). Returns (x_out [S, T, C, H, W], mask [S, N] bool)."""
    _, ph, pw = canonical_patch_size(patch_size)
    t, c, h, w = x.shape[-4:]
    s = passive.shape[0]
    gh, gw = h // ph, w // pw
    n_per_frame = gh * gw

    xs = x.expand(s, t, c, h, w)
    if fix_passive:
        xs = xs[:, 0:1].expand(s, t, c, h, w)

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


def make_static_movie(x: torch.Tensor, t: int = 2, frame: int = 0
                      ) -> torch.Tensor:
    """Tile one frame of x [B, T', C, H, W] (or an image [B, C, H, W]) into
    a T-frame static movie."""
    if x.dim() == 4:
        x = x[:, None]
    return x[:, frame % x.shape[1], None].repeat(1, t, 1, 1, 1)


def make_static(x: torch.Tensor, mask: torch.Tensor, patch_size
                ) -> torch.Tensor:
    """Copy frame-0 content into the *visible* patches of frames t > 0;
    masked patches keep their content. x [B, T, C, H, W]; mask bool [B, N]
    (a mask over fewer frames covers the last ones; the leading frames
    count as masked)."""
    _, ph, pw = canonical_patch_size(patch_size)
    b, t, c, h, w = x.shape
    m = mask.reshape(b, -1, h // ph, w // pw)
    m_pix = upsample_masks(m, (h, w)).to(x.dtype)[:, :, None]
    if m.shape[1] != t:
        lead = torch.ones((b, t - m.shape[1], 1, h, w), dtype=x.dtype,
                          device=x.device)
        m_pix = torch.cat([lead, m_pix[:, -1:]], dim=1)
    return (1.0 - m_pix) * x[:, 0:1] + m_pix * x


def multi_shift_patches_and_mask(x: torch.Tensor, masks: torch.Tensor,
                                 perturbation_points: Optional[torch.Tensor],
                                 shifts_px: torch.Tensor, patch_size,
                                 frame: int = 1):
    """Apply a sequence of pixel-space shifts to successive patch groups.

    x: [B, T, C, H, W]; masks: bool [B, N, S]; perturbation_points: bool
    [B, N, S] or None (True entries are the patches TO PERTURB: they are
    masked in the prompt and their complement is passive); shifts_px: int
    [S, 2] pixel shifts, rounded to patch units for the mask. The shifts
    apply one after another to the same video. Returns (x_out
    [B,T,C,H,W], mask [B,N])."""
    _, ph, pw = canonical_patch_size(patch_size)
    b, t, c, h, w = x.shape
    gh, gw = h // ph, w // pw
    s = masks.shape[-1]
    shifts_px = torch.as_tensor(shifts_px, device=x.device)
    scale = torch.tensor([ph, pw], device=x.device)

    m_seq = masks
    p_seq = masks if perturbation_points is None else ~perturbation_points
    if perturbation_points is not None:
        m_seq = masks | perturbation_points

    x_cur = x
    out_masks = []
    for i in range(s):
        pm = p_seq[..., i].reshape(b, -1, gh, gw)
        shift_px = shifts_px[i]
        shift_patch = torch.round(shift_px / scale).to(shift_px.dtype)
        x_f = x_cur[:, frame]
        x_shifted = translate2d(x_f, shift_px.expand(b, 2), fill=0.0)
        m_shifted = translate2d(pm[:, frame], shift_patch.expand(b, 2),
                                fill=True)
        m_pix = upsample_masks(m_shifted, (h, w)).to(x_f.dtype)[:, None]
        x_cur = x_cur.clone()
        x_cur[:, frame] = x_shifted * (1.0 - m_pix) + x_f * m_pix
        full = pm.clone()
        full[:, frame] = m_shifted
        full = full.reshape(b, -1)
        if perturbation_points is not None:
            full = full & m_seq[..., i]
        out_masks.append(full)
    # the elementwise min over the shifts: visible where any is visible
    return x_cur, torch.stack(out_masks, -1).all(-1)


def random_shift(max_shift_fraction: float, image_size, patch_size,
                 fractional: bool = False,
                 draws: Optional[torch.Tensor] = None, num: int = 1,
                 generator: Optional[torch.Generator] = None,
                 device='cpu') -> torch.Tensor:
    """Nonzero random [dy, dx] shifts in patch units (pixels if
    ``fractional``), uniform over +-max_shift_fraction * image_size.

    draws: int [..., 2] uniform integer draws in [-max_h, max_h] x
    [-max_w, max_w] (the JAX package's ``randint``); else ``num`` pairs
    are drawn from ``generator`` on its device (or ``device``). A zero
    shift is bumped to +1 in dx. Returns int64 [..., 2]."""
    _, ph, pw = canonical_patch_size(patch_size)
    h, w = image_size
    max_h = int(max_shift_fraction * h)
    max_w = int(max_shift_fraction * w)
    if draws is None:
        dev = generator.device if generator is not None else device
        draws = torch.stack([
            torch.randint(-max_h, max_h + 1, (num,), generator=generator,
                          device=dev),
            torch.randint(-max_w, max_w + 1, (num,), generator=generator,
                          device=dev)], -1)
    d = torch.as_tensor(draws).long()
    if not fractional:
        d = torch.stack([torch.div(d[..., 0], ph, rounding_mode='floor'),
                         torch.div(d[..., 1], pw, rounding_mode='floor')], -1)
    zero = (d == 0).all(-1, keepdim=True)
    bump = torch.tensor([0, 1], dtype=d.dtype, device=d.device)
    return torch.where(zero, d + bump, d)
