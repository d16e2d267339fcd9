"""Mask generators: the training policy. Port of
counterfactualworldmodels_tpu/masking/generators.py (``uniform_frame_mask``,
``uniform_mask`` and ``rotated_table_uniform_mask`` so far).

Popcounts are exact by construction (uniform scores + a stable argsort),
as in the JAX package. Randomness is an input: each function takes its
draws (``scores``, ``offsets``) or draws them from a ``torch.Generator``.
Given the JAX package's draws for a key, the masks are bitwise those of the
JAX function for that key.

Mask convention: bool, True = masked, flattened frame-major then row-major.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _canonical_clump(clumping_factor) -> Tuple[int, int]:
    if isinstance(clumping_factor, int):
        return (clumping_factor, clumping_factor)
    return tuple(clumping_factor[:2])


def _pads(height, width, ch, cw):
    return height - (height // ch) * ch, width - (width // cw) * cw


def frame_draws(lead: Sequence[int], height: int, width: int,
                clumping_factor=1, generator: Optional[torch.Generator] = None):
    """The draws of ``uniform_frame_mask`` for frames of shape ``lead``:
    (scores [*lead, gh*gw] uniform in [0, 1), offsets [*lead, 2] int64
    placing the clumped block in its padded frame)."""
    ch, cw = _canonical_clump(clumping_factor)
    n = (height // ch) * (width // cw)
    dev = generator.device if generator is not None else 'cpu'
    scores = torch.rand(*lead, n, generator=generator, device=dev)
    pad_h, pad_w = _pads(height, width, ch, cw)
    offsets = torch.stack([
        torch.randint(0, pad_h + 1, tuple(lead), generator=generator,
                      device=dev),
        torch.randint(0, pad_w + 1, tuple(lead), generator=generator,
                      device=dev)], -1)
    return scores, offsets


def uniform_frame_mask(height: int, width: int, num_masked: int,
                       clumping_factor=1, scores=None, offsets=None,
                       generator: Optional[torch.Generator] = None):
    """[..., H, W] bool masks, each frame with exactly ``num_masked`` masked
    coarse cells: the cells of the ``num_masked`` smallest ``scores``
    [..., gh*gw] (stable order). Clumping tiles the coarse grid by the
    clump factor; a grid that does not fill the frame is placed at
    ``offsets`` [..., 2] (row, column) in a fully masked frame. Draws that
    are not given come from ``generator``."""
    ch, cw = _canonical_clump(clumping_factor)
    gh, gw = height // ch, width // cw
    if scores is None:
        scores, drawn = frame_draws((), height, width, (ch, cw), generator)
        offsets = drawn if offsets is None else offsets
    lead = scores.shape[:-1]
    order = torch.argsort(scores, dim=-1, stable=True)
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    mask.scatter_(-1, order[..., :num_masked], True)
    mask = mask.reshape(*lead, gh, gw)
    if max(ch, cw) == 1:
        return mask
    mask = mask.repeat_interleave(ch, dim=-2).repeat_interleave(cw, dim=-1)
    pad_h, pad_w = _pads(height, width, ch, cw)
    if not (pad_h or pad_w):
        return mask
    if offsets is None:
        offsets = frame_draws(lead, height, width, (ch, cw), generator)[1]
    offsets = torch.as_tensor(offsets, device=mask.device)
    off_h = offsets[..., 0, None, None]
    off_w = offsets[..., 1, None, None]
    rows = torch.arange(height, device=mask.device)[:, None]
    cols = torch.arange(width, device=mask.device)[None, :]
    r, c = rows - off_h, cols - off_w                    # [..., H, W]
    inside = (r >= 0) & (r < gh * ch) & (c >= 0) & (c < gw * cw)
    flat = mask.reshape(*lead, -1)
    idx = (r.clamp(0, gh * ch - 1) * (gw * cw)
           + c.clamp(0, gw * cw - 1)).reshape(*lead, -1)
    src = torch.gather(flat, -1, idx.expand(*lead, -1)).reshape(
        *lead, height, width)
    return torch.where(inside, src, torch.ones_like(src))


def uniform_mask(input_size: Sequence[int], mask_ratio: float,
                 clumping_factor=1, batch_size: int = 1, scores=None,
                 offsets=None, generator: Optional[torch.Generator] = None):
    """[B, T*H*W] mask, each frame masked independently at exact ratio.
    scores [B, T, gh*gw] and offsets [B, T, 2] are the per-(row, frame)
    draws of ``uniform_frame_mask``."""
    t, h, w = input_size
    ch, cw = _canonical_clump(clumping_factor)
    num_masked = int(mask_ratio * (h // ch) * (w // cw))
    if scores is None:
        scores, offsets = frame_draws((batch_size, t), h, w, (ch, cw),
                                      generator)
    elif tuple(scores.shape) != (batch_size, t, (h // ch) * (w // cw)):
        raise ValueError(f'scores of shape {tuple(scores.shape)} do not fit '
                         f'{batch_size} rows of {t} frames of '
                         f'{(h // ch) * (w // cw)} cells')
    masks = uniform_frame_mask(h, w, num_masked, (ch, cw), scores, offsets)
    return masks.reshape(batch_size, -1)


def rotated_table_uniform_mask(input_size: Sequence[int], mask_ratio: float,
                               visible_frames: Optional[int] = None,
                               clumping_factor=1, batch_size: int = 1,
                               scores=None, offsets=None,
                               generator: Optional[torch.Generator] = None):
    """The training policy: ``visible_frames`` leading frames fully visible
    (default T - 1), each remaining frame independently masked at exact
    ratio. scores / offsets are the draws of ``uniform_mask`` over the
    masked frames. Returns bool [B, T*H*W]."""
    t, h, w = input_size
    if visible_frames is None:
        visible_frames = t - 1
    rest = uniform_mask((t - visible_frames, h, w), mask_ratio,
                        clumping_factor, batch_size, scores, offsets,
                        generator)
    vis = torch.zeros((batch_size, visible_frames * h * w), dtype=torch.bool,
                      device=rest.device)
    return torch.cat([vis, rest], dim=-1)
