"""Mask generators. Port of counterfactualworldmodels_tpu/masking/
generators.py: the uniform, tube, rotated-table and forward-backward
policies, the energy sampler, the full-mask and IMU generators, the mixed
generators and the three-frame policy, with their class wrappers.

Popcounts are exact by construction (uniform scores + a stable argsort),
as in the JAX package. Randomness is an input: each function takes its
draws (``scores``, ``offsets``, categorical ``indices``, flip or
full-mask uniforms) or draws them from a ``torch.Generator``. Given the
JAX package's draws for a key, the masks are bitwise those of the JAX
function for that key. A class wrapper owns a seeded ``torch.Generator``
where the JAX class owns a key; its ``sample`` and ``__call__`` pass given
draws through to the function.

Mask convention: bool, True = masked, flattened frame-major then row-major.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from .._device import resolve_device
from ..ops.sampling import Indices, resolve_indices
from .mask_ops import rectangularize, upsample_masks


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


def tube_mask(input_size: Sequence[int], mask_ratio: float,
              clumping_factor=1, batch_size: int = 1, scores=None,
              offsets=None, generator: Optional[torch.Generator] = None):
    """One frame mask per row repeated across all T frames. scores
    [B, gh*gw] and offsets [B, 2] are the per-row draws of
    ``uniform_frame_mask``."""
    t, h, w = input_size
    ch, cw = _canonical_clump(clumping_factor)
    num_masked = int(mask_ratio * (h // ch) * (w // cw))
    if scores is None:
        scores, offsets = frame_draws((batch_size,), h, w, (ch, cw),
                                      generator)
    frame = uniform_frame_mask(h, w, num_masked, (ch, cw), scores, offsets)
    return frame[:, None].expand(batch_size, t, h, w).reshape(batch_size, -1)


def rotated_table_mask(input_size: Sequence[int], mask_ratio: float,
                       tube_length: Optional[int] = None, clumping_factor=1,
                       batch_size: int = 1, scores=None, offsets=None,
                       generator: Optional[torch.Generator] = None):
    """The first T - tube_length frames fully visible, the rest one tube
    mask (``tube_mask``'s draws)."""
    t, h, w = input_size
    tube_length = tube_length or (t - 1)
    tubes = tube_mask((tube_length, h, w), mask_ratio, clumping_factor,
                      batch_size, scores, offsets, generator)
    top = torch.zeros((batch_size, (t - tube_length) * h * w),
                      dtype=torch.bool, device=tubes.device)
    return torch.cat([top, tubes], dim=-1)


def forward_backward_rotated_table_mask(
        input_size: Sequence[int], mask_ratio: float,
        context_mask_ratio: Optional[float] = None, clumping_factor=1,
        flip_prob: float = 0.5, batch_size: int = 1, scores=None,
        offsets=None, context_scores=None, context_offsets=None, flips=None,
        generator: Optional[torch.Generator] = None):
    """Rotated-table masks, time-flipped per row where the uniform
    ``flips`` [B, 1] fall below flip_prob. scores / offsets are the draws
    of the T - 1 masked frames, context_scores / context_offsets those of
    the one context frame (``uniform_mask``'s)."""
    t, h, w = input_size
    masked = uniform_mask((t - 1, h, w), mask_ratio, clumping_factor,
                          batch_size, scores, offsets, generator)
    ctx_ratio = (context_mask_ratio if context_mask_ratio is not None
                 else (1 - mask_ratio))
    vis = uniform_mask((1, h, w), ctx_ratio, clumping_factor, batch_size,
                       context_scores, context_offsets, generator)
    fwd = torch.cat([vis, masked], dim=-1)
    bwd = torch.cat([masked, vis], dim=-1)
    if flips is None:
        flips = torch.rand((batch_size, 1), generator=generator,
                           device=masked.device)
    return torch.where(torch.as_tensor(flips, device=masked.device)
                       < flip_prob, bwd, fwd)


def _pool_energy(energy: torch.Tensor, out_hw: Tuple[int, int],
                 pool_mode: str = 'mean') -> torch.Tensor:
    """Pool a [B,1,H,W] energy map down to [B,1,h,w]."""
    b, c, h, w = energy.shape
    oh, ow = out_hw
    kh, kw = h // oh, w // ow
    if (kh, kw) == (1, 1):
        return energy
    e = energy.reshape(b, c, oh, kh, ow, kw)
    if pool_mode == 'mean':
        return e.mean((3, 5))
    if pool_mode == 'max':
        return e.amax((3, 5))
    if pool_mode == 'min':
        return e.amin((3, 5))
    raise ValueError(pool_mode)


def energy_frame_mask(energy: torch.Tensor, height: int, width: int,
                      num_visible: int, clumping_factor: int = 1,
                      temperature: Optional[float] = None,
                      pool_mode: str = 'mean', energy_power: float = 1,
                      eps: float = 1e-9, indices: Indices = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Sample ``num_visible`` coarse cells proportional to an energy map.

    energy: [B, 1, He, We] (He, We multiples of height, width). The draws
    are max(num_visible, 1) categorical indices per row, with replacement:
    ``indices`` [B, P] (or a callable of the probabilities, see
    ``ops.sampling.resolve_indices``), else drawn from ``generator``. With
    num_visible 0 one point is still drawn, then cleared, as in the JAX
    package. Returns bool [B, H*W]."""
    b = energy.shape[0]
    cf = clumping_factor
    gh, gw = height // cf, width // cf
    e = _pool_energy(energy, (gh, gw), pool_mode)
    if temperature is not None:
        e = e - e.amax((-2, -1), keepdim=True)
        e = torch.exp(e * temperature)
    e = torch.pow(e, energy_power)
    p = e.reshape(b, gh * gw)
    p = p - p.amin(-1, keepdim=True)
    p = torch.relu(p + eps)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=eps)
    idx = resolve_indices(indices, p, max(num_visible, 1), generator)
    visible = torch.zeros((b, gh * gw), dtype=torch.bool, device=p.device)
    visible.scatter_(1, idx, True)
    if num_visible == 0:
        visible = torch.zeros_like(visible)
    visible = visible.reshape(b, gh, gw)
    if cf > 1:
        visible = upsample_masks(visible, (height, width))
    return ~visible.reshape(b, height * width)


def energy_mask(energy: torch.Tensor, input_size: Sequence[int],
                num_visible: int, visible_frames: int = 0,
                clumping_factor: int = 1, temperature: Optional[float] = None,
                pool_mode: str = 'mean', energy_power: float = 1,
                indices: Indices = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full [B, T*H*W] energy-sampled mask with optional leading visible
    frames; every masked frame repeats the one sampled frame."""
    t, h, w = input_size
    b = energy.shape[0]
    m = energy_frame_mask(energy, h, w, num_visible, clumping_factor,
                          temperature, pool_mode, energy_power,
                          indices=indices, generator=generator)
    m = m.repeat(1, t - visible_frames)
    if visible_frames > 0:
        vis = torch.zeros((b, visible_frames * h * w), dtype=torch.bool,
                          device=m.device)
        m = torch.cat([vis, m], dim=-1)
    return m


def rotated_table_energy_mask(energy, input_size, num_visible,
                              clumping_factor=1, temperature=None,
                              pool_mode='mean', energy_power=1, indices=None,
                              generator=None):
    """Energy mask with frame 0 fully visible."""
    return energy_mask(energy, input_size, num_visible, visible_frames=1,
                       clumping_factor=clumping_factor,
                       temperature=temperature, pool_mode=pool_mode,
                       energy_power=energy_power, indices=indices,
                       generator=generator)


# ---------------------------------------------------------------------------
# Class wrappers mirroring the reference API (stateful randomness only).
# ---------------------------------------------------------------------------

class _KeyedGenerator:
    """Base: owns a seeded torch.Generator on ``device`` (the JAX class owns
    a key); each call without given draws takes them from it."""

    def __init__(self, seed: int = 0, device='cuda'):
        self.seed = seed
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        self.generator.manual_seed(self.seed)


class MaskingGenerator(_KeyedGenerator):
    """Uniform per-frame masking with the reference's mask_ratio /
    num_visible accounting."""

    def __init__(self, input_size, mask_ratio, seed=0, visible_frames=0,
                 clumping_factor=1, randomize_num_visible=False,
                 always_batch=True, device='cuda', **unused):
        super().__init__(seed, device)
        if len(input_size) != 3:
            raise ValueError(f'input_size must be (T, H, W): {input_size}')
        self.frames, self.height, self.width = input_size
        self.clumping_factor = clumping_factor
        self.visible_frames = visible_frames
        self.always_batch = always_batch
        self.randomize_num_visible = randomize_num_visible
        ch, cw = _canonical_clump(clumping_factor)
        self.num_patches_per_frame = (self.height // ch) * (self.width // cw)
        self.mask_ratio = mask_ratio

    @property
    def mask_ratio(self):
        return self._mask_ratio

    @mask_ratio.setter
    def mask_ratio(self, val):
        self._mask_ratio = val
        self._num_masks_per_frame = int(val * self.num_patches_per_frame)

    @property
    def num_masks_per_frame(self):
        return self._num_masks_per_frame

    @num_masks_per_frame.setter
    def num_masks_per_frame(self, val):
        self._num_masks_per_frame = int(val)
        self._mask_ratio = val / self.num_patches_per_frame

    @property
    def num_visible(self):
        return self.num_patches_per_frame - self.num_masks_per_frame

    @num_visible.setter
    def num_visible(self, val):
        self.num_masks_per_frame = self.num_patches_per_frame - val

    @property
    def input_size(self):
        return (self.frames, self.height, self.width)

    def sample(self, generator, batch_size=1, **draws):
        m = uniform_mask(self.input_size, self.mask_ratio,
                         self.clumping_factor, batch_size,
                         generator=generator, **draws)
        if self.visible_frames > 0:
            vis = torch.zeros((batch_size, self.visible_frames * self.height
                               * self.width), dtype=torch.bool,
                              device=m.device)
            m = torch.cat([vis, m], dim=-1)
        return m

    def __call__(self, x=None, generator=None, **draws):
        b = 1 if x is None else int(x.shape[0])
        masks = self.sample(generator or self.generator, b, **draws)
        if b == 1 and not self.always_batch:
            masks = masks[0]
        return masks

    def __repr__(self):
        return ('%s: patches/frame %d, masked/frame %d, ratio %.3f' %
                (type(self).__name__, self.num_patches_per_frame,
                 self.num_masks_per_frame, self.mask_ratio))


class UniformMaskingGenerator(MaskingGenerator):
    pass


class TubeMaskingGenerator(MaskingGenerator):
    def sample(self, generator, batch_size=1, **draws):
        return tube_mask(self.input_size, self.mask_ratio,
                         self.clumping_factor, batch_size,
                         generator=generator, **draws)


class RotatedTableMaskingGenerator(MaskingGenerator):
    def __init__(self, *args, tube_length=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.tube_length = tube_length

    def sample(self, generator, batch_size=1, **draws):
        return rotated_table_mask(self.input_size, self.mask_ratio,
                                  self.tube_length, self.clumping_factor,
                                  batch_size, generator=generator, **draws)


class RotatedTableUniformMaskingGenerator(MaskingGenerator):
    """Leading frames visible (default T - 1), the rest uniformly masked;
    with full_mask_prob a row's masked frames are all masked where its
    uniform ``full_draws`` [B, 1] falls below it."""

    def __init__(self, input_size, mask_ratio, visible_frames=None, seed=0,
                 clumping_factor=1, always_batch=True,
                 randomize_num_visible=False, full_mask_prob=0,
                 device='cuda', **unused):
        if len(input_size) != 3:
            raise ValueError(f'input_size must be (T, H, W): {input_size}')
        if visible_frames is None:
            visible_frames = input_size[0] - 1
        super().__init__(
            input_size=(input_size[0] - visible_frames, *input_size[1:]),
            mask_ratio=mask_ratio, seed=seed, visible_frames=visible_frames,
            clumping_factor=clumping_factor, always_batch=always_batch,
            randomize_num_visible=randomize_num_visible, device=device)
        self.full_mask_prob = full_mask_prob

    def sample(self, generator, batch_size=1, full_draws=None, **draws):
        t_total = self.frames + self.visible_frames
        m = rotated_table_uniform_mask(
            (t_total, self.height, self.width), self.mask_ratio,
            self.visible_frames, self.clumping_factor, batch_size,
            generator=generator, **draws)
        if self.full_mask_prob > 0:
            n_vis = self.visible_frames * self.height * self.width
            if full_draws is None:
                full_draws = torch.rand((batch_size, 1), generator=generator,
                                        device=m.device)
            fully = torch.as_tensor(full_draws,
                                    device=m.device) < self.full_mask_prob
            tail = torch.where(fully, torch.ones_like(m[:, n_vis:]),
                               m[:, n_vis:])
            m = torch.cat([m[:, :n_vis], tail], dim=-1)
        return m


class ForwardBackwardRotatedTableMaskingGenerator(
        RotatedTableUniformMaskingGenerator):
    def __init__(self, *args, context_mask_ratio=None, flip_prob=0.5,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.context_mask_ratio = context_mask_ratio
        self.flip_prob = flip_prob

    def sample(self, generator, batch_size=1, **draws):
        t_total = self.frames + self.visible_frames
        return forward_backward_rotated_table_mask(
            (t_total, self.height, self.width), self.mask_ratio,
            self.context_mask_ratio, self.clumping_factor, self.flip_prob,
            batch_size, generator=generator, **draws)


class EnergySamplingMaskingGenerator(MaskingGenerator):
    """Sample visible patches proportional to an energy map."""

    def __init__(self, input_size, mask_ratio, seed=0, temperature=None,
                 clumping_factor=1, pool_mode='mean', eps=1e-9,
                 energy_power=1, visible_frames=0, **kwargs):
        super().__init__(input_size=input_size, mask_ratio=mask_ratio,
                         seed=seed, visible_frames=visible_frames,
                         clumping_factor=clumping_factor, **kwargs)
        self.temperature = temperature
        self.pool_mode = pool_mode
        self.eps = eps
        self.energy_power = energy_power

    @property
    def cf(self):
        return _canonical_clump(self.clumping_factor)[0]

    def __call__(self, energy, indices: Indices = None, generator=None):
        """energy: [B,1,H,W] (or [B,T,1,H,W]: the first frame is used).
        indices: the categorical draws (see ``energy_frame_mask``), else
        drawn from ``generator`` or the sampler's own."""
        energy = torch.as_tensor(energy)
        if energy.dim() == 5:
            energy = energy[:, 0]
        if energy.dim() == 3:
            energy = energy[:, None]
        num_visible = self.num_visible // (self.cf ** 2)
        return energy_mask(
            energy, (self.frames + self.visible_frames, self.height,
                     self.width),
            num_visible, self.visible_frames, self.cf, self.temperature,
            self.pool_mode, self.energy_power, indices=indices,
            generator=generator or self.generator)


class RotatedTableEnergyMaskingGenerator(EnergySamplingMaskingGenerator):
    """Energy sampling with the leading ``visible_frames`` fully visible."""

    def __init__(self, input_size, mask_ratio, visible_frames=1, seed=0,
                 **kwargs):
        super().__init__(
            input_size=(input_size[0] - visible_frames, *input_size[1:]),
            mask_ratio=mask_ratio, seed=seed, visible_frames=visible_frames,
            **kwargs)


class FullMaskGenerator(MaskingGenerator):
    """Fully masked or fully visible with some probability. ``full_draws``:
    the two uniforms (partial?, masked?) of the batch, or with
    full_mask_per_example one uniform per row [B, 1]."""

    def __init__(self, full_mask_prob=0.2, full_vis_prob=0.0,
                 full_mask_per_example=False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.full_mask_prob = min(max(full_mask_prob, 0), 1)
        self.full_vis_prob = min(max(full_vis_prob, 0), 1)
        self.partial_prob = max(1 - self.full_mask_prob - self.full_vis_prob,
                                0)
        self._final_full_mask_prob = self.full_mask_prob / max(
            self.full_mask_prob + self.full_vis_prob, 1e-6)
        self._per_sample = full_mask_per_example

    def sample(self, generator, batch_size=1, full_draws=None, **draws):
        masks = super().sample(generator, batch_size, **draws)
        dev = masks.device
        if not self._per_sample:
            if full_draws is None:
                full_draws = torch.rand(2, generator=generator, device=dev)
            u1, u2 = torch.as_tensor(full_draws, device=dev)
            full = torch.where(u2 < self._final_full_mask_prob,
                               torch.ones_like(masks), torch.zeros_like(masks))
            return torch.where(u1 < self.partial_prob, masks, full)
        if full_draws is None:
            full_draws = torch.rand((batch_size, 1), generator=generator,
                                    device=dev)
        return masks | (torch.as_tensor(full_draws, device=dev)
                        < self.full_mask_prob)


class ImuFullMaskGenerator(FullMaskGenerator):
    """The 1-D token stream variant: input_size tokens as a 1 x 1 x L
    grid."""

    def __init__(self, input_size=10, clumping_factor=1, *args, **kwargs):
        if not isinstance(input_size, int):
            input_size = int(math.prod(input_size))
        super().__init__(input_size=(1, 1, input_size),
                         clumping_factor=(1, clumping_factor), *args, **kwargs)


class MissingDataImuMaskGenerator(ImuFullMaskGenerator):
    """Masks united with a missing-data indicator [B, L], then
    rectangularized by ``truncation_mode`` (its draws ``rect_noise`` [B, L],
    else from the generator's own)."""

    def __init__(self, truncation_mode='max', *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.mode = truncation_mode

    def set_mode(self, mode):
        self.mode = mode

    def __call__(self, missing=None, generator=None, rect_noise=None,
                 **draws):
        gen = generator or self.generator
        b = 1 if missing is None else int(missing.shape[0])
        masks = self.sample(gen, b, **draws)
        if missing is None:
            return masks
        combined = masks | torch.as_tensor(missing,
                                           device=masks.device).bool()
        if self.mode in ('none', None):
            return combined
        return rectangularize(combined, mode=self.mode, noise=rect_noise,
                              generator=gen)


class MixedMaskGenerator:
    """Min-combine several generators (a patch is masked only where every
    generator masks it)."""

    def __init__(self, mask_generator_list, mask_ratio_list=None):
        self.mask_generator_list = mask_generator_list
        if mask_ratio_list is not None:
            for g, r in zip(mask_generator_list, mask_ratio_list):
                g.mask_ratio = r

    def __call__(self, *args, **kwargs):
        masks = torch.stack([g(*args, **kwargs)
                             for g in self.mask_generator_list], dim=-1)
        return masks.all(-1)


class MixedClumpingMaskingGenerator(_KeyedGenerator):
    """A random clumping factor per row: ``choices`` [B] (or one for
    x=None) index the sub-generators, else drawn from the generator."""

    def __init__(self, input_size, mask_ratio, clumping_factor=(1, 2, 4, 8),
                 seed=0, mask_generator_func=MaskingGenerator, device='cuda',
                 **kwargs):
        super().__init__(seed, device)
        if isinstance(clumping_factor, int):
            clumping_factor = (clumping_factor,)
        self.generators = [
            mask_generator_func(input_size=input_size, mask_ratio=mask_ratio,
                                seed=seed, clumping_factor=c,
                                always_batch=True, device=device, **kwargs)
            for c in clumping_factor]

    def _choice(self, choices, i):
        if choices is not None:
            return int(choices[i])
        return int(torch.randint(len(self.generators), (),
                                 generator=self.generator,
                                 device=self.device))

    def __call__(self, x=None, choices=None, **kwargs):
        if x is None:
            return self.generators[self._choice(choices, 0)](x, **kwargs)
        rows = [self.generators[self._choice(choices, i)](x[i:i + 1],
                                                          **kwargs)
                for i in range(int(x.shape[0]))]
        return torch.cat(rows, 0)


class RotatedTableMixedClumpingMaskingGenerator(MixedClumpingMaskingGenerator):
    def __init__(self, *args, **kwargs):
        super().__init__(
            *args, mask_generator_func=RotatedTableUniformMaskingGenerator,
            **kwargs)


def three_frame_forward_backward_mask(input_size, mask_ratio,
                                      independent_samples=True,
                                      fully_visible=False,
                                      batch_size: int = 1, q=None,
                                      scores=None,
                                      generator: Optional[torch.Generator]
                                      = None):
    """3-frame masking: frame 0 masked at a random ratio q [B] (one shared
    q without independent_samples), frame 1 at mask_ratio, frame 2 at
    1 - q. Each frame masks the cells of its num_masked smallest
    ``scores`` [B, 3, H*W]. Returns bool [B, 3*H*W]."""
    t, h, w = input_size
    if t != 3:
        raise ValueError(f'three-frame masking needs T = 3: {input_size}')
    n = h * w
    dev = generator.device if generator is not None else 'cpu'
    if q is None:
        q = torch.rand((batch_size if independent_samples else 1,),
                       generator=generator, device=dev)
    q = torch.as_tensor(q, device=dev).expand(batch_size)
    n1 = (q * n).to(torch.int64)
    n2 = torch.full((batch_size,), int(mask_ratio * n), dtype=torch.int64,
                    device=dev)
    n3 = n - n1
    if fully_visible:
        n1 = torch.zeros_like(n1)
        n3 = torch.zeros_like(n3)
    if scores is None:
        scores = torch.rand((batch_size, t, n), generator=generator,
                            device=dev)
    scores = torch.as_tensor(scores, device=dev)
    rank = torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1,
                         stable=True)
    counts = torch.stack([n1, n2, n3], 1)
    return (rank < counts[..., None]).reshape(batch_size, -1)


class ThreeFrameForwardBackwardMasking(_KeyedGenerator):
    def __init__(self, input_size, mask_ratio, independent_samples=True,
                 fully_visible=False, seed=0, device='cuda', **unused):
        super().__init__(seed, device)
        if len(input_size) == 2:
            input_size = (3, *input_size)
        self.input_size = tuple(input_size)
        self.mask_ratio = mask_ratio
        self.independent_samples = independent_samples
        self.fully_visible = fully_visible

    def __call__(self, x=None, generator=None, **draws):
        b = 1 if x is None else int(x.shape[0])
        return three_frame_forward_backward_mask(
            self.input_size, self.mask_ratio, self.independent_samples,
            self.fully_visible, b, generator=generator or self.generator,
            **draws)
