"""Energy-weighted sampling primitives.

Port of counterfactualworldmodels_tpu/ops/sampling.py. The JAX functions
draw from a ``jax.random`` key; here each draw is an input (``indices``,
``noise``) or comes from a ``torch.Generator``, so tests can inject the JAX
draws. Categorical draws are with replacement, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

Indices = Union[torch.Tensor, Callable[[torch.Tensor, int], torch.Tensor],
                None]


def boltzmann(x: torch.Tensor, beta=1.0, eps: float = 1e-9) -> torch.Tensor:
    """exp(x*beta) normalized by its spatial max."""
    if beta is None:
        return x
    x = torch.exp(x * beta)
    return x / torch.clamp(x.amax((-1, -2), keepdim=True), min=eps)


def resolve_indices(indices: Indices, p: torch.Tensor, num_points: int,
                    generator: Optional[torch.Generator] = None):
    """The draws [B, P] of a categorical sampler over the normalized
    probabilities p [B, G]: ``indices`` as given, a callable
    ``indices(p, num_points)``, or (None) ``torch.multinomial`` with
    replacement from ``generator``."""
    if indices is None:
        return torch.multinomial(p, num_points, replacement=True,
                                 generator=generator)
    if callable(indices):
        indices = indices(p, num_points)
    return torch.as_tensor(indices, device=p.device).long()


def _normalized(p: torch.Tensor, eps: float, normalize: bool):
    if normalize:
        p = p - p.amin(-1, keepdim=True)
    p = torch.relu(p + eps)
    return p / torch.clamp(p.sum(-1, keepdim=True), min=eps)


def sample_image_inds_from_probs(probs: torch.Tensor, num_points: int,
                                 eps: float = 1e-9, normalize: bool = False,
                                 indices: Indices = None,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Draw P (h, w) indices per batch row from a [B, H, W] probability map,
    categorical with replacement. ``indices``: the flat draws [B, P] (or a
    callable, see ``resolve_indices``). Returns int32 [B, P, 2]."""
    b, h, w = probs.shape
    p = _normalized(probs.reshape(b, h * w), eps, normalize)
    idx = resolve_indices(indices, p, num_points, generator)
    idx_h = torch.clamp(torch.div(idx, w, rounding_mode='floor'), 0, h - 1)
    idx_w = torch.clamp(idx % w, 0, w - 1)
    return torch.stack([idx_h, idx_w], -1).to(torch.int32)


def index_into_images(images: torch.Tensor, indices: torch.Tensor
                      ) -> torch.Tensor:
    """Gather values at P points: images [B,C,H,W], indices [B,P,2] ->
    [B,P,C]."""
    if indices.shape[-1] != 2:
        raise ValueError(f'indices must end in (h, w): {tuple(indices.shape)}')
    b, c, h, w = images.shape
    lin = (indices[..., 0].long() * w + indices[..., 1].long())   # [B, P]
    flat = images.reshape(b, c, h * w)
    out = torch.gather(flat, 2, lin[:, None].expand(b, c, lin.shape[1]))
    return out.transpose(1, 2)


def sample_from_energy(probs: torch.Tensor, num_points: int = 1,
                       num_samples: int = 1, binarize: bool = False,
                       normalize: bool = False, eps: float = 1e-9,
                       indices: Indices = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Scatter sampled point energies into a zero map.

    probs: [B,1,H,W] or [B,T,1,H,W]. Returns a map of the same leading shape
    with S*B stacked in the batch dim, nonzero only at the drawn points.
    ``indices``: the flat draws [B*S*T, P] (or a callable)."""
    shape = probs.shape
    if len(shape) == 5:
        b, t, _, h, w = shape
    else:
        b, _, h, w = shape
        t = 1
        probs = probs[:, None]
    s = num_samples
    flat = probs[:, None].expand(b, s, t, 1, h, w).reshape(b * s * t, h, w)
    inds = sample_image_inds_from_probs(flat, num_points, eps=eps,
                                        normalize=normalize, indices=indices,
                                        generator=generator)
    energy = index_into_images(flat[:, None], inds)[..., 0]       # [BST, P]
    if binarize:
        energy = torch.ones_like(energy)
    lin = inds[..., 0].long() * w + inds[..., 1].long()
    activated = torch.zeros((b * s * t, h * w), dtype=flat.dtype,
                            device=flat.device)
    activated.scatter_(1, lin, energy)
    activated = activated.reshape(b * s, t, 1, h, w)
    if len(shape) == 4:
        activated = activated[:, 0]
    return activated


def sample_per_pixel(probs: torch.Tensor, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Bernoulli per-pixel sample: 1 where the uniform ``noise`` (drawn from
    ``generator`` when not given) falls below clip(relu(probs), max=1)."""
    p = torch.clamp(torch.relu(probs), max=1.0)
    if noise is None:
        noise = torch.rand(p.shape, generator=generator, device=p.device,
                           dtype=p.dtype)
    return (noise < p).to(probs.dtype)
