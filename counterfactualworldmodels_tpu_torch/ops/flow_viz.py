"""Optical-flow colorization (HSV wheel).

Port of counterfactualworldmodels_tpu/ops/flow_viz.py: the reference
``FlowToRgb`` with kornia's HSV -> RGB conversion (hue in radians).
``torch.remainder`` and ``jnp.mod`` both take the divisor's sign, so
negative angles map as in the JAX package; ``atan2(0, 0)`` is 0 in both.
"""
from __future__ import annotations

import math

import torch


def _select(hi: torch.Tensor, choices) -> torch.Tensor:
    """choices[hi] elementwise, hi in [0, 6) (the JAX package's
    ``jnp.select`` over hi == 0 .. 5)."""
    out = choices[5]
    for i in range(4, -1, -1):
        out = torch.where(hi == i, choices[i], out)
    return out


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV -> RGB with hue in radians on a [..., 3, H, W] tensor."""
    h = torch.remainder(hsv[..., 0, :, :], 2 * math.pi) / (2 * math.pi)
    s = hsv[..., 1, :, :]
    v = hsv[..., 2, :, :]

    hi = torch.remainder(torch.floor(h * 6.0), 6).to(torch.int32)
    f = h * 6.0 - torch.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    r = _select(hi, (v, q, p, p, t, v))
    g = _select(hi, (t, v, v, q, p, p))
    b = _select(hi, (p, p, t, v, v, q))
    return torch.stack([r, g, b], dim=-3)


def flow_to_rgb(flow: torch.Tensor, max_speed: float = 1.0,
                from_image_coordinates: bool = False,
                from_sampling_grid: bool = True) -> torch.Tensor:
    """[..., 2, H, W] flow -> [..., 3, H, W] RGB image."""
    if flow.shape[-3] != 2:
        raise ValueError(f'expected a [..., 2, H, W] flow: {tuple(flow.shape)}')
    if from_sampling_grid:
        flow_x, flow_y = flow[..., 0, :, :], -flow[..., 1, :, :]
    elif not from_image_coordinates:
        flow_x, flow_y = flow[..., 0, :, :], flow[..., 1, :, :]
    else:
        flow_x, flow_y = flow[..., 1, :, :], -flow[..., 0, :, :]

    angle = torch.atan2(flow_y, flow_x)
    speed = torch.sqrt(flow_x ** 2 + flow_y ** 2) / max_speed
    hue = torch.remainder(angle, 2 * math.pi)
    hsv = torch.stack([hue, torch.ones_like(hue), speed], dim=-3)
    return hsv_to_rgb(hsv)


class FlowToRgb:
    """Stateful convenience wrapper mirroring the reference class API."""

    def __init__(self, max_speed: float = 1.0,
                 from_image_coordinates: bool = False,
                 from_sampling_grid: bool = True):
        self.max_speed = max_speed
        self.from_image_coordinates = from_image_coordinates
        self.from_sampling_grid = from_sampling_grid

    def __call__(self, flow):
        return flow_to_rgb(flow, self.max_speed, self.from_image_coordinates,
                           self.from_sampling_grid)
