"""Flow <-> RGB conversions.

Port of counterfactualworldmodels_tpu/data/utils.py: the HSV flow wheel's
inverse, with ``FlowToRgb`` / ``flow_to_rgb`` / ``hsv_to_rgb`` re-exported
from ``ops.flow_viz``.
"""
from __future__ import annotations

import math

import torch

from ..ops.flow_viz import FlowToRgb, flow_to_rgb, hsv_to_rgb  # noqa: F401


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] RGB in [0,1] -> HSV with hue in radians."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12),
                    torch.zeros_like(maxc))
    safe = torch.clamp(delta, min=1e-12)
    h = torch.where(maxc == r, (g - b) / safe,
                    torch.where(maxc == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    # jnp.mod and torch.remainder both take the divisor's sign
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0),
                    torch.zeros_like(h)) * 2 * math.pi
    return torch.stack([h, s, v], dim=-3)


def rgb_to_xy_flows(flows_rgb: torch.Tensor, to_image_coordinates: bool = True,
                    to_sampling_grid: bool = False,
                    max_speed: float = 1.0) -> torch.Tensor:
    """Invert the HSV flow wheel: [..., 3, H, W] RGB -> [..., 2, H, W]
    flow."""
    hsv = rgb_to_hsv(flows_rgb)
    ang = hsv[..., 0, :, :]
    speed = hsv[..., 2, :, :] * max_speed
    flow_x = torch.cos(ang) * speed
    flow_y = torch.sin(ang) * speed
    if to_sampling_grid:
        return torch.stack([flow_x, -flow_y], dim=-3)
    if to_image_coordinates:
        return torch.stack([-flow_y, flow_x], dim=-3)
    return torch.stack([flow_x, flow_y], dim=-3)


class RgbFlowToXY:
    """Class wrapper mirroring the reference API."""

    def __init__(self, to_image_coordinates=True, to_sampling_grid=False,
                 max_speed=1.0):
        self.to_image_coordinates = to_image_coordinates
        self.to_sampling_grid = to_sampling_grid
        self.max_speed = max_speed

    def __call__(self, flows_rgb):
        return rgb_to_xy_flows(flows_rgb, self.to_image_coordinates,
                               self.to_sampling_grid, self.max_speed)
