"""Flow-sample rejection filter.

Port of counterfactualworldmodels_tpu/pipelines/filters.py: rejects
degenerate counterfactual flow samples by (a) the selected patch not
moving, (b) the whole scene moving, (c) >= 2 image corners moving.
Rejected samples are zeroed.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

ALL_FILTERS = ('patch_magnitude', 'flow_area', 'num_corners')


def flow_sample_filter(flow_samples: torch.Tensor,
                       active_patches: torch.Tensor,
                       filter_methods: Sequence[str] = ALL_FILTERS,
                       flow_magnitude_threshold: float = 5.0,
                       flow_area_threshold: float = 0.75,
                       num_corners_threshold: int = 2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flow_samples [B,2,H,W,S]; active_patches bool [B,N,S] (N over 2
    frames, True = masked). Returns (filtered flows, reject [B,S] bool)."""
    b, _, h, w, s = flow_samples.shape
    flow_mag = torch.linalg.vector_norm(flow_samples, dim=1)     # [B,H,W,S]

    n = active_patches.shape[1]
    # the frame-1 patch grid from the image aspect (square patches)
    n2 = n // 2
    gh = max(1, int(round((n2 * h / w) ** 0.5)))
    gw = n2 // gh
    if gh * gw != n2:
        raise ValueError(
            f'cannot infer a patch grid with square patches from '
            f'N/2={n2} active entries and a {h}x{w} frame')
    active_second = 1.0 - active_patches[:, gh * gw:, :].float()
    active_second = active_second.transpose(1, 2)                 # [B,S,hw]

    # bilinear downsample of the magnitude map to the patch grid, without
    # antialiasing (the JAX package's jax.image.resize(..., antialias=False))
    mag = flow_mag.permute(0, 3, 1, 2)                            # [B,S,H,W]
    mag_down = F.interpolate(mag, size=(gh, gw), mode='bilinear',
                             align_corners=False, antialias=False)
    mag_down = mag_down.reshape(b, s, gh * gw)
    patch_mag = ((mag_down * active_second).sum(-1)
                 / (active_second.sum(-1) + 1e-12))               # [B,S]

    reject = torch.zeros((b, s), dtype=torch.bool,
                         device=flow_samples.device)
    moving = flow_mag > flow_magnitude_threshold
    for method in filter_methods:
        if method == 'patch_magnitude':
            r = patch_mag < flow_magnitude_threshold
        elif method == 'flow_area':
            area = moving.reshape(b, h * w, s).sum(1) / (h * w)
            r = area > flow_area_threshold
        elif method == 'num_corners':
            corners = (moving[:, 0, 0].float() + moving[:, 0, -1]
                       + moving[:, -1, 0] + moving[:, -1, -1])
            r = corners >= num_corners_threshold
        else:
            raise ValueError(method)
        reject = reject | r

    keep = (~reject).to(flow_samples.dtype)
    return flow_samples * keep[:, None, None, None, :], reject


class FlowSampleFilter:
    """Class wrapper mirroring the reference module API."""

    def __init__(self, filter_methods=ALL_FILTERS,
                 flow_magnitude_threshold=5.0, flow_area_threshold=0.75,
                 num_corners_threshold=2):
        self.filter_methods = tuple(filter_methods)
        self.flow_magnitude_threshold = flow_magnitude_threshold
        self.flow_area_threshold = flow_area_threshold
        self.num_corners_threshold = num_corners_threshold

    def __call__(self, flow_samples, active_patches):
        return flow_sample_filter(
            flow_samples, active_patches, self.filter_methods,
            self.flow_magnitude_threshold, self.flow_area_threshold,
            self.num_corners_threshold)

    def __repr__(self):
        return ('FlowSampleFilter(%s, mag>%.1f, area>%.2f, corners>=%d)' %
                (list(self.filter_methods), self.flow_magnitude_threshold,
                 self.flow_area_threshold, self.num_corners_threshold))
