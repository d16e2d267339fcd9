"""RAFT optical flow (large model).

Port of counterfactualworldmodels_tpu/models/raft/raft.py. Images come in
NCHW in [0, 255] and flows go out NCHW, like the reference; the internal
convolutions are NCHW as well, while coordinates, the correlation lookup
and the convex upsampling keep the JAX package's [B, H, W, 2] layout. The
convolutions run in the compute dtype; the feature maps, the correlation
volume and the coordinates stay f32. Every refinement iteration looks the
correlation pyramid up through the window-lookup kernel on CUDA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..._device import resolve_device
from .corr import all_pairs_correlation, build_pyramid, lookup_pyramid
from .layers import BasicEncoder, BasicUpdateBlock


def coords_grid(b: int, h: int, w: int, device='cpu',
                dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 2] grid of (x, y) pixel coordinates."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing='ij')
    return torch.stack([x, y], -1)[None].expand(b, h, w, 2)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Convex-combination upsampling. flow: [B, H, W, C]; mask:
    [B, H, W, 9*factor^2]. Returns [B, H*factor, W*factor, C]."""
    b, h, w, c = flow.shape
    u = factor
    m = torch.softmax(mask.reshape(b, h, w, 9, u, u), dim=3)
    fp = nn.functional.pad(factor * flow, (0, 0, 1, 1, 1, 1))
    shifts = torch.stack([fp[:, ky:ky + h, kx:kx + w]
                          for ky in range(3) for kx in range(3)], dim=3)
    out = torch.einsum('bhwkuv,bhwkc->bhuwvc', m.float(),
                       shifts.float()).to(flow.dtype)
    return out.reshape(b, h * u, w * u, c)


class RAFT(nn.Module):
    """The large RAFT model (BasicEncoder features/context, SepConvGRU
    update, convex upsampling).

    forward(image1, image2): NCHW [B, 3, H, W] images in [0, 255]; image1
    may have batch 1 against a batch-S image2 (a shared frame 0: encoded
    once and broadcast). Returns (flow_lr [B, 2, H/8, W/8],
    flow_up [B, 2, H, W])."""

    def __init__(self, corr_levels: int = 4, corr_radius: Optional[int] = None,
                 iters: int = 24, dtype=torch.float32, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.corr_levels = corr_levels
        self.radius = 4 if corr_radius is None else corr_radius
        self.iters = iters
        self.dtype = dtype
        self.hidden_dim = 128
        self.context_dim = 128
        self.fnet = BasicEncoder(256, 'instance', dtype)
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, 'batch',
                                 dtype)
        self.update_block = BasicUpdateBlock(corr_levels, self.radius,
                                             self.hidden_dim, dtype)
        self.to(device)

    def forward(self, image1, image2, iters: Optional[int] = None):
        iters = self.iters if iters is None else iters
        hdim = self.hidden_dim
        x1 = 2 * (image1 / 255.0) - 1.0
        x2 = 2 * (image2 / 255.0) - 1.0

        if x1.shape[0] == x2.shape[0]:
            fmap1, fmap2 = self.fnet(torch.cat([x1, x2])).float().chunk(2)
        else:
            # shared frame 0: every norm in the encoders is frozen or
            # per-sample, so encoding it once equals encoding it S times
            if x1.shape[0] != 1:
                raise ValueError(f'image1 batch {x1.shape[0]} must be 1 or '
                                 f'match image2 batch {x2.shape[0]}')
            fmap2 = self.fnet(x2).float()
            fmap1 = self.fnet(x1).float().expand_as(fmap2)
        corr = all_pairs_correlation(fmap1.permute(0, 2, 3, 1),
                                     fmap2.permute(0, 2, 3, 1))
        pyramid = build_pyramid(corr, self.corr_levels)

        c = self.cnet(x1)
        net = torch.tanh(c[:, :hdim])
        inp = torch.relu(c[:, hdim:])
        if net.shape[0] != x2.shape[0]:
            net = net.expand(x2.shape[0], *net.shape[1:])
            inp = inp.expand(x2.shape[0], *inp.shape[1:])

        b, _, h8, w8 = net.shape
        coords0 = coords_grid(b, h8, w8, device=net.device)
        coords1 = coords0.clone()
        up_mask = torch.zeros(b, h8, w8, 9 * 64, dtype=self.dtype,
                              device=net.device)
        for _ in range(iters):
            corr_feat = lookup_pyramid(pyramid, coords1, self.radius)
            flow = coords1 - coords0
            net, mask, delta = self.update_block(
                net, inp, corr_feat.permute(0, 3, 1, 2),
                flow.permute(0, 3, 1, 2))
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            up_mask = mask.permute(0, 2, 3, 1)

        flow_lr = coords1 - coords0
        flow_up = convex_upsample(flow_lr, up_mask)
        return flow_lr.permute(0, 3, 1, 2), flow_up.permute(0, 3, 1, 2)


@torch.no_grad()
def apply_raft_video(model: RAFT, video, backward: bool = False,
                     iters: Optional[int] = None, scale_inputs: bool = True):
    """Multiframe wrapper. video: [B, T, C, H, W]; values in [0, 1] when
    scale_inputs else [0, 255]. Returns flows [B, T-1, 2, H, W]; with
    ``backward`` the pair order is swapped and the stack reversed."""
    x = video * 255.0 if scale_inputs else video
    if x.dim() == 4:
        x = x[:, None]
    if x.shape[1] == 1:
        x = x.repeat(1, 2, 1, 1, 1)
    flows = []
    for i in range(x.shape[1] - 1):
        a, bb = x[:, i], x[:, i + 1]
        if backward:
            a, bb = bb, a
        flow = model(a, bb, iters)[1]
        if backward:
            flows.insert(0, flow)
        else:
            flows.append(flow)
    return torch.stack(flows, 1)


@torch.no_grad()
def apply_raft_shared0(model: RAFT, video, iters: Optional[int] = None,
                       scale_inputs: bool = True):
    """Counterfactual-batch flow probe: ``video`` [S, 2, C, H, W] whose
    frame 0 is the same scene in every sample. The feature and context
    encoders run once on frame 0 instead of S times. Returns flows
    [S, 1, 2, H, W]."""
    x = video * 255.0 if scale_inputs else video
    flow = model(x[0:1, 0], x[:, 1], iters)[1]
    return flow[:, None]
