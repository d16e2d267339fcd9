"""RAFT optical flow: the large and the small model, with the optional
``output_dim`` head (the keypoint predictor).

Port of counterfactualworldmodels_tpu/models/raft/raft.py. Images come in
NCHW in [0, 255] and flows go out NCHW, like the reference; the internal
convolutions are NCHW as well, while coordinates, the correlation lookup
and the upsampling keep the JAX package's [B, H, W, C] layout. The
convolutions run in the compute dtype, and so does the output head, whose
map is upsampled in it as the JAX package's is; the feature maps, the
correlation volume and the coordinates stay f32. Every
refinement iteration looks the correlation pyramid up with one launch of
the window-lookup kernel on CUDA (radius 4 for the large model, 3 for the
small one), which sums in f32 and writes the compute dtype that ``convc1``
reads. Training runs the plain gather lookup instead
(``corr_lookup='gather'``), the one the JAX package differentiates: the
kernel has no backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..._device import resolve_device
from .corr import IMPLS, all_pairs_correlation, build_pyramid, lookup_pyramid
from .layers import (BasicEncoder, BasicUpdateBlock, Conv2d, FrozenBatchNorm,
                     SmallEncoder, SmallUpdateBlock)


def coords_grid(b: int, h: int, w: int, device='cpu',
                dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 2] grid of (x, y) pixel coordinates."""
    y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device),
                          indexing='ij')
    return torch.stack([x, y], -1)[None].expand(b, h, w, 2)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Convex-combination upsampling. flow: [B, H, W, C] (any C); mask:
    [B, H, W, 9*factor^2]. Returns [B, H*factor, W*factor, C]."""
    b, h, w, c = flow.shape
    u = factor
    m = torch.softmax(mask.reshape(b, h, w, 9, u, u), dim=3)
    fp = F.pad(factor * flow, (0, 0, 1, 1, 1, 1))
    shifts = torch.stack([fp[:, ky:ky + h, kx:kx + w]
                          for ky in range(3) for kx in range(3)], dim=3)
    out = torch.einsum('bhwkuv,bhwkc->bhuwvc', m.float(),
                       shifts.float()).to(flow.dtype)
    return out.reshape(b, h * u, w * u, c)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """Bilinear 8x upsampling (align_corners=True, as the reference) times
    8. flow: [B, H, W, C]. Returns [B, 8H, 8W, C]."""
    _, h, w, _ = flow.shape
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(8 * h, 8 * w),
                       mode='bilinear', align_corners=True)
    return 8 * up.permute(0, 2, 3, 1)


class RAFT(nn.Module):
    """RAFT: the large model (BasicEncoder features/context, SepConvGRU
    update, convex upsampling; hidden and context 128, radius 4) or, with
    ``small``, the small one (SmallEncoder, ConvGRU, bilinear upsampling;
    hidden 96, context 64, radius 3, a context encoder without norms).
    With ``output_dim`` a head (3x3 conv, relu, 1x1 conv) maps the final
    GRU state to output_dim channels, upsampled as the flow would be.

    forward(image1, image2): NCHW [B, 3, H, W] images in [0, 255]; image1
    may have batch 1 against a batch-S image2 (a shared frame 0: encoded
    once and broadcast). Returns (flow_lr [B, 2, H/8, W/8], flow_up
    [B, 2 or output_dim, H, W]); with ``with_sequence`` also every
    iteration's upsampled flow [iters, B, 2, H, W] (the sequence loss'
    input; the last entry is the final flow).

    corr_lookup (the JAX package's attribute): None routes the lookup by
    device (the kernel on CUDA); 'kernel' forces the kernel, 'gather' the
    plain differentiable lookup on every device (corr.lookup_pyramid's
    ``impl``). The refinement keeps the graph through coords1 across
    iterations, as the JAX package's does (no detach)."""

    def __init__(self, corr_levels: int = 4, corr_radius: Optional[int] = None,
                 iters: int = 24, dtype=torch.float32, device='cuda',
                 small: bool = False, output_dim: Optional[int] = None,
                 corr_lookup: Optional[str] = None):
        super().__init__()
        device = resolve_device(device)
        if corr_lookup not in IMPLS:
            raise ValueError(f'corr_lookup must be one of {IMPLS}: '
                             f'{corr_lookup!r}')
        self.corr_lookup = corr_lookup
        self.small = small
        self.output_dim = output_dim
        self.corr_levels = corr_levels
        self.radius = ((3 if small else 4) if corr_radius is None
                       else corr_radius)
        self.iters = iters
        self.dtype = dtype
        self.hidden_dim = 96 if small else 128
        self.context_dim = 64 if small else 128
        cdim = self.hidden_dim + self.context_dim
        if small:
            self.fnet = SmallEncoder(128, 'instance', dtype)
            self.cnet = SmallEncoder(cdim, 'none', dtype)
            self.update_block = SmallUpdateBlock(corr_levels, self.radius,
                                                 self.hidden_dim, dtype)
        else:
            self.fnet = BasicEncoder(256, 'instance', dtype)
            self.cnet = BasicEncoder(cdim, 'batch', dtype)
            self.update_block = BasicUpdateBlock(corr_levels, self.radius,
                                                 self.hidden_dim, dtype)
        if output_dim is not None:
            hid = 192 if small else 256
            self.output_block = nn.Sequential(
                Conv2d(self.hidden_dim, hid, 3, padding=1,
                       compute_dtype=dtype),
                nn.ReLU(),
                Conv2d(hid, output_dim, 1, compute_dtype=dtype))
        self.to(device)

    def train_norm_stats(self) -> 'RAFT':
        """Make every frozen batch norm's statistics trainable parameters,
        as the JAX package's are (its RAFT training updates them). The
        state dict keeps its keys. Returns the module."""
        for m in self.modules():
            if isinstance(m, FrozenBatchNorm):
                m.train_stats()
        return self

    def forward(self, image1, image2, iters: Optional[int] = None,
                with_sequence: bool = False):
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
        up_mask = None
        if not self.small:
            up_mask = torch.zeros(b, h8, w8, 9 * 64, dtype=self.dtype,
                                  device=net.device)
        seq = []
        for _ in range(iters):
            # positional arguments: spies that wrap lookup_pyramid take *a
            corr_feat = lookup_pyramid(pyramid, coords1, self.radius,
                                       self.dtype, self.corr_lookup)
            flow = coords1 - coords0
            net, mask, delta = self.update_block(
                net, inp, corr_feat.permute(0, 3, 1, 2),
                flow.permute(0, 3, 1, 2))
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            if mask is not None:
                up_mask = mask.permute(0, 2, 3, 1)
            if with_sequence:
                seq.append(self._upsample(coords1 - coords0, up_mask))

        flow_lr = coords1 - coords0
        out = flow_lr
        if self.output_dim is not None:
            out = self.output_block(net).permute(0, 2, 3, 1)
        outputs = (flow_lr.permute(0, 3, 1, 2), self._upsample(out, up_mask))
        if with_sequence:
            outputs += (torch.stack(seq),)
        return outputs

    def _upsample(self, out, up_mask):
        """[B, h, w, C] at 1/8 -> [B, C, H, W]: bilinear for the small
        model, convex with the last iteration's mask for the large one."""
        up = upflow8(out) if self.small else convex_upsample(out, up_mask)
        return up.permute(0, 3, 1, 2)


@torch.no_grad()
def apply_raft_video(model: RAFT, video, backward: bool = False,
                     iters: Optional[int] = None, scale_inputs: bool = True):
    """Multiframe wrapper. video: [B, T, C, H, W]; values in [0, 1] when
    scale_inputs else [0, 255]; one frame is paired with itself. Returns
    flows [B, T-1, 2 (or the model's output_dim), H, W]; with ``backward``
    the pair order is swapped and the stack reversed."""
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
    [S, 1, 2 (or the model's output_dim), H, W]."""
    x = video * 255.0 if scale_inputs else video
    flow = model(x[0:1, 0], x[:, 1], iters)[1]
    return flow[:, None]


class RaftKeypointPredictor:
    """The reference's single-image keypoint predictor: a RAFT with
    ``output_dim=1`` run on frame 0 paired with itself.
    ``predictor(x [B, T, C, H, W] in [0, 1]) -> [B, 1, 1, H, W]``;
    ``module`` is the RAFT, into which a generator loads keypoint weights."""

    def __init__(self, module: RAFT):
        self.module = module

    def __call__(self, x):
        return apply_raft_video(self.module, x[:, :1])


class InputPadder:
    """Pad images so spatial dims divide by 8, repeating the edge pixels."""

    def __init__(self, dims, mode='sintel'):
        self.ht, self.wd = dims[-2:]
        pad_ht = (((self.ht // 8) + 1) * 8 - self.ht) % 8
        pad_wd = (((self.wd // 8) + 1) * 8 - self.wd) % 8
        if mode == 'sintel':
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        out = []
        for x in inputs:
            lead, (h, w) = x.shape[:-2], x.shape[-2:]
            # replicate pads the last two dims of a 4-D tensor
            y = F.pad(x.reshape(-1, 1, h, w), self._pad, mode='replicate')
            out.append(y.reshape(*lead, *y.shape[-2:]))
        return out

    def unpad(self, x):
        l, r, t, b = self._pad
        ht, wd = x.shape[-2:]
        return x[..., t:ht - b, l:wd - r]
