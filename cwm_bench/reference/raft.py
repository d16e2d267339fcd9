"""Plain RAFT (the large model), after Teed and Deng, "RAFT: Recurrent
All-Pairs Field Transforms for Optical Flow" (ECCV 2020) and its public
code (princeton-vl/RAFT, core/raft.py, extractor.py, update.py, corr.py).

Module and parameter names are the public code's, so its state dicts load.
Everything runs in float32 through ``prec`` (precision.F32, or the FP8
control). The correlation lookup samples each pyramid level with
``grid_sample`` (align_corners, zero padding) as the public code's
``bilinear_sampler`` does; the flow is upsampled by the convex combination
of ``upsample_flow``. Inference only: no dropout, frozen batch norms.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import F32


class Conv(nn.Conv2d):
    prec = F32

    def forward(self, x):
        return self.prec.conv2d(x, self.weight, self.bias, self.stride,
                                self.padding)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return F.instance_norm(x, eps=1e-5)


class BatchNorm(nn.BatchNorm2d):
    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _norm(kind, c):
    return BatchNorm(c) if kind == 'batch' else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, cin, c, norm, stride):
        super().__init__()
        self.conv1 = Conv(cin, c, 3, padding=1, stride=stride)
        self.conv2 = Conv(c, c, 3, padding=1)
        self.norm1, self.norm2 = _norm(norm, c), _norm(norm, c)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, c)
            self.downsample = nn.Sequential(Conv(cin, c, 1, stride=stride),
                                            self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, out, norm):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm, 1),
                                    ResidualBlock(64, 64, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2),
                                    ResidualBlock(96, 96, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2),
                                    ResidualBlock(128, 128, norm, 1))
        self.conv2 = Conv(128, out, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class SepConvGRU(nn.Module):
    def __init__(self, hidden=128, inp=384):
        super().__init__()
        c = hidden + inp
        self.convz1 = Conv(c, hidden, (1, 5), padding=(0, 2))
        self.convr1 = Conv(c, hidden, (1, 5), padding=(0, 2))
        self.convq1 = Conv(c, hidden, (1, 5), padding=(0, 2))
        self.convz2 = Conv(c, hidden, (5, 1), padding=(2, 0))
        self.convr2 = Conv(c, hidden, (5, 1), padding=(2, 0))
        self.convq2 = Conv(c, hidden, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f'convz{i}')(hx))
            r = torch.sigmoid(getattr(self, f'convr{i}')(hx))
            q = torch.tanh(getattr(self, f'convq{i}')(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self, levels, radius):
        super().__init__()
        planes = levels * (2 * radius + 1) ** 2
        self.convc1 = Conv(planes, 256, 1)
        self.convc2 = Conv(256, 192, 3, padding=1)
        self.convf1 = Conv(2, 128, 7, padding=3)
        self.convf2 = Conv(128, 64, 3, padding=1)
        self.conv = Conv(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, cin=128, hidden=256):
        super().__init__()
        self.conv1 = Conv(cin, hidden, 3, padding=1)
        self.conv2 = Conv(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, levels, radius, hidden=128):
        super().__init__()
        self.encoder = BasicMotionEncoder(levels, radius)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(Conv(hidden, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  Conv(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def bilinear_sampler(img, coords):
    """img [N, 1, h, w]; coords [N, a, b, 2] pixel (x, y)."""
    h, w = img.shape[-2:]
    x, y = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


class CorrBlock:
    def __init__(self, fmap1, fmap2, levels, radius, prec):
        b, c, h, w = fmap1.shape
        f1 = fmap1.reshape(b, c, h * w).transpose(1, 2)
        f2 = fmap2.reshape(b, c, h * w)
        corr = prec.matmul(f1, f2) / torch.sqrt(torch.tensor(float(c)))
        corr = corr.reshape(b * h * w, 1, h, w)
        self.pyramid = [corr]
        for _ in range(levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.pyramid.append(corr)
        self.radius = radius

    def __call__(self, coords):
        r = self.radius
        b, _, h, w = coords.shape
        coords = coords.permute(0, 2, 3, 1)
        d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(d, d, indexing='ij'), dim=-1)
        out = []
        for i, level in enumerate(self.pyramid):
            centroid = coords.reshape(b * h * w, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(level, centroid + delta[None])
            out.append(sampled.reshape(b, h, w, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).float()


def coords_grid(b, h, w, device):
    y, x = torch.meshgrid(torch.arange(h, device=device),
                          torch.arange(w, device=device), indexing='ij')
    return torch.stack([x, y], dim=0).float()[None].repeat(b, 1, 1, 1)


def upsample_flow(flow, mask):
    """[B, 2, h, w] -> [B, 2, 8h, 8w], convex combination of 3x3
    neighbours."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.view(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """The large RAFT: feature and context encoders, correlation pyramid
    of ``levels`` levels at ``radius``, ``iters`` SepConvGRU updates."""

    def __init__(self, levels: int = 4, radius: int = 4, iters: int = 24):
        super().__init__()
        self.levels, self.radius, self.iters = levels, radius, iters
        self.fnet = BasicEncoder(256, 'instance')
        self.cnet = BasicEncoder(256, 'batch')
        self.update_block = BasicUpdateBlock(levels, radius, 128)
        self.prec = F32

    def set_precision(self, prec) -> 'RAFT':
        self.prec = prec
        for m in self.modules():
            if isinstance(m, Conv):
                m.prec = prec
        return self

    @torch.no_grad()
    def forward(self, image1, image2):
        """image1 [1 or B, 3, H, W] and image2 [B, 3, H, W] in [0, 255];
        a batch-1 image1 is every sample's first frame. Returns the
        upsampled flow [B, 2, H, W]."""
        x1 = 2 * (image1 / 255.0) - 1.0
        x2 = 2 * (image2 / 255.0) - 1.0
        b = x2.shape[0]
        fmap1 = self.fnet(x1).expand(b, -1, -1, -1)
        fmap2 = self.fnet(x2)
        corr_fn = CorrBlock(fmap1, fmap2, self.levels, self.radius,
                            self.prec)
        c = self.cnet(x1)
        net = torch.tanh(c[:, :128]).expand(b, -1, -1, -1)
        inp = torch.relu(c[:, 128:]).expand(b, -1, -1, -1)
        _, _, h, w = net.shape
        coords0 = coords_grid(b, h, w, net.device)
        coords1 = coords0.clone()
        mask = None
        for _ in range(self.iters):
            corr = corr_fn(coords1)
            net, mask, delta = self.update_block(net, inp, corr,
                                                 coords1 - coords0)
            coords1 = coords1 + delta
        return upsample_flow(coords1 - coords0, mask)
