"""RAFT building blocks (NCHW, nn.Conv2d).

Port of counterfactualworldmodels_tpu/models/raft/layers.py (the large
and the small model's blocks). Module and parameter names follow the
reference torch RAFT, so a reference-layout state dict loads with
strict=True. Every convolution runs in the model's compute dtype (inputs,
weights and bias cast at the call, as flax's nn.Conv(dtype=...) does);
weights stay f32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d in eval mode; the buffers hold the running stats."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('weight', torch.ones(features))
        self.register_buffer('bias', torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


class InstanceNorm(nn.Module):
    """InstanceNorm2d with torch defaults (affine=False). NCHW input."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


def make_norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == 'batch':
        return FrozenBatchNorm(features)
    if norm_fn == 'instance':
        return InstanceNorm()
    if norm_fn == 'group':
        # flax's GroupNorm epsilon (torch's default is 1e-5)
        return nn.GroupNorm(features // 8, features, eps=1e-6)
    if norm_fn == 'none':
        return nn.Identity()
    raise ValueError(f'unknown norm {norm_fn!r}')


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = 'batch',
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            compute_dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, compute_dtype=dtype)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            # the reference registers this norm twice: as norm3 and inside
            # the downsample Sequential; both keys name the same tensors
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride,
                       compute_dtype=dtype), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """The small model's residual block (1x1 -> 3x3 -> 1x1)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = 'batch',
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        p4 = planes // 4
        self.conv1 = Conv2d(in_planes, p4, 1, compute_dtype=dtype)
        self.conv2 = Conv2d(p4, p4, 3, stride=stride, padding=1,
                            compute_dtype=dtype)
        self.conv3 = Conv2d(p4, planes, 1, compute_dtype=dtype)
        self.norm1 = make_norm(norm_fn, p4)
        self.norm2 = make_norm(norm_fn, p4)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm4 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride,
                       compute_dtype=dtype), self.norm4)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Feature / context encoder of the large model (residual blocks).
    Input NCHW in [-1, 1]."""
    dims, block = (64, 96, 128), ResidualBlock

    def __init__(self, output_dim: int = 128, norm_fn: str = 'batch',
                 dtype=torch.float32):
        super().__init__()
        stem = self.dims[0]
        self.conv1 = Conv2d(3, stem, 7, stride=2, padding=3,
                            compute_dtype=dtype)
        self.norm1 = make_norm(norm_fn, stem)
        layers, in_planes = [], stem
        for dim, stride in zip(self.dims, (1, 2, 2)):
            layers.append(nn.Sequential(
                self.block(in_planes, dim, norm_fn, stride, dtype),
                self.block(dim, dim, norm_fn, 1, dtype)))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv2d(in_planes, output_dim, 1, compute_dtype=dtype)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class SmallEncoder(BasicEncoder):
    """Feature / context encoder of the small model (bottleneck blocks)."""
    dims, block = (32, 64, 96), BottleneckBlock


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1,
                            compute_dtype=dtype)
        self.conv2 = Conv2d(hidden_dim, 2, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """Separable ConvGRU. The z and r gates read the same [h, x] input, so
    their convolutions run as one conv with stacked output channels (the
    same per-channel math; the parameters stay separate)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 dtype=torch.float32):
        super().__init__()
        c = hidden_dim + input_dim
        for i, (k, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), 1):
            for g in 'zrq':
                setattr(self, f'conv{g}{i}',
                        Conv2d(c, hidden_dim, k, padding=pad,
                               compute_dtype=dtype))

    @staticmethod
    def _zr(convz, convr, hx):
        dt = convz.compute_dtype
        w = torch.cat([convz.weight, convr.weight]).to(dt)
        b = torch.cat([convz.bias, convr.bias]).to(dt)
        zr = torch.sigmoid(F.conv2d(hx.to(dt), w, b, padding=convz.padding))
        return zr.chunk(2, dim=1)

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z, r = self._zr(getattr(self, f'convz{i}'),
                            getattr(self, f'convr{i}'), hx)
            q = torch.tanh(getattr(self, f'convq{i}')(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    """Plain ConvGRU (3x3 kernels) of the small model; z and r run as one
    conv, as in SepConvGRU."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 146,
                 dtype=torch.float32):
        super().__init__()
        c = hidden_dim + input_dim
        for g in 'zrq':
            setattr(self, f'conv{g}', Conv2d(c, hidden_dim, 3, padding=1,
                                             compute_dtype=dtype))

    def forward(self, h, x):
        z, r = SepConvGRU._zr(self.convz, self.convr, torch.cat([h, x], dim=1))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dtype=torch.float32):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = Conv2d(cor_planes, 256, 1, compute_dtype=dtype)
        self.convc2 = Conv2d(256, 192, 3, padding=1, compute_dtype=dtype)
        self.convf1 = Conv2d(2, 128, 7, padding=3, compute_dtype=dtype)
        self.convf2 = Conv2d(128, 64, 3, padding=1, compute_dtype=dtype)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1,
                           compute_dtype=dtype)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 3,
                 dtype=torch.float32):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = Conv2d(cor_planes, 96, 1, compute_dtype=dtype)
        self.convf1 = Conv2d(2, 64, 7, padding=3, compute_dtype=dtype)
        self.convf2 = Conv2d(64, 32, 3, padding=1, compute_dtype=dtype)
        self.conv = Conv2d(32 + 96, 80, 3, padding=1, compute_dtype=dtype)

    def forward(self, flow, corr):
        c = F.relu(self.convc1(corr))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 hidden_dim: int = 128, dtype=torch.float32):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius, dtype)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim, dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype)
        self.mask = nn.Sequential(
            Conv2d(hidden_dim, 256, 3, padding=1, compute_dtype=dtype),
            nn.ReLU(),
            Conv2d(256, 64 * 9, 1, compute_dtype=dtype))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        inp = torch.cat([inp, motion], dim=1)
        net = self.gru(net, inp)
        delta = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, mask, delta


class SmallUpdateBlock(nn.Module):
    """The small model's update: no upsampling mask (it returns None)."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 3,
                 hidden_dim: int = 96, dtype=torch.float32):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_levels, corr_radius, dtype)
        self.gru = ConvGRU(hidden_dim, 82 + 64, dtype)
        self.flow_head = FlowHead(hidden_dim, 128, dtype)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)
