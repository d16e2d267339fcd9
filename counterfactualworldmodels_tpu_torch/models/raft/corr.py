"""All-pairs correlation volume + pyramid window lookup.

Port of counterfactualworldmodels_tpu/models/raft/corr.py. The correlation
is one matmul, the pyramid reshaped mean-pooling, and the bilinear window
lookup -- torch.grid_sample(align_corners=True, padding_mode='zeros') on
each level, in the reference's [x-offset, y-offset] order -- is the
hand-written kernel of ``csrc/window_lookup.cu`` on CUDA tensors
(``window_lookup``) and its plain version ``_window_lookup`` on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch
import torch.nn.functional as F

from ... import kernels

_lib = None


def _lookup_lib():
    global _lib
    if _lib is None:
        lib = kernels.load('window_lookup')
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cwm_window_lookup.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        lib.cwm_window_lookup.restype = ctypes.c_int
        _lib = lib
    return _lib


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """fmap1/2: [B, H, W, C] -> corr [B, H, W, H, W] f32, scaled by
    1/sqrt(C)."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.float().reshape(b, h * w, c)
    f2 = fmap2.float().reshape(b, h * w, c)
    corr = torch.matmul(f1, f2.transpose(1, 2))
    return (corr / torch.sqrt(torch.tensor(float(c)))).reshape(b, h, w, h, w)


def build_pyramid(corr: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """corr [B, H1, W1, H2, W2] -> list of [B*H1*W1, h, w] levels."""
    b, h1, w1, h2, w2 = corr.shape
    level = corr.reshape(b * h1 * w1, h2, w2)
    pyramid = [level]
    for _ in range(num_levels - 1):
        n, h, w = level.shape
        # avg_pool2d(kernel=2, stride=2) floors odd dims: 7x7 -> 3x3
        level = level[:, :2 * (h // 2), :2 * (w // 2)]
        level = level.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        pyramid.append(level)
    return pyramid


def pad_pyramid(pyramid: List[torch.Tensor], radius: int) -> List[torch.Tensor]:
    """Zero-pad each level by 2*radius+2 so the plain window lookup never
    leaves the array even at the coordinate clip bounds."""
    pad = 2 * radius + 2
    return [F.pad(lv, (pad, pad, pad, pad)) for lv in pyramid]


def _window_lookup(level_padded: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, radius: int, h: int, w: int) -> torch.Tensor:
    """Plain version of the window-lookup kernel: one gather of the shared
    (2r+2)^2 integer patch per query from a level padded by pad_pyramid,
    combined with the separable bilinear weights. x, y: [N] coords in the
    UNPADDED frame. Returns [N, 2r+1, 2r+1], out[:, a, b] = sample at
    (x - r + a, y - r + b)."""
    r = radius
    pad = 2 * r + 2
    win = 2 * r + 2
    n, hp, wp = level_padded.shape
    x = torch.clamp(x, -(r + 1.0), w + r)
    y = torch.clamp(y, -(r + 1.0), h + r)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None, None]
    wy = (y - y0)[:, None, None]
    sy = (y0 - r + pad).long()
    sx = (x0 - r + pad).long()

    ar = torch.arange(win, device=level_padded.device)
    iy = sy[:, None, None] + ar[None, :, None]
    ix = sx[:, None, None] + ar[None, None, :]
    idx = (iy * wp + ix).reshape(n, win * win)
    patch = torch.gather(level_padded.reshape(n, hp * wp), 1,
                         idx).reshape(n, win, win)

    p = 2 * r + 1
    out = ((1 - wy) * (1 - wx) * patch[:, :p, :p] +
           (1 - wy) * wx * patch[:, :p, 1:] +
           wy * (1 - wx) * patch[:, 1:, :p] +
           wy * wx * patch[:, 1:, 1:])
    # out[n, row=y-offset, col=x-offset] -> [x-offset, y-offset]
    return out.transpose(1, 2)


def window_lookup(level: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 window of each query on its UNPADDED level row.

    level: f32 [N, h, w]; x, y: f32 [N] coords in the level's frame.
    Returns f32 [N, 2r+1, 2r+1] in [x-offset, y-offset] order, zeros
    outside the level. CUDA: the lookup kernel; CPU: ``_window_lookup``."""
    n, h, w = level.shape
    if level.device.type == 'cpu':
        return _window_lookup(pad_pyramid([level], radius)[0], x, y, radius,
                              h, w)
    for t in (level, x, y):
        if t.device != level.device:
            raise ValueError('window_lookup: tensors on different devices')
        if t.dtype != torch.float32:
            raise ValueError(f'window_lookup: float32 only, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError('window_lookup: inputs must be contiguous')
    if x.shape != (n,) or y.shape != (n,):
        raise ValueError(f'window_lookup: coords {tuple(x.shape)} / '
                         f'{tuple(y.shape)} do not match {n} queries')
    p = 2 * radius + 1
    out = torch.empty((n, p, p), dtype=torch.float32, device=level.device)
    lib = _lookup_lib()
    with torch.cuda.device(level.device):
        stream = torch.cuda.current_stream(level.device).cuda_stream
        err = lib.cwm_window_lookup(level.data_ptr(), x.data_ptr(),
                                    y.data_ptr(), out.data_ptr(), n, h, w,
                                    radius, stream)
    kernels.check(err, 'window_lookup kernel')
    kernels.LAUNCHES['window_lookup'] += 1
    return out


def lookup_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Index the (unpadded) correlation pyramid around coords [B, H, W, 2]
    (x, y) at 1/8 resolution. Returns [B, H, W, levels * (2r+1)^2], levels
    outer; within a level, offset (i, j) row-major where i offsets x."""
    b, h, w, _ = coords.shape
    p = 2 * radius + 1
    x = coords[..., 0].reshape(b * h * w).float().contiguous()
    y = coords[..., 1].reshape(b * h * w).float().contiguous()
    out = [window_lookup(level, x / (2 ** i), y / (2 ** i), radius)
           .reshape(b, h, w, p * p)
           for i, level in enumerate(pyramid)]
    return torch.cat(out, dim=-1)
