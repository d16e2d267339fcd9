"""All-pairs correlation volume + pyramid window lookup.

Port of counterfactualworldmodels_tpu/models/raft/corr.py. The correlation
is one matmul, the pyramid reshaped mean-pooling, and the bilinear window
lookup -- torch.grid_sample(align_corners=True, padding_mode='zeros') on
each level, in the reference's [x-offset, y-offset] order -- is the
hand-written kernel of ``csrc/window_lookup.cu`` on CUDA tensors, one launch
for all levels of a ``lookup_pyramid`` call (``window_lookup`` is its
one-level call), and the plain versions ``_lookup_pyramid`` and
``_window_lookup`` on the CPU. The kernel has no backward: training runs
the plain version by name (``impl='gather'``, differentiable through the
levels and the coordinates), and the kernel refuses inputs that autograd
records.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ... import kernels

# what the kernel takes: its compile-time maximum of levels
# (csrc/window_lookup.cu kMaxLevels), the radii it is built for (RAFT's
# small and large models) and its output dtypes
MAX_LEVELS = 4
RADII = (3, 4)
OUT_DTYPES = (torch.float32, torch.bfloat16)

IMPLS = (None, 'kernel', 'gather')

_lib = None


def _lookup_lib():
    global _lib
    if _lib is None:
        lib = kernels.load('window_lookup')
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cwm_window_lookup.argtypes = [
            ctypes.POINTER(vp), ctypes.POINTER(i), ctypes.POINTER(i), i, vp,
            vp, i, vp, i, i, i, vp]
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


def _check_kernel_inputs(name: str, levels: Sequence[torch.Tensor],
                         coords: Sequence[torch.Tensor], n: int, radius: int,
                         out_dtype: torch.dtype) -> None:
    """Raise on what the lookup kernel does not take."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f'{name}: {len(levels)} levels; the kernel takes '
                         f'1 to {MAX_LEVELS}')
    if radius not in RADII:
        raise ValueError(f'{name}: radius {radius}; the kernel is built for '
                         f'{RADII}')
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f'{name}: output dtype {out_dtype}; the kernel '
                         f'writes {OUT_DTYPES}')
    for t in (*levels, *coords):
        if t.device != coords[0].device:
            raise ValueError(f'{name}: tensors on different devices')
        if t.dtype != torch.float32:
            raise ValueError(f'{name}: float32 only, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')
    for lv in levels:
        if lv.dim() != 3 or lv.shape[0] != n:
            raise ValueError(f'{name}: level {tuple(lv.shape)} is not '
                             f'[{n}, h, w]')


def _launch(levels: Sequence[torch.Tensor], x_ptr: int, y_ptr: int,
            stride: int, n: int, radius: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of the lookup kernel over all levels, on inputs that
    _check_kernel_inputs passed. Query i's coordinates are the f32 values
    at x_ptr and y_ptr, advanced by i * stride elements. Returns
    [n, len(levels) * (2r+1)^2] in out_dtype."""
    p = 2 * radius + 1
    dev = levels[0].device
    nl = len(levels)
    out = torch.empty((n, nl * p * p), dtype=out_dtype, device=dev)
    ptrs = (ctypes.c_void_p * nl)(*(lv.data_ptr() for lv in levels))
    hs = (ctypes.c_int * nl)(*(lv.shape[1] for lv in levels))
    ws = (ctypes.c_int * nl)(*(lv.shape[2] for lv in levels))
    lib = _lookup_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cwm_window_lookup(ptrs, hs, ws, nl, x_ptr, y_ptr, stride,
                                    out.data_ptr(),
                                    int(out_dtype == torch.bfloat16), n,
                                    radius, stream)
    kernels.check(err, 'window_lookup kernel')
    kernels.LAUNCHES['window_lookup'] += 1
    return out


def _refuse_autograd(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """The lookup kernel defines no backward: raise where autograd would
    record its call, instead of returning a result without a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name}: the lookup kernel has no backward, and its inputs '
            "require grad. Differentiate through impl='gather' (a RAFT "
            "with corr_lookup='gather'), or call it under torch.no_grad()")


def window_lookup(level: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 window of each query on its UNPADDED level row.

    level: f32 [N, h, w]; x, y: f32 [N] coords in the level's frame.
    Returns f32 [N, 2r+1, 2r+1] in [x-offset, y-offset] order, zeros
    outside the level. CUDA: a one-level call of the lookup kernel; CPU:
    ``_window_lookup``."""
    n, h, w = level.shape
    if level.device.type == 'cpu':
        return _window_lookup(pad_pyramid([level], radius)[0], x, y, radius,
                              h, w)
    _refuse_autograd('window_lookup', [level, x, y])
    _check_kernel_inputs('window_lookup', [level], [x, y], n, radius,
                         torch.float32)
    if x.shape != (n,) or y.shape != (n,):
        raise ValueError(f'window_lookup: coords {tuple(x.shape)} / '
                         f'{tuple(y.shape)} do not match {n} queries')
    p = 2 * radius + 1
    return _launch([level], x.data_ptr(), y.data_ptr(), 1, n, radius,
                   torch.float32).reshape(n, p, p)


def _lookup_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """Plain version of the pyramid lookup: ``_window_lookup`` on each
    padded level at coords / 2^i, concatenated. Returns f32
    [B, H, W, levels * (2r+1)^2]."""
    b, h, w, _ = coords.shape
    p = 2 * radius + 1
    x = coords[..., 0].reshape(b * h * w)
    y = coords[..., 1].reshape(b * h * w)
    out = [_window_lookup(pad_pyramid([level], radius)[0], x / (2 ** i),
                          y / (2 ** i), radius, level.shape[1],
                          level.shape[2]).reshape(b, h, w, p * p)
           for i, level in enumerate(pyramid)]
    return torch.cat(out, dim=-1)


def lookup_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor,
                   radius: int, out_dtype: torch.dtype = torch.float32,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Index the (unpadded) correlation pyramid around coords [B, H, W, 2]
    (x, y) at 1/8 resolution. Returns [B, H, W, levels * (2r+1)^2], levels
    outer; within a level, offset (i, j) row-major where i offsets x.

    The sums are f32; ``out_dtype`` is the dtype of the result (bf16 for a
    consumer that computes in bf16: the f32 result rounded to nearest even).

    impl (the JAX package's): 'gather' is the plain ``_lookup_pyramid`` on
    any device, differentiable through the levels and the coordinates;
    'kernel' the CUDA kernel, one launch for all levels, which reads coords
    in place; None routes by device (the kernel on CUDA). The kernel has no
    backward, so where it would run (impl 'kernel', or None on CUDA) while
    autograd records the pyramid or the coords this raises RuntimeError on
    any device. On CPU tensors the plain version runs."""
    if impl not in IMPLS:
        raise ValueError(f'lookup_pyramid: impl must be one of {IMPLS}: '
                         f'{impl!r}')
    on_cpu = coords.device.type == 'cpu'
    if impl == 'kernel' or (impl is None and not on_cpu):
        _refuse_autograd('lookup_pyramid', [coords, *pyramid])
    if impl == 'gather' or on_cpu:
        return _lookup_pyramid(pyramid, coords, radius).to(out_dtype)
    b, h, w, two = coords.shape
    n = b * h * w
    _check_kernel_inputs('lookup_pyramid', pyramid, [coords], n, radius,
                         out_dtype)
    if two != 2:
        raise ValueError(f'lookup_pyramid: coords {tuple(coords.shape)} are '
                         'not [B, H, W, 2]')
    ptr = coords.data_ptr()
    return _launch(pyramid, ptr, ptr + coords.element_size(), 2, n, radius,
                   out_dtype).reshape(b, h, w, -1)
