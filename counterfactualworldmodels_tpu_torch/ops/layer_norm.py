"""Residual add + LayerNorm in one pass: ``add_layer_norm``.

A pre-norm transformer block adds a residual to its stream and normalises
the sum at once. On CUDA tensors ``add_layer_norm`` launches the
hand-written kernel of ``csrc/layer_norm.cu``, which reads x and r once
and writes the sum and the normalised rows once; on CPU tensors it runs
its plain version, ``x + r`` then ``models.layers.layer_norm`` (flax's
numerics: f32 statistics and affine, output in x's dtype). The kernel
rounds the sum to the working dtype and takes the statistics of that
rounded value, as eager's ``x + r`` does; only the order of the f32 row
sums differs. It has no backward: training runs ``layers.LayerNorm``
under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 4096          # csrc/layer_norm.cu kMaxD

_lib = None


def _layer_norm_lib():
    global _lib
    if _lib is None:
        lib = kernels.load('layer_norm')
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cwm_add_layer_norm.argtypes = [vp, vp, vp, vp, vp, vp, i, i,
                                           ctypes.c_float, i, i, vp]
        lib.cwm_add_layer_norm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _add_layer_norm_plain(x, r, scale, bias, eps: float):
    # imported here: the models import this module
    from ..models.layers import layer_norm
    h = x if r is None else x + r
    return h, layer_norm(h, scale, bias, eps)


def _check(x, r, scale, bias):
    """Raise on what the kernel does not take."""
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f'add_layer_norm: dtype {x.dtype} not supported '
                         '(float32, bfloat16)')
    if r is not None and (r.dtype != x.dtype or r.shape != x.shape):
        raise ValueError(f'add_layer_norm: residual {r.dtype} '
                         f'{tuple(r.shape)} against x {x.dtype} '
                         f'{tuple(x.shape)}')
    if not 0 < d <= MAX_D:
        raise ValueError(f'add_layer_norm: width {d} not in 1..{MAX_D}')
    for name, p in (('scale', scale), ('bias', bias)):
        if tuple(p.shape) != (d,) or p.dtype not in _DTYPES:
            raise ValueError(f'add_layer_norm: {name} {p.dtype} '
                             f'{tuple(p.shape)} for rows of {d} {x.dtype}')
    if scale.dtype != bias.dtype:
        raise ValueError('add_layer_norm: scale and bias dtypes differ')
    if any(t.device != x.device for t in (r, scale, bias) if t is not None):
        raise ValueError('add_layer_norm: tensors on different devices')


def add_layer_norm(x, r, scale, bias, eps: float = 1e-6):
    """(x + r, LayerNorm(x + r)) over the last dim; r None: (x,
    LayerNorm(x)). x, r [..., D] float32 or bf16, D up to MAX_D; scale,
    bias [D], both bf16 or both float32. CUDA: the kernel, one launch (none
    for zero rows), which has no backward (RuntimeError when a gradient is
    asked for); the sum comes back contiguous. CPU: the plain version."""
    if x.device.type == 'cpu':
        return _add_layer_norm_plain(x, r, scale, bias, eps)
    _check(x, r, scale, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, r, scale, bias) if t is not None):
        raise RuntimeError(
            'add_layer_norm has no backward: call it under torch.no_grad() '
            'or with inputs that do not require grad (layers.LayerNorm is '
            'the differentiable norm)')
    x = x.contiguous()
    r = None if r is None else r.contiguous()
    if scale.dtype != x.dtype and x.dtype == torch.float32:
        # bf16 scale and bias with f32 rows go up exactly, as eager's type
        # promotion takes them
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.contiguous(), bias.contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    h = x if r is None else torch.empty_like(x)
    y = torch.empty_like(x)
    if rows == 0:
        return h, y
    lib = _layer_norm_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cwm_add_layer_norm(
            x.data_ptr(), None if r is None else r.data_ptr(),
            scale.data_ptr(), bias.data_ptr(),
            None if r is None else h.data_ptr(), y.data_ptr(), rows, d,
            float(eps), _DTYPES[x.dtype],
            int(scale.dtype == torch.bfloat16), stream)
    kernels.check(err, 'add_layer_norm kernel')
    kernels.LAUNCHES['add_layer_norm'] += 1
    return h, y
