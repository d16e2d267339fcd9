"""Flash attention: single-source (K1) and two-source (K2).

Port of counterfactualworldmodels_tpu/ops/flash_attention.py. On CUDA
tensors ``flash_attention`` and ``flash_attention_prefix`` launch the
hand-written kernel of ``csrc/attention.cu``; on CPU tensors they run their
plain versions, ``_chunked_dense_attention`` and ``_dense_two_source``
(the same math: f32 scores and softmax). Layout: q, k, v [B, H, N, D];
q pre-scaled (softmax scale 1).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_BH = 65535
_lib = None


def _attention_lib():
    global _lib
    if _lib is None:
        lib = kernels.load('attention')
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cwm_attention.argtypes = [vp, vp, vp, i, i, f, vp, vp, i, f, vp,
                                      i, i, i, i, i, vp]
        lib.cwm_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def _chunked_dense_attention(q, k, v, bias=None):
    """Plain attention over query chunks (bounded live score memory): f32
    scores and softmax, probabilities cast to v's dtype, f32 products,
    output in q's dtype. bias: optional [Nk] f32 per-key logit bias (the
    dense image of the kernel's per-panel key multiplicities, +ln w)."""
    b, h, n, _ = q.shape
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    per_row = b * h * k.shape[2] * 4
    chunk = max(64, min(1024, 2 ** 27 // max(per_row, 1) // 64 * 64))
    outs = []
    for i in range(0, n, chunk):
        s = torch.matmul(q[:, :, i:i + chunk].float(), kt)
        if bias is not None:
            s = s + bias
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.matmul(p.float(), vf).to(q.dtype))
    return torch.cat(outs, dim=2)


def _dense_two_source(q, k0, v0, k1, v1, w0: float, w1: float):
    """Plain two-source softmax: the per-panel key multiplicities become
    +ln(w) logit biases over the concatenated panels."""
    s = q.shape[0]
    if k0.shape[0] == 1 and s > 1:
        k0 = k0.expand(s, *k0.shape[1:])
        v0 = v0.expand(s, *v0.shape[1:])
    k = torch.cat([k0, k1], 2)
    v = torch.cat([v0, v1], 2)
    bias = None
    if w0 != 1.0 or w1 != 1.0:
        bias = torch.cat([
            torch.full((k0.shape[2],), math.log(w0), dtype=torch.float32,
                       device=q.device),
            torch.full((k1.shape[2],), math.log(w1), dtype=torch.float32,
                       device=q.device)])
    return _chunked_dense_attention(q, k, v, bias)


def _check_cuda(what, q, *kv):
    """Raise on what the kernel does not take."""
    dev = q.device
    for t in (q, *kv):
        if t.device != dev:
            raise ValueError(f'{what}: tensors on different devices')
        if t.dtype != q.dtype:
            raise ValueError(f'{what}: mixed dtypes {t.dtype} vs {q.dtype}')
        if t.dim() != 4:
            raise ValueError(f'{what}: expected [B, H, N, D], got {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: inputs must be contiguous')
        if t.shape[1] != q.shape[1] or t.shape[3] != q.shape[3]:
            raise ValueError(f'{what}: head count / head dim mismatch')
    if q.dtype not in _DTYPES:
        raise ValueError(f'{what}: dtype {q.dtype} not supported '
                         '(float32, bfloat16)')
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f'{what}: head dim {q.shape[3]} not in {_HEAD_DIMS}')
    if q.shape[0] * q.shape[1] > _MAX_BH:
        raise ValueError(f'{what}: B*H = {q.shape[0] * q.shape[1]} exceeds '
                         f'{_MAX_BH}')


def _launch(q, k0, v0, shared0: bool, w0: float, k1, v1, w1: float):
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    lib = _attention_lib()
    n1 = 0 if k1 is None else k1.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cwm_attention(
            q.data_ptr(), k0.data_ptr(), v0.data_ptr(), k0.shape[2],
            int(shared0), float(w0),
            None if k1 is None else k1.data_ptr(),
            None if v1 is None else v1.data_ptr(), n1, float(w1),
            out.data_ptr(), b * h, h, nq, d, _DTYPES[q.dtype], stream)
    kernels.check(err, 'attention kernel')
    return out


def flash_attention(q, k, v) -> torch.Tensor:
    """Attention. q [B, H, Nq, D] pre-scaled; k, v [B, H, Nk, D]
    (Nq != Nk allowed). CUDA: the K1 kernel; CPU: the plain version."""
    if q.device.type == 'cpu':
        return _chunked_dense_attention(q, k, v)
    _check_cuda('flash_attention', q, k, v)
    if k.shape[0] != q.shape[0] or k.shape != v.shape:
        raise ValueError('flash_attention: k/v batch or shape mismatch')
    out = _launch(q, k, v, False, 1.0, None, None, 1.0)
    kernels.LAUNCHES['flash_attention'] += 1
    return out


def flash_attention_prefix(q, k0, v0, k1, v1, prefix_weight: float = 1.0,
                           suffix_weight: float = 1.0) -> torch.Tensor:
    """Attention over [prefix keys ; own keys] in ONE softmax without
    materializing the prefix per sample.

    q [S, H, Nq, D] pre-scaled; k0, v0 [1, H, N0, D] shared by every
    sample (read in place) or [S, H, N0, D] per sample; k1, v1
    [S, H, N1, D]. prefix_weight / suffix_weight: key multiplicity of each
    panel (equal to a +ln w logit bias). CUDA: the K2 kernel; CPU: the
    plain version."""
    s = q.shape[0]
    s0 = k0.shape[0]
    if s0 not in (1, s):
        raise ValueError(
            f'flash_attention_prefix: prefix batch dim {s0} must be 1 '
            f'(shared scene) or match the sample dim {s} (stacked '
            'per-sample prefixes)')
    n0 = k0.shape[2]
    n1 = k1.shape[2]
    if n0 == 0 or n1 == 0:
        raise ValueError(
            f'flash_attention_prefix: empty panel (N0={n0}, N1={n1}); '
            'use flash_attention for single-source attention')
    if q.device.type == 'cpu':
        return _dense_two_source(q, k0, v0, k1, v1, float(prefix_weight),
                                 float(suffix_weight))
    _check_cuda('flash_attention_prefix', q, k0, v0, k1, v1)
    if k0.shape != v0.shape or k1.shape != v1.shape or k1.shape[0] != s:
        raise ValueError('flash_attention_prefix: k/v shape mismatch')
    out = _launch(q, k0, v0, s0 == 1, prefix_weight, k1, v1,
                  suffix_weight)
    kernels.LAUNCHES['flash_attention_prefix'] += 1
    return out
