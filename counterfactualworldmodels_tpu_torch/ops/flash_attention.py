"""Flash attention: single-source (K1), two-source (K2), and the training
pair, the forward with logsumexp (K5) and the fused backward (K6).

Port of counterfactualworldmodels_tpu/ops/flash_attention.py. On CUDA
tensors the wrappers launch the hand-written kernels of ``csrc/attention.cu``
(K1, K2, K5) and ``csrc/attention_bwd.cu`` (K6); on CPU tensors they run
their plain versions, ``_chunked_dense_attention``, ``_dense_two_source``
and ``_chunked_attention_bwd`` (the same math: f32 scores and softmax).
Layout: q, k, v [B, H, N, D]; q pre-scaled (softmax scale 1).

``flash_attention`` is differentiable: when a gradient is asked for it runs
``_FlashAttention`` (the JAX package's ``_flash_attention_vjp``), whose
forward is K5 and whose backward is K6. ``flash_attention_prefix`` has no
backward, like the JAX K2, and refuses to run on the card when one is
asked for.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_BH = 65535
_libs = {}


def _lib(name):
    """ctypes library of csrc/<name>.cu with its entry's argument types."""
    lib = _libs.get(name)
    if lib is None:
        lib = kernels.load(name)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == 'attention':
            lib.cwm_attention.argtypes = [vp, vp, vp, i, i, f, vp, vp, i, f,
                                          vp, vp, i, i, i, i, i, vp]
            lib.cwm_attention.restype = ctypes.c_int
        else:
            lib.cwm_attention_bwd.argtypes = [vp] * 9 + [i] * 5 + [vp]
            lib.cwm_attention_bwd.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _chunk_rows(b, h, nk):
    """Query rows per chunk of the plain versions: bounds the live f32
    score tile to ~128 MB."""
    per_row = b * h * nk * 4
    return max(64, min(1024, 2 ** 27 // max(per_row, 1) // 64 * 64))


def _chunked_dense_attention(q, k, v, bias=None, with_lse: bool = False):
    """Plain attention over query chunks (bounded live score memory): f32
    scores and softmax, probabilities cast to v's dtype, f32 products,
    output in q's dtype. bias: optional [Nk] f32 per-key logit bias (the
    dense image of the kernel's per-panel key multiplicities, +ln w).
    with_lse: also return the rows' logsumexp of the f32 scores,
    [B, H, Nq] f32 (the plain version of K5)."""
    b, h, n, _ = q.shape
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    chunk = _chunk_rows(b, h, k.shape[2])
    outs, lses = [], []
    for i in range(0, n, chunk):
        s = torch.matmul(q[:, :, i:i + chunk].float(), kt)
        if bias is not None:
            s = s + bias
        if with_lse:
            lses.append(torch.logsumexp(s, dim=-1))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.matmul(p.float(), vf).to(q.dtype))
    out = torch.cat(outs, dim=2)
    return (out, torch.cat(lses, dim=2)) if with_lse else out


def _chunked_attention_bwd(q, k, v, do, lse, delta):
    """Plain version of K6 over query chunks: P = exp(S - lse),
    dV = P^T dO, dS = P * (dO V^T - delta), dK = dS^T Q, dQ = dS K, all in
    f32, with P rounded to dO's dtype before dV and dS to q's dtype before
    dK and dQ (the JAX kernel's cast points). Returns dq, dk, dv in q's
    dtype."""
    b, h, n, _ = q.shape
    kf, vf = k.float(), v.float()
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    chunk = _chunk_rows(b, h, k.shape[2])
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        qc, doc = q[:, :, sl].float(), do[:, :, sl].float()
        p = torch.exp(torch.matmul(qc, kf.transpose(-1, -2))
                      - lse[:, :, sl, None])
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doc)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = (p * (dp - delta[:, :, sl, None])).to(q.dtype).float()
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dqs.append(torch.matmul(ds, kf))
    return (torch.cat(dqs, dim=2).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


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


def _launch(q, k0, v0, shared0: bool, w0: float, k1, v1, w1: float,
            lse=None):
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    lib = _lib('attention')
    n1 = 0 if k1 is None else k1.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cwm_attention(
            q.data_ptr(), k0.data_ptr(), v0.data_ptr(), k0.shape[2],
            int(shared0), float(w0),
            None if k1 is None else k1.data_ptr(),
            None if v1 is None else v1.data_ptr(), n1, float(w1),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b * h, h, nq, d, _DTYPES[q.dtype], stream)
    kernels.check(err, 'attention kernel')
    return out


def _check_single_source(q, k, v):
    _check_cuda('flash_attention', q, k, v)
    if k.shape[0] != q.shape[0] or k.shape != v.shape:
        raise ValueError('flash_attention: k/v batch or shape mismatch')


def _flash_forward_lse(q, k, v):
    """(out, lse [B, H, Nq] f32): K5 on CUDA, the plain version on the CPU."""
    if q.device.type == 'cpu':
        return _chunked_dense_attention(q, k, v, with_lse=True)
    _check_single_source(q, k, v)
    b, h, nq, _ = q.shape
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, False, 1.0, None, None, 1.0, lse=lse)
    kernels.LAUNCHES['flash_attention_lse'] += 1
    return out, lse


def _flash_backward(q, k, v, do, lse, delta):
    """(dq, dk, dv) in q's dtype: K6 on CUDA, the plain version on the CPU.
    do has q's dtype; lse and delta are [B, H, Nq] f32."""
    if q.device.type == 'cpu':
        return _chunked_attention_bwd(q, k, v, do, lse, delta)
    _check_single_source(q, k, v)
    _check_cuda('flash_attention backward', q, do)
    b, h, nq, d = q.shape
    for t in (lse, delta):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, nq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError('flash_attention backward: lse/delta must be '
                             'contiguous float32 [B, H, Nq] on q\'s device')
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _lib('attention_bwd')
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cwm_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, nq, k.shape[2], d, _DTYPES[q.dtype],
            stream)
    kernels.check(err, 'attention backward kernel')
    kernels.LAUNCHES['flash_attention_bwd'] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with its own backward (the JAX package's
    ``_flash_attention_vjp``, ``_flash_vjp_fwd`` and ``_flash_vjp_bwd``):
    the forward keeps q, k, v, the output and the rows' logsumexp; the
    backward rebuilds the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _flash_forward_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # delta from the cotangent before any cast, as the JAX rule does
        delta = (g.float() * out.float()).sum(-1)
        return _flash_backward(q, k, v, g.to(q.dtype).contiguous(), lse,
                               delta)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v) -> torch.Tensor:
    """Attention. q [B, H, Nq, D] pre-scaled; k, v [B, H, Nk, D]
    (Nq != Nk allowed). With a gradient asked for (grad mode on and an
    input that requires it): the K5 forward, and K6 in the backward.
    Otherwise: K1. On the CPU: the plain versions of the same."""
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    if q.device.type == 'cpu':
        return _chunked_dense_attention(q, k, v)
    _check_single_source(q, k, v)
    out = _launch(q, k, v, False, 1.0, None, None, 1.0)
    kernels.LAUNCHES['flash_attention'] += 1
    return out


def _refuse_grad(what, *tensors):
    """The two-source kernel has no backward (nor has the JAX K2): raise
    rather than return an output that autograd would treat as constant."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            f'{what} has no backward: call it under torch.no_grad() or '
            'with inputs that do not require grad (flash_attention is the '
            'differentiable kernel)')


def flash_attention_prefix(q, k0, v0, k1, v1, prefix_weight: float = 1.0,
                           suffix_weight: float = 1.0) -> torch.Tensor:
    """Attention over [prefix keys ; own keys] in ONE softmax without
    materializing the prefix per sample.

    q [S, H, Nq, D] pre-scaled; k0, v0 [1, H, N0, D] shared by every
    sample (read in place) or [S, H, N0, D] per sample; k1, v1
    [S, H, N1, D]. prefix_weight / suffix_weight: key multiplicity of each
    panel (equal to a +ln w logit bias). CUDA: the K2 kernel, which has no
    backward (RuntimeError when a gradient is asked for); CPU: the plain
    version."""
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
    _refuse_grad('flash_attention_prefix', q, k0, v0, k1, v1)
    _check_cuda('flash_attention_prefix', q, k0, v0, k1, v1)
    if k0.shape != v0.shape or k1.shape != v1.shape or k1.shape[0] != s:
        raise ValueError('flash_attention_prefix: k/v shape mismatch')
    out = _launch(q, k0, v0, s0 == 1, prefix_weight, k1, v1,
                  suffix_weight)
    kernels.LAUNCHES['flash_attention_prefix'] += 1
    return out
