"""The block body's linears, with what follows each applied where its output
is first produced: ``linear`` and ``linear_gelu`` (the bias, and the GELU,
in the GEMM's epilogue) and ``qkv_heads`` (the qkv GEMM's output into
attention's q, k, v in one pass).

``linear(x, w, b)`` is ``torch.addmm`` on the 2-D view of x: on the card
cuBLASLt adds the bias to the accumulator before it stores the product.
``linear_gelu`` adds the GELU: on the card the tanh form rides the same
epilogue (``torch._addmm_activation(..., use_gelu=True)``, cuBLASLt's
GELU_BIAS, which is the tanh form there); the exact (erf) form, and every
form on the CPU, where ``_addmm_activation`` computes the erf form, is the
product with its bias then ``F.gelu``. The products stay the library's, as
the JAX package leaves dot + bias to XLA.

``qkv_heads`` takes the plain qkv product [S, N, 3A] (no bias) and returns
q [S, H, N, d] with its bias added and scaled, and k, v [S, H, N', d], v
with its bias, pooled pool x pool over the token grid when pool > 1. On
CUDA tensors it launches the hand-written kernel of ``csrc/qkv_heads.cu``,
which reads each row once; on CPU tensors it runs its plain version, the
bias add, head split, scaling and f32 pooled mean of eager PyTorch, whose
roundings the kernel repeats (q and unpooled k, v bit for bit; pooled k, v
up to the order of a pool^2-term f32 sum). It has no backward: only the
shared-prefix engines call it, and training does not run them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def linear(x, w, b):
    """x [..., K] @ w [K, M] + b [M], the bias in the product's epilogue."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def linear_gelu(x, w, b, approximate: str = 'none'):
    """GELU(x @ w + b), approximate 'none' (erf) or 'tanh'. On the card the
    tanh form is computed in the product's epilogue."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type != 'cpu' and approximate == 'tanh':
        y = torch._addmm_activation(b, x2, w, use_gelu=True)
    else:
        y = F.gelu(torch.addmm(b, x2, w), approximate=approximate)
    return y.view(*x.shape[:-1], w.shape[-1])


def _qkv_heads_lib():
    global _lib
    if _lib is None:
        lib = kernels.load('qkv_heads')
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cwm_qkv_heads.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                      i, i, ctypes.c_float, i, vp]
        lib.cwm_qkv_heads.restype = ctypes.c_int
        _lib = lib
    return _lib


def _pool_grid(x, pool: int, grid):
    """Average-pool [S, H, N, d] pool x pool over the (gh, gw) token grid
    (N = gh*gw row-major); f32 mean, then cast."""
    gh, gw = grid
    s, h, _, d = x.shape
    p = x.reshape(s, h, gh // pool, pool, gw // pool, pool, d)
    p = p.float().mean(dim=(3, 5))
    return p.reshape(s, h, (gh // pool) * (gw // pool), d).to(x.dtype)


def _qkv_heads_plain(qkv, q_bias, v_bias, num_heads: int, scale: float,
                     pool: int = 1, grid=None):
    s, n, c = qkv.shape
    q, k, v = qkv.reshape(s, n, 3, num_heads,
                          c // (3 * num_heads)).permute(2, 0, 3, 1, 4)
    if q_bias is not None:
        q = q + q_bias.reshape(num_heads, 1, -1)
    if v_bias is not None:
        v = v + v_bias.reshape(num_heads, 1, -1)
    q = (q * scale).contiguous()
    k, v = k.contiguous(), v.contiguous()
    if pool > 1:
        k, v = _pool_grid(k, pool, grid), _pool_grid(v, pool, grid)
    return q, k, v


def _check(qkv, q_bias, v_bias, num_heads: int, pool: int, grid):
    """Raise on what the kernel does not take."""
    if qkv.dtype not in _DTYPES:
        raise ValueError(f'qkv_heads: dtype {qkv.dtype} not supported '
                         '(float32, bfloat16)')
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f'qkv_heads: qkv {tuple(qkv.shape)} is not '
                         f'[S, N, 3 * {num_heads} * d]')
    width = qkv.shape[-1] // 3
    for name, b in (('q_bias', q_bias), ('v_bias', v_bias)):
        if b is not None and (tuple(b.shape) != (width,)
                              or b.dtype != qkv.dtype
                              or b.device != qkv.device):
            raise ValueError(f'qkv_heads: {name} {b.dtype} '
                             f'{tuple(b.shape)} on {b.device} for qkv '
                             f'{qkv.dtype} of width {width} on '
                             f'{qkv.device}')
    if pool < 1:
        raise ValueError(f'qkv_heads: pool {pool} < 1')
    if pool > 1:
        gh, gw = grid
        if gh * gw != qkv.shape[1] or gh % pool or gw % pool:
            raise ValueError(f'qkv_heads: grid {gh}x{gw} of {qkv.shape[1]} '
                             f'tokens does not pool {pool} x {pool}')
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (qkv, q_bias, v_bias)):
        raise RuntimeError(
            'qkv_heads has no backward: call it under torch.no_grad() or '
            'with inputs that do not require grad')


def qkv_heads(qkv, q_bias: Optional[torch.Tensor],
              v_bias: Optional[torch.Tensor], num_heads: int, scale: float,
              pool: int = 1, grid=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qkv [S, N, 3A] float32 or bf16, the columns [q | k | v] head-major
    (A = num_heads * d); q_bias, v_bias [A] in qkv's dtype, or None. ->
    q [S, H, N, d] = (q + q_bias) * scale; k, v [S, H, N', d], v + v_bias;
    N' = N, or with pool > 1 N / pool^2, pooled pool x pool over the token
    grid (gh, gw) (N = gh * gw, row-major) by an f32 mean. All contiguous.
    CUDA: the kernel, one launch (none for zero rows), no backward
    (RuntimeError when a gradient is asked for). CPU: the plain version."""
    if qkv.device.type == 'cpu':
        return _qkv_heads_plain(qkv, q_bias, v_bias, num_heads, scale, pool,
                                grid)
    _check(qkv, q_bias, v_bias, num_heads, pool, grid)
    s, n, c = qkv.shape
    d = c // (3 * num_heads)
    n_kv = n // (pool * pool)
    q = qkv.new_empty(s, num_heads, n, d)
    k = qkv.new_empty(s, num_heads, n_kv, d)
    v = torch.empty_like(k)
    if q.numel() == 0:
        return q, k, v
    qkv = qkv.contiguous()
    q_bias = None if q_bias is None else q_bias.contiguous()
    v_bias = None if v_bias is None else v_bias.contiguous()
    gh, gw = grid if pool > 1 else (n, 1)
    lib = _qkv_heads_lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.cwm_qkv_heads(
            qkv.data_ptr(), None if q_bias is None else q_bias.data_ptr(),
            None if v_bias is None else v_bias.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), s, n, num_heads, d, gh, gw, pool,
            float(scale), _DTYPES[qkv.dtype], stream)
    kernels.check(err, 'qkv_heads kernel')
    kernels.LAUNCHES['qkv_heads'] += 1
    return q, k, v
