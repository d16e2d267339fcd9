"""Flash attention: single-source (K1), two-source (K2), and the training
pair, the forward with logsumexp (K5) and the fused backward (K6).

Port of counterfactualworldmodels_tpu/ops/flash_attention.py. On CUDA
tensors the wrappers launch the hand-written kernels of ``csrc/attention.cu``
(K1, K2, K5) and ``csrc/attention_bwd.cu`` (K6); on CPU tensors they run
their plain versions, one for each contract: ``dense_attention`` (K1 and
K5), ``_dense_attention_prefix`` (K2) and ``_chunked_attention_bwd`` (K6),
the same math with f32 scores and softmax. This module is the one place
that chooses between a kernel and its plain version; callers pass tensors
and the device decides.
Inside each kernel entry the dtype picks the route: bf16 runs on the
tensor cores (wgmma); f32, forward and backward, on the tensor cores in
tf32 with split products (lo.hi + hi.lo + hi.hi: f32 accuracy, whatever
PyTorch's TF32 flags say).
Layout: q, k, v [B, H, N, D]; q pre-scaled (softmax scale 1).

The kernels are built for head dims 16, 32, 64 and 128. Any other D up to
128 runs on the next of them: the wrappers zero-pad q, k, v (and the
cotangent) along D, launch, and slice the outputs and gradients back
(``pad_head_dim``). That is exact: q is pre-scaled, so zero columns change
no logit, and the padded output and gradient columns are zero. D > 128
raises.

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
import torch.nn.functional as F

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
                                          vp, vp, i, i, i, i, i, vp, i, vp]
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


def dense_attention(q, k, v, with_lse: bool = False):
    """Plain attention over query chunks (bounded live score memory): f32
    scores and softmax, probabilities cast to v's dtype, f32 products,
    output in q's dtype. with_lse: also return the rows' logsumexp of the
    f32 scores, [B, H, Nq] f32 (the plain version of K5)."""
    b, h, n, _ = q.shape
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    chunk = _chunk_rows(b, h, k.shape[2])
    outs, lses = [], []
    for i in range(0, n, chunk):
        s = torch.matmul(q[:, :, i:i + chunk].float(), kt)
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


def _dense_attention_prefix(q, k0, v0, k1, v1, weight0: float = 1.0,
                            weight1: float = 1.0, own_valid=None):
    """The plain version of K2: one f32 softmax over [prefix scores ; own
    scores] without materializing broadcast+concat K/V, over query chunks
    (bounded live score memory). q [S, H, Nq, d]; k0/v0 [S0, H, N0, d]
    with S0 in {1, S}; k1/v1 [S, H, N1, d]. Output in v1's dtype.

    weight0/weight1: key multiplicity of each panel (a +ln w logit bias).
    own_valid: optional bool [S, N1]; False marks pad keys of the own panel
    (sfx_bucket), which score -inf, so a row with no valid own key falls
    back to prefix-only attention. A zero-width own panel is single-source
    attention over the prefix."""
    sub0 = 'hkd' if k0.shape[0] == 1 else 'shkd'
    k0f = (k0[0] if k0.shape[0] == 1 else k0).float()
    v0f = (v0[0] if v0.shape[0] == 1 else v0).float()
    k1f, v1f = k1.float(), v1.float()
    s, h, n, _ = q.shape
    chunk = _chunk_rows(s, h, k0.shape[2] + k1.shape[2])
    outs = []
    for i in range(0, n, chunk):
        qf = q[:, :, i:i + chunk].float()
        s0 = torch.einsum(f'shqd,{sub0}->shqk', qf, k0f)
        if k1.shape[2] == 0:
            p0 = torch.softmax(s0, dim=-1)
            outs.append(torch.einsum(f'shqk,{sub0}->shqd', p0, v0f))
            continue
        s1 = torch.einsum('shqd,shkd->shqk', qf, k1f)
        if weight0 != 1.0:
            s0 = s0 + math.log(weight0)
        if weight1 != 1.0:
            s1 = s1 + math.log(weight1)
        if own_valid is not None:
            s1 = s1.masked_fill(~own_valid[:, None, None, :], float('-inf'))
        m = torch.maximum(s0.amax(-1, keepdim=True),
                          s1.amax(-1, keepdim=True))
        p0 = torch.exp(s0 - m)
        p1 = torch.exp(s1 - m)
        l = p0.sum(-1, keepdim=True) + p1.sum(-1, keepdim=True)
        o = torch.einsum(f'shqk,{sub0}->shqd', p0, v0f)
        outs.append((o + torch.einsum('shqk,shkd->shqd', p1, v1f)) / l)
    return torch.cat(outs, dim=2).to(v1.dtype)


def own_lengths(key_valid):
    """The own_len of flash_attention_prefix for a pad-key mask key_valid
    bool [S, N1] (True: a real key) whose pads trail the real keys, as
    ``fast_vmae.pad_vis1_idx`` lays them: int32 [S], made on the mask's
    device without a host wait. On the CPU a mask of another form
    raises."""
    own_len = key_valid.sum(-1, dtype=torch.int32)
    if key_valid.device.type == 'cpu':
        trailing = torch.arange(key_valid.shape[-1]) < own_len[:, None]
        if not torch.equal(trailing, key_valid):
            raise ValueError('own_lengths: pad keys must trail the real '
                             'keys of each row')
    return own_len


def kernel_head_dim(d: int) -> int:
    """The kernel head dim that carries head dim d: the least of
    _HEAD_DIMS not below it."""
    for kd in _HEAD_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f'head dim {d} exceeds {_HEAD_DIMS[-1]}')


def pad_head_dim(*tensors):
    """The tensors [..., D] zero-padded along D to ``kernel_head_dim(D)``
    (each returned as it is when D is a kernel head dim)."""
    out = []
    for t in tensors:
        pad = kernel_head_dim(t.shape[-1]) - t.shape[-1]
        out.append(F.pad(t, (0, pad)) if pad else t)
    return out


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
    if not 0 < q.shape[3] <= _HEAD_DIMS[-1]:
        raise ValueError(f'{what}: head dim {q.shape[3]} not in '
                         f'1..{_HEAD_DIMS[-1]}')
    if q.shape[0] * q.shape[1] > _MAX_BH:
        raise ValueError(f'{what}: B*H = {q.shape[0] * q.shape[1]} exceeds '
                         f'{_MAX_BH}')


def _launch(q, k0, v0, shared0: bool, w0: float, k1, v1, w1: float,
            lse=None, own_len=None, pack: int = 1):
    """One launch of csrc/attention.cu at the padded head dim; the output
    sliced back to q's. own_len: None or int32 [B] on q's device; pack: the
    samples one block packs (1: none)."""
    d_in = q.shape[3]
    q, k0, v0 = pad_head_dim(q, k0, v0)
    if k1 is not None:
        k1, v1 = pad_head_dim(k1, v1)
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
            b * h, h, nq, d, _DTYPES[q.dtype],
            None if own_len is None else own_len.data_ptr(), pack, stream)
    kernels.check(err, 'attention kernel')
    return out if d == d_in else out[..., :d_in]


def _check_single_source(q, k, v):
    _check_cuda('flash_attention', q, k, v)
    if k.shape[0] != q.shape[0] or k.shape != v.shape:
        raise ValueError('flash_attention: k/v batch or shape mismatch')


def _flash_forward_lse(q, k, v):
    """(out, lse [B, H, Nq] f32): K5 on CUDA, the plain version on the CPU."""
    if q.device.type == 'cpu':
        return dense_attention(q, k, v, with_lse=True)
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
    b, h, nq, d_in = q.shape
    for t in (lse, delta):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, nq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError('flash_attention backward: lse/delta must be '
                             'contiguous float32 [B, H, Nq] on q\'s device')
    q, k, v, do = pad_head_dim(q, k, v, do)
    d = q.shape[3]
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
    if d == d_in:
        return dq, dk, dv
    return dq[..., :d_in], dk[..., :d_in], dv[..., :d_in]


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
        return dense_attention(q, k, v)
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


_PACK_ROWS = 128   # query rows of a bf16 K2 block


def flash_attention_prefix(q, k0, v0, k1, v1, prefix_weight: float = 1.0,
                           suffix_weight: float = 1.0,
                           own_len=None) -> torch.Tensor:
    """Attention over [prefix keys ; own keys] in ONE softmax without
    materializing the prefix per sample.

    q [S, H, Nq, D] pre-scaled; k0, v0 [1, H, N0, D] shared by every
    sample (read in place) or [S, H, N0, D] per sample; k1, v1
    [S, H, N1, D]. prefix_weight / suffix_weight: key multiplicity of each
    panel (equal to a +ln w logit bias). own_len: optional int32 [S] on q's
    device (``own_lengths``): sample s's own keys at or past own_len[s] are
    pad keys and score -inf (0: the prefix alone). No query rows: an
    empty output, whatever the device. CUDA: the K2 kernel,
    which has no backward (RuntimeError when a gradient is asked for); in
    bf16 with a shared prefix and Nq <= 64 one block packs
    floor(128 / Nq) samples' queries (also counted under
    ``flash_attention_prefix_packed``). CPU: the plain version,
    ``_dense_attention_prefix``."""
    s = q.shape[0]
    s0 = k0.shape[0]
    if s0 not in (1, s):
        raise ValueError(
            f'flash_attention_prefix: prefix batch dim {s0} must be 1 '
            f'(shared scene) or match the sample dim {s} (stacked '
            'per-sample prefixes)')
    if q.shape[2] == 0:
        # no query rows (a suffix with no visible token): nothing to attend
        return q.new_empty(q.shape)
    n0 = k0.shape[2]
    n1 = k1.shape[2]
    if n0 == 0 or n1 == 0:
        raise ValueError(
            f'flash_attention_prefix: empty panel (N0={n0}, N1={n1}); '
            'use flash_attention for single-source attention')
    if own_len is not None and (
            own_len.dtype != torch.int32 or tuple(own_len.shape) != (s,)
            or own_len.device != q.device or not own_len.is_contiguous()):
        raise ValueError('flash_attention_prefix: own_len must be a '
                         f'contiguous int32 [{s}] on q\'s device')
    if q.device.type == 'cpu':
        own_valid = (None if own_len is None
                     else torch.arange(n1) < own_len[:, None])
        return _dense_attention_prefix(q, k0, v0, k1, v1,
                                       float(prefix_weight),
                                       float(suffix_weight), own_valid)
    _refuse_grad('flash_attention_prefix', q, k0, v0, k1, v1)
    _check_cuda('flash_attention_prefix', q, k0, v0, k1, v1)
    if k0.shape != v0.shape or k1.shape != v1.shape or k1.shape[0] != s:
        raise ValueError('flash_attention_prefix: k/v shape mismatch')
    nq = q.shape[2]
    pack = (_PACK_ROWS // nq if s0 == 1 and q.dtype == torch.bfloat16
            and nq <= _PACK_ROWS // 2 else 1)
    out = _launch(q, k0, v0, s0 == 1, prefix_weight, k1, v1,
                  suffix_weight, own_len=own_len, pack=pack)
    kernels.LAUNCHES['flash_attention_prefix'] += 1
    if pack > 1:
        kernels.LAUNCHES['flash_attention_prefix_packed'] += 1
    return out
