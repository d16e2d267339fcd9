"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (and nvcc, to build the kernels); skips without one.
This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Attention runs on the tensor cores: bf16 on the ``*_sm90`` kernels
(wgmma, shapes cut into 64- and 128-row tiles); f32 on wgmma in tf32 with
split products, the forward on ``attention_fwd_tf32`` (64-key tiles, 16 at
D = 128) and the backward on ``dkdv_tf32`` / ``dq_tf32`` (blocks of 128
resident rows, 64 at D = 128; streamed tiles of 32 rows, 16 at D = 128).
The shapes below cross those tile edges (Nk under one tile, Nq and Nk one
past a boundary) at every head dim.

Tolerances: f32 2e-5 / 3e-5 (the JAX kernel tests' bounds: sums in another
order); bf16 2e-2 (outputs of magnitude ~1 differ by a couple of bf16 ulps:
the kernel rounds the unnormalised probabilities to bf16 before P.V, as
the JAX kernel does, where the plain version rounds the normalised ones);
the lookup 1e-5 (sums in another order), and its bf16 output bitwise
the f32 output cast. The training pair: the lse at 1e-4 and the f32 gradients
at atol 2e-4 / rtol 1e-4 (tests/test_flash_attention.py's bounds); bf16
gradients within 2e-2 of their largest magnitude. The residual add +
LayerNorm: the sum bitwise, the normalised rows within one bf16 ulp of the
row's largest magnitude (f32: 1e-5), the row sums being taken in another
order. The qkv pass (``ops.linear.qkv_heads``): q and unpooled k, v
bitwise, pooled k, v within one bf16 ulp of each value (f32: 1e-6 of the
largest magnitude), the pool's f32 sum being taken in another order.
"""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models.raft import corr
from counterfactualworldmodels_tpu_torch.ops import flash_attention as fa
from counterfactualworldmodels_tpu_torch.ops import layer_norm as ln
from counterfactualworldmodels_tpu_torch.ops import linear as lin

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_matches_plain(dev, dtype, atol):
    rng = np.random.RandomState(0)
    for (b, h, nq, nk, d) in [(2, 3, 100, 77, 16), (1, 2, 64, 64, 32),
                              (2, 2, 130, 200, 64), (1, 2, 70, 90, 128),
                              (1, 2, 100, 20, 64), (1, 2, 129, 65, 16),
                              (1, 2, 129, 65, 32), (2, 2, 129, 129, 64),
                              (1, 2, 257, 65, 128)]:
        q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev, dtype)
        k, v = (_rand(rng, b, h, nk, d).to(dev, dtype) for _ in range(2))
        before = kernels.LAUNCHES['flash_attention']
        out = fa.flash_attention(q, k, v)
        assert kernels.LAUNCHES['flash_attention'] == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert _err(out, fa.dense_attention(q, k, v)) <= atol


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 3e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_prefix_kernel_matches_plain(dev, dtype, atol):
    """Shared and stacked prefixes, weights (1, 1), (16, 16), (1, 4) and
    (4, 1), a prefix under one key tile and panels one past a tile
    boundary, every head dim."""
    rng = np.random.RandomState(1)
    for s0, n0, n1, w, d in [(1, 33, 65, (1.0, 1.0), 64),
                             (1, 33, 65, (16.0, 16.0), 64),
                             (3, 33, 65, (1.0, 4.0), 64),
                             (1, 33, 129, (1.0, 4.0), 64),
                             (1, 196, 196, (16.0, 16.0), 64),
                             (1, 100, 129, (16.0, 16.0), 32),
                             (1, 300, 20, (4.0, 1.0), 128),
                             (3, 129, 65, (1.0, 4.0), 16)]:
        q = _rand(rng, 3, 2, 50, d, scale=d ** -0.5).to(dev, dtype)
        k0, v0 = (_rand(rng, s0, 2, n0, d).to(dev, dtype) for _ in range(2))
        k1, v1 = (_rand(rng, 3, 2, n1, d).to(dev, dtype) for _ in range(2))
        before = kernels.LAUNCHES['flash_attention_prefix']
        out = fa.flash_attention_prefix(q, k0, v0, k1, v1, *w)
        assert kernels.LAUNCHES['flash_attention_prefix'] == before + 1
        ref = fa._dense_attention_prefix(q, k0, v0, k1, v1, *w)
        assert _err(out, ref) <= atol, (s0, n0, n1, w, d)


# (S, H, Nq, N0, N1, S0, weights, D): the cf and imu encoder suffixes
# (ViT-L, ViT-B; 33 visible frame-1 tokens bucketed to 40), Nq 33 and 64
# (3 and 2 samples a block) with S not a multiple of them, Nq 65 (no
# packing), N1 past Nq (the packed own panel over several key tiles), head
# dims 32 and 128 (64-key tiles), and stacked per-sample prefixes (S0 = S:
# no packing)
_OWN_CASES = [(256, 16, 40, 3136, 40, 1, (1.0, 1.0), 64),
              (256, 12, 40, 3136, 40, 1, (1.0, 1.0), 64),
              (7, 2, 33, 300, 33, 1, (1.0, 4.0), 64),
              (5, 2, 64, 200, 64, 1, (4.0, 1.0), 64),
              (5, 2, 65, 200, 65, 1, (1.0, 1.0), 64),
              (3, 2, 20, 129, 70, 1, (1.0, 1.0), 64),
              (7, 2, 40, 300, 40, 1, (1.0, 1.0), 128),
              (7, 2, 40, 300, 40, 1, (1.0, 1.0), 32),
              (4, 2, 40, 300, 40, 4, (1.0, 1.0), 64)]


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 3e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_prefix_own_lengths_match_plain(dev, dtype, atol):
    """K2 with own-key lengths (the bucketed encoder suffix) against its
    plain version, the dense two-source attention with the pad-key mask:
    lengths drawn from 0 (the prefix alone), 1, 33 and all. The pad keys
    hold NaN, which only a read of them could carry into the output. bf16
    with a shared prefix and Nq <= 64 packs floor(128 / Nq) samples a
    block, counted under flash_attention_prefix_packed too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(9)
    for s, h, nq, n0, n1, s0, w, d in _OWN_CASES:
        q = _rand(rng, s, h, nq, d, scale=d ** -0.5).to(dev, dtype)
        k0, v0 = (_rand(rng, s0, h, n0, d).to(dev, dtype) for _ in range(2))
        k1, v1 = (_rand(rng, s, h, n1, d).to(dev, dtype) for _ in range(2))
        lens = rng.choice([0, 1, min(33, n1), n1], s).astype(np.int32)
        own_len = torch.from_numpy(lens).to(dev)
        valid = torch.arange(n1, device=dev) < own_len[:, None]
        pads = ~valid[:, None, :, None]
        nan = float('nan')
        before = dict(kernels.LAUNCHES)
        out = fa.flash_attention_prefix(q, k0, v0, k1.masked_fill(pads, nan),
                                        v1.masked_fill(pads, nan), *w,
                                        own_len=own_len)
        packed = int(dtype == torch.bfloat16 and s0 == 1 and nq <= 64)
        assert kernels.LAUNCHES == dict(
            before,
            flash_attention_prefix=before['flash_attention_prefix'] + 1,
            flash_attention_prefix_packed=(
                before['flash_attention_prefix_packed'] + packed))
        ref = fa._dense_attention_prefix(q, k0, v0, k1, v1, *w,
                                         own_valid=valid)
        case = (s, h, nq, n0, n1, s0, w, d)
        assert out.shape == q.shape and bool(torch.isfinite(out).all()), case
        assert _err(out, ref) <= atol, case
        del ref
    with pytest.raises(ValueError, match='own_len'):
        fa.flash_attention_prefix(q, k0, v0, k1, v1, own_len=own_len[:-1])


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                           q)
    with pytest.raises(ValueError, match='mixed dtypes'):
        fa.flash_attention(q, q.bfloat16(), q)
    q160 = torch.zeros(1, 2, 8, 160, device=dev)
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_attention(q160, q160, q160)


def test_window_lookup_kernel_matches_plain(dev):
    rng = np.random.RandomState(2)
    for (h, w) in [(28, 28), (7, 9), (3, 3), (0, 0)]:
        level = _rand(rng, 300, h, w).to(dev)
        x = torch.from_numpy((rng.rand(300) * (w + 16) - 8).astype(np.float32)).to(dev)
        y = torch.from_numpy((rng.rand(300) * (h + 16) - 8).astype(np.float32)).to(dev)
        before = kernels.LAUNCHES['window_lookup']
        out = corr.window_lookup(level, x, y, 4)
        assert kernels.LAUNCHES['window_lookup'] == before + 1
        ref = corr._window_lookup(corr.pad_pyramid([level], 4)[0], x, y, 4,
                                  h, w)
        assert _err(out, ref) <= 1e-5
    with pytest.raises(ValueError, match='float32'):
        corr.window_lookup(level.double(), x.double(), y.double(), 4)


@pytest.mark.parametrize('radius', [3, 4])
@pytest.mark.parametrize('levels', [1, 2, 3, 4])
def test_lookup_pyramid_kernel_matches_plain(dev, levels, radius):
    """All levels in one launch, against the plain path, with query counts
    that are no multiple of the kernel's 16-query tile, coordinates 8 px
    past every edge, odd level sizes (7x9 -> 3x4 -> 1x2 -> 0x1), a 0x0
    level (4x4 -> 2x2 -> 1x1 -> 0x0) and the dispatch's 28x28. The bf16
    output is bitwise the f32 output cast."""
    rng = np.random.RandomState(10 * levels + radius)
    p = 2 * radius + 1
    for b, h, w, h2, w2 in [(1, 5, 7, 7, 9), (2, 3, 3, 4, 4),
                            (1, 3, 37, 28, 28)]:
        pyramid = corr.build_pyramid(_rand(rng, b, h, w, h2, w2).to(dev),
                                     levels)
        coords = torch.from_numpy((rng.rand(b, h, w, 2) * (max(h2, w2) + 16)
                                   - 8).astype(np.float32)).to(dev)
        before = kernels.LAUNCHES['window_lookup']
        out = corr.lookup_pyramid(pyramid, coords, radius)
        assert kernels.LAUNCHES['window_lookup'] == before + 1
        assert out.dtype == torch.float32
        assert out.shape == (b, h, w, levels * p * p)
        ref = corr._lookup_pyramid(pyramid, coords, radius)
        assert _err(out, ref) <= 1e-5, (b, h, w, h2, w2)
        out_bf16 = corr.lookup_pyramid(pyramid, coords, radius,
                                       torch.bfloat16)
        assert kernels.LAUNCHES['window_lookup'] == before + 2
        assert out_bf16.dtype == torch.bfloat16
        assert torch.equal(out_bf16, out.to(torch.bfloat16))


def test_lookup_pyramid_kernel_rejects_what_it_does_not_take(dev):
    level = torch.zeros(6, 4, 4, device=dev)
    coords = torch.zeros(1, 2, 3, 2, device=dev)
    with pytest.raises(ValueError, match='5 levels'):
        corr.lookup_pyramid([level] * 5, coords, 4)
    with pytest.raises(ValueError, match='float32'):
        corr.lookup_pyramid([level, level.double()], coords, 4)
    with pytest.raises(ValueError, match='float32'):
        corr.lookup_pyramid([level], coords.double(), 4)
    with pytest.raises(ValueError, match='radius'):
        corr.lookup_pyramid([level], coords, 5)
    with pytest.raises(ValueError, match='output dtype'):
        corr.lookup_pyramid([level], coords, 4, torch.float16)
    with pytest.raises(ValueError, match='contiguous'):
        corr.lookup_pyramid([level], coords.transpose(1, 2).contiguous()
                            .transpose(1, 2), 4)
    with pytest.raises(ValueError, match='level'):
        corr.lookup_pyramid([torch.zeros(5, 4, 4, device=dev)], coords, 4)


_BWD_SHAPES = [(2, 3, 100, 77, 16), (1, 2, 64, 64, 32), (2, 2, 130, 200, 64),
               (1, 2, 70, 90, 128), (1, 2, 200, 333, 64), (1, 2, 100, 20, 32),
               (1, 2, 129, 65, 128), (2, 2, 129, 129, 16)]


def _grad_inputs(rng, dev, dtype, b, h, nq, nk, d):
    q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev, dtype)
    k, v = (_rand(rng, b, h, nk, d).to(dev, dtype) for _ in range(2))
    do = _rand(rng, b, h, nq, d).to(dev, dtype)
    return q, k, v, do


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_lse_kernel_matches_plain(dev, dtype, atol):
    rng = np.random.RandomState(3)
    for (b, h, nq, nk, d) in _BWD_SHAPES:
        q, k, v, _ = _grad_inputs(rng, dev, dtype, b, h, nq, nk, d)
        before = kernels.LAUNCHES['flash_attention_lse']
        out, lse = fa._flash_forward_lse(q, k, v)
        assert kernels.LAUNCHES['flash_attention_lse'] == before + 1
        ref, ref_lse = fa.dense_attention(q, k, v, with_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (b, h, nq)
        assert _err(out, ref) <= atol
        assert torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype):
    rng = np.random.RandomState(4)
    for (b, h, nq, nk, d) in _BWD_SHAPES:
        q, k, v, do = _grad_inputs(rng, dev, dtype, b, h, nq, nk, d)
        out, lse = fa.dense_attention(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        before = kernels.LAUNCHES['flash_attention_bwd']
        got = fa._flash_backward(q, k, v, do, lse, delta)
        assert kernels.LAUNCHES['flash_attention_bwd'] == before + 1
        ref = fa._chunked_attention_bwd(q, k, v, do, lse, delta)
        for name, a, r in zip('qkv', got, ref):
            assert a.dtype == dtype and a.shape == r.shape, name
            if dtype == torch.float32:
                assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), name
            else:
                assert _err(a, r) <= 2e-2 * float(r.float().abs().max()), name


def test_flash_attention_bwd_kernel_is_deterministic(dev):
    rng = np.random.RandomState(5)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in [(2, 4, 333, 333, 64), (1, 2, 129, 65, 128),
                      (2, 2, 200, 77, 32)]:
            q, k, v, do = _grad_inputs(rng, dev, dtype, *shape)
            out, lse = fa._flash_forward_lse(q, k, v)
            delta = (do.float() * out.float()).sum(-1)
            first = fa._flash_backward(q, k, v, do, lse, delta)
            second = fa._flash_backward(q, k, v, do, lse, delta)
            assert all(torch.equal(a, b) for a, b in zip(first, second)), (
                dtype, shape)


def _device_kernel_names(fn):
    """The names of the device kernels ``fn`` launches, by torch.profiler.
    A later profiler session in a process sometimes records the launches
    but no device kernel at all; such a session is taken again, up to three
    times (a session with kernels is never retaken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return ' '.join(names)


def _hgmma_counts(lib_path):
    """{mangled kernel name: HGMMA instructions} in ``cuobjdump -sass``."""
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    tool = shutil.which('cuobjdump') or os.path.join(cuda_home, 'bin',
                                                     'cuobjdump')
    sass = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r'Function : (\w+)', ln)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and 'HGMMA' in ln:
            counts[cur] += 1
    return counts


def test_bf16_attention_runs_on_the_tensor_core_kernels(dev):
    """bf16 calls launch the wgmma kernels; f32 calls launch the split-tf32
    kernels, the forward ``attention_fwd_tf32`` and the backward
    ``dkdv_tf32`` / ``dq_tf32``, each of which holds HGMMA at every head
    dim."""
    rng = np.random.RandomState(8)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = _grad_inputs(rng, dev, dtype, 1, 2, 130, 130, 64)

        def calls():
            out, lse = fa._flash_forward_lse(q, k, v)
            fa.flash_attention_prefix(q, k, v, k, v, 1.0, 4.0)
            fa._flash_backward(q, k, v, do, lse,
                               (do.float() * out.float()).sum(-1))

        names[dtype] = _device_kernel_names(calls)
    for kernel in ('attention_fwd_sm90', 'dkdv_sm90', 'dq_sm90'):
        assert kernel in names[torch.bfloat16]
        assert kernel not in names[torch.float32]
    for kernel in ('attention_fwd_tf32', 'dkdv_tf32', 'dq_tf32'):
        assert kernel in names[torch.float32]
        assert kernel not in names[torch.bfloat16]
    for lib, kernel in (('attention', 'attention_fwd_tf32'),
                        ('attention_bwd', 'dkdv_tf32'),
                        ('attention_bwd', 'dq_tf32')):
        hgmma = _hgmma_counts(kernels.library_path(lib))
        for d in (16, 32, 64, 128):
            fragment = f'{len(kernel)}{kernel}ILi{d}E'
            found = [n for k, n in hgmma.items() if fragment in k]
            assert len(found) == 1 and found[0] > 0, (kernel, d, found)


_F32_SHAPES = [  # (b, h, nq, nk, d): every head dim, padded ones too;
    # Nq and Nk one past a 64-key tile (16 at D = 128) and a 128-row block,
    # a block with one valid query row, a key tile with one valid key
    (2, 3, 100, 77, 16), (1, 2, 129, 65, 32), (2, 2, 130, 200, 64),
    (1, 2, 257, 17, 128), (1, 2, 1, 1, 64), (1, 2, 65, 1, 128),
    (2, 2, 129, 129, 8), (1, 3, 39, 39, 24), (2, 2, 13, 13, 48)]


@pytest.mark.parametrize('shape', _F32_SHAPES, ids=str)
def test_f32_attention_forward_matches_plain(dev, shape):
    """The split-tf32 forward (K1, and K5 with its lse) against the plain
    f32 version, TF32 off for cuBLAS, at the existing bounds: outputs 2e-5,
    the lse 1e-4 / 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(sum(shape))
    b, h, nq, nk, d = shape
    q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev)
    k, v = (_rand(rng, b, h, nk, d).to(dev) for _ in range(2))
    out = fa.flash_attention(q, k, v)
    ref, ref_lse = fa.dense_attention(q, k, v, with_lse=True)
    assert _err(out, ref) <= 2e-5
    out5, lse = fa._flash_forward_lse(q, k, v)
    assert torch.equal(out5, out)
    assert torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('shape', _F32_SHAPES, ids=str)
def test_f32_attention_backward_matches_plain(dev, shape):
    """The split-tf32 backward (K6) against the plain f32 version, TF32 off
    for cuBLAS, at TOL_GRAD (atol 2e-4 / rtol 1e-4): one launch, gradients
    of the caller's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(sum(shape) + 1)
    q, k, v, do = _grad_inputs(rng, dev, torch.float32, *shape)
    out, lse = fa.dense_attention(q, k, v, with_lse=True)
    delta = (do * out).sum(-1)
    before = kernels.LAUNCHES['flash_attention_bwd']
    got = fa._flash_backward(q, k, v, do, lse, delta)
    assert kernels.LAUNCHES['flash_attention_bwd'] == before + 1
    ref = fa._chunked_attention_bwd(q, k, v, do, lse, delta)
    for name, a, r in zip('qkv', got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), name


@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_f32_prefix_attention_matches_plain(dev, d):
    """K2 on the f32 route: a shared prefix read by S = 3 samples and
    stacked per-sample prefixes, weights (16, 16), (1, 4) and (4, 1),
    panels one past a key tile, against the plain version at 3e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(d)
    bk = 16 if d == 128 else 64
    for s0, n0, n1, w in [(1, bk + 1, 2 * bk + 1, (16.0, 16.0)),
                          (3, 2 * bk + 1, bk + 1, (1.0, 4.0)),
                          (1, 3 * bk, 5, (4.0, 1.0))]:
        q = _rand(rng, 3, 2, 50, d, scale=d ** -0.5).to(dev)
        k0, v0 = (_rand(rng, s0, 2, n0, d).to(dev) for _ in range(2))
        k1, v1 = (_rand(rng, 3, 2, n1, d).to(dev) for _ in range(2))
        out = fa.flash_attention_prefix(q, k0, v0, k1, v1, *w)
        ref = fa._dense_attention_prefix(q, k0, v0, k1, v1, *w)
        assert _err(out, ref) <= 3e-5, (s0, n0, n1, w)


def test_f32_attention_ignores_the_tf32_flags(dev):
    """The kernels' arithmetic is their own: the outputs and the backward's
    gradients are bitwise the same whatever
    torch.backends.cuda.matmul.allow_tf32 and cudnn.allow_tf32 say."""
    rng = np.random.RandomState(12)
    q = _rand(rng, 2, 4, 300, 64, scale=0.125).to(dev)
    k, v = (_rand(rng, 2, 4, 300, 64).to(dev) for _ in range(2))
    k1, v1 = (_rand(rng, 2, 4, 70, 64).to(dev) for _ in range(2))
    do = _rand(rng, 2, 4, 300, 64).to(dev)
    out, lse = fa.dense_attention(q, k, v, with_lse=True)
    delta = (do * out).sum(-1)
    outs = []
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.backends.cudnn.allow_tf32 = flag
            outs.append((fa.flash_attention(q, k, v),
                         fa.flash_attention_prefix(q, k[:1], v[:1], k1, v1,
                                                   16.0, 16.0),
                         *fa._flash_backward(q, k, v, do, lse, delta)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_flash_attention_gradients_come_from_k6(dev):
    """The fault this guards against: a kernel output without grad_fn
    trains every weight upstream of attention with a zero gradient."""
    rng = np.random.RandomState(6)
    q, k, v, do = _grad_inputs(rng, dev, torch.float32, 1, 2, 150, 150, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launches()
    out = fa.flash_attention(*leaves)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, do)
    assert kernels.LAUNCHES['flash_attention_lse'] == 1
    assert kernels.LAUNCHES['flash_attention_bwd'] == 1
    assert kernels.LAUNCHES['flash_attention'] == 0
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa.dense_attention(*ref_leaves),
                              ref_leaves, do)
    for name, a, r in zip('qkv', grads, ref):
        assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), name
    with torch.no_grad():
        fa.flash_attention(*leaves)
    assert kernels.LAUNCHES['flash_attention'] == 1


# the widths the port normalises (ViT-L 1024, its decoder 512, ViT-B 768,
# the conjoined models' 192 and 384, the tiny models' 32 and 48), a ragged
# one and the widest the kernel takes; row counts that are not a multiple
# of the kernel's 8 rows a block
_LN_WIDTHS = (32, 48, 100, 192, 384, 512, 768, 1024, 4096)


def _cold_norms(le, ld):
    """LayerNorm launches of one shared-prefix dispatch on a new scene: the
    prefix (two a block, enc_norm; the decoder prefix needs no dec_norm),
    then the suffix (two a block, enc_norm, dec_norm)."""
    return 4 * le + 4 * ld + 3


def _warm_norms(le, ld):
    """The same on a cached prefix: the suffix alone."""
    return 2 * le + 2 * ld + 2


def _bf16_ulp(a):
    """One bf16 ulp at each row's largest magnitude, [..., 1]."""
    m = a.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_add_layer_norm_kernel_matches_plain(dev, dtype, residual):
    """Rows of every width in _LN_WIDTHS, scale and bias in the rows' dtype
    and in f32: the sum bitwise the plain version's, the normalised rows
    within the module's tolerance."""
    rng = np.random.RandomState(9)
    for d in _LN_WIDTHS:
        for rows in (1, 37, 1001):
            x = (_rand(rng, rows, d, scale=3.0) + 1.0).to(dev, dtype)
            r = _rand(rng, rows, d).to(dev, dtype) if residual else None
            scale = (1 + 0.1 * _rand(rng, d)).to(dev)
            bias = (0.1 * _rand(rng, d)).to(dev)
            for p, b in ((scale, bias), (scale.to(dtype), bias.to(dtype))):
                before = kernels.LAUNCHES['add_layer_norm']
                h, y = ln.add_layer_norm(x, r, p, b, 1e-6)
                assert kernels.LAUNCHES['add_layer_norm'] == before + 1
                ph, py = ln._add_layer_norm_plain(x, r, p, b, 1e-6)
                assert h.dtype == y.dtype == dtype
                assert torch.equal(h, ph), (d, rows)
                tol = 1e-5 if dtype == torch.float32 else _bf16_ulp(py)
                assert ((y.float() - py.float()).abs() <= tol).all(), (
                    d, rows, _err(y, py))


def test_add_layer_norm_takes_views_and_refuses_what_it_does_not_take(dev):
    """A strided view (the decoder's frame-1 rows are a slice of a buffer)
    and an unaligned one run the kernel; zero rows launch nothing; other
    dtypes, mixed dtypes and widths over 4096 raise; a gradient asked for
    raises, as the kernel has no backward."""
    rng = np.random.RandomState(10)
    buf = _rand(rng, 3, 50, 512).to(dev, torch.bfloat16)
    res = _rand(rng, 3, 49, 512).to(dev, torch.bfloat16)
    p = (1 + 0.1 * _rand(rng, 512)).to(dev, torch.bfloat16)
    b = (0.1 * _rand(rng, 512)).to(dev, torch.bfloat16)
    for x, r in ((buf[:, :49], res), (buf[:, :49], None),
                 (buf.reshape(-1)[3:3 + 49 * 511].reshape(49, 511), None)):
        pp, bb = p[:x.shape[-1]], b[:x.shape[-1]]
        h, y = ln.add_layer_norm(x, r, pp, bb)
        ph, py = ln._add_layer_norm_plain(x, r, pp, bb, 1e-6)
        assert torch.equal(h, ph)
        assert ((y.float() - py.float()).abs() <= _bf16_ulp(py)).all()
    before = kernels.LAUNCHES['add_layer_norm']
    h, y = ln.add_layer_norm(buf[:0], None, p, b)
    assert y.shape == (0, 50, 512)
    assert kernels.LAUNCHES['add_layer_norm'] == before
    with pytest.raises(ValueError, match='not supported'):
        ln.add_layer_norm(buf.half(), None, p, b)
    with pytest.raises(ValueError, match='residual'):
        ln.add_layer_norm(buf[:, :49], res.float(), p, b)
    with pytest.raises(ValueError, match='dtypes differ'):
        ln.add_layer_norm(buf, None, p, b.float())
    wide = torch.zeros(2, 4097, device=dev)
    with pytest.raises(ValueError, match='width'):
        ln.add_layer_norm(wide, None, wide[0], wide[0])
    x = torch.zeros(4, 64, device=dev, requires_grad=True)
    one, zero = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(RuntimeError, match='no backward'):
        ln.add_layer_norm(x, None, one, zero)
    with pytest.raises(RuntimeError, match='no backward'):
        ln.add_layer_norm(x.detach(), None, one.requires_grad_(), zero)
    with torch.no_grad():
        assert ln.add_layer_norm(x, x, one, zero)[1].shape == x.shape


# (case, S, N, heads, d, pool, grid, q bias, v bias, dtype): the cf decoder
# suffix at its benchmark shape (pool 4 over the 56 x 56 grid) and the imu
# one (unpooled), then small rows of every route: f32, a head dim of 32
# without q's bias, pool 2 without either bias, pool 3 (the pool read at
# run time), head dims 12 and 20 (single-element chunks)
_QKV_CASES = [
    ('cf decoder suffix', 256, 3136, 8, 64, 4, (56, 56), True, True,
     torch.bfloat16),
    ('imu decoder suffix', 256, 3200, 6, 64, 1, None, True, True,
     torch.bfloat16),
    ('f32 pooled', 3, 3136, 8, 64, 4, (56, 56), True, True, torch.float32),
    ('f32 unpooled', 3, 40, 16, 64, 1, None, True, True, torch.float32),
    ('d32 no q bias', 4, 50, 4, 32, 1, None, False, True, torch.bfloat16),
    ('pool2 no bias', 2, 24, 4, 16, 2, (4, 6), False, False,
     torch.bfloat16),
    ('pool3', 2, 36, 2, 16, 3, (6, 6), True, True, torch.bfloat16),
    ('d12', 2, 33, 3, 12, 1, None, True, True, torch.bfloat16),
    ('d20 f32 pool2', 2, 16, 2, 20, 2, (4, 4), True, True, torch.float32),
]


def _pooled_close(got, want):
    if want.dtype == torch.float32:
        tol = 1e-6 * float(want.abs().max())
        return float((got - want).abs().max()) <= tol
    return bool(((got.float() - want.float()).abs()
                 <= _bf16_ulp_each(want)).all())


def _bf16_ulp_each(a):
    """One bf16 ulp of each value's magnitude."""
    m = a.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize('case', [c[0] for c in _QKV_CASES])
def test_qkv_heads_kernel_matches_plain(dev, case):
    """The kernel against its plain version in one launch: q and unpooled
    k, v bitwise, pooled k, v within the module's tolerance."""
    (_, s, n, heads, d, pool, grid, has_q, has_v,
     dtype) = next(c for c in _QKV_CASES if c[0] == case)
    g = torch.Generator(device=dev).manual_seed(13)
    a = heads * d
    qkv = (2 * torch.randn(s, n, 3 * a, device=dev, generator=g)).to(dtype)
    q_bias = (torch.randn(a, device=dev, generator=g).to(dtype)
              if has_q else None)
    v_bias = (torch.randn(a, device=dev, generator=g).to(dtype)
              if has_v else None)
    scale = d ** -0.5
    before = kernels.LAUNCHES['qkv_heads']
    got = lin.qkv_heads(qkv, q_bias, v_bias, heads, scale, pool, grid)
    assert kernels.LAUNCHES['qkv_heads'] == before + 1
    want = lin._qkv_heads_plain(qkv, q_bias, v_bias, heads, scale, pool,
                                grid)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.is_contiguous()
    assert torch.equal(got[0], want[0])
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x, y) if pool == 1 else _pooled_close(x, y), case


def test_qkv_heads_takes_views_and_refuses_what_it_does_not_take(dev):
    """An unaligned view runs the kernel's single-element route; zero
    samples launch nothing; other dtypes, a bias of another dtype or width,
    a grid that does not pool, and a gradient asked for raise."""
    g = torch.Generator(device=dev).manual_seed(14)
    buf = torch.randn(2 * 10 * 96 + 1, device=dev,
                      generator=g).to(torch.bfloat16)
    qkv = buf[1:].view(2, 10, 96)
    qb, vb = (torch.randn(32, device=dev, generator=g).to(torch.bfloat16)
              for _ in range(2))
    got = lin.qkv_heads(qkv, qb, vb, 2, 0.25)
    want = lin._qkv_heads_plain(qkv, qb, vb, 2, 0.25)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    before = kernels.LAUNCHES['qkv_heads']
    q, k, v = lin.qkv_heads(qkv[:0], qb, vb, 2, 0.25)
    assert q.shape == (0, 2, 10, 16)
    assert kernels.LAUNCHES['qkv_heads'] == before
    with pytest.raises(ValueError, match='not supported'):
        lin.qkv_heads(qkv.half(), None, None, 2, 0.25)
    with pytest.raises(ValueError, match='q_bias'):
        lin.qkv_heads(qkv, qb.float(), vb, 2, 0.25)
    with pytest.raises(ValueError, match='v_bias'):
        lin.qkv_heads(qkv, qb, vb[:16], 2, 0.25)
    with pytest.raises(ValueError, match='not'):
        lin.qkv_heads(qkv[:, :, :95], None, None, 2, 0.25)
    with pytest.raises(ValueError, match='pool'):
        lin.qkv_heads(qkv, qb, vb, 2, 0.25, 2, (2, 5))
    x = torch.zeros(2, 16, 96, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match='no backward'):
        lin.qkv_heads(x, None, None, 2, 0.25)
    with torch.no_grad():
        assert lin.qkv_heads(x, None, None, 2, 0.25, 2, (4, 4))[1].shape == (
            2, 2, 4, 16)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_linear_gelu_epilogue_is_the_tanh_form_on_the_card(dev, dtype):
    """On the card ``linear_gelu(..., 'tanh')`` is cuBLASLt's GELU_BIAS
    epilogue: the tanh GELU of the product with its bias, and 'none' the
    erf form; ``linear`` is the product with its bias. f32 within 1e-5, and
    farther than 1e-4 from the other form (the two differ by up to 4.7e-4,
    under a bf16 ulp at these magnitudes); bf16 within 2 bf16 ulps of the
    pre-activation and of the value (it rounds once in the epilogue, twice
    in the composition) and 1e-4 (where the product cancels its bias, the
    f32 sums' order shows: 512 terms of magnitude ~0.04)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(300, 512, device=dev, generator=g).to(dtype)
    w = (0.05 * torch.randn(512, 2048, device=dev, generator=g)).to(dtype)
    b = torch.randn(2048, device=dev, generator=g).to(dtype)
    pre = torch.addmm(b.float(), x.float(), w.float())

    def close(got, want):
        if dtype == torch.float32:
            return _err(got, want) <= 1e-5
        tol = 2 * (_bf16_ulp_each(pre) + _bf16_ulp_each(want)) + 1e-4
        return bool(((got.float() - want).abs() <= tol).all())

    for approximate in ('tanh', 'none'):
        got = lin.linear_gelu(x, w, b, approximate)
        assert got.dtype == dtype and got.shape == (300, 2048)
        want = F.gelu(pre, approximate=approximate)
        assert close(got, want), approximate
        if dtype == torch.float32:
            other = F.gelu(pre, approximate='none' if approximate == 'tanh'
                           else 'tanh')
            assert _err(got, other) > 1e-4, approximate
    assert close(lin.linear(x, w, b), pre)


@pytest.mark.parametrize('rung', ['cf pooled tanh', 'imu exact erf'])
def test_suffix_block_on_the_card_matches_the_cpu(dev, rung):
    """fast_vmae.suffix_block_one at the decoder suffixes' widths in f32
    (TF32 off), S 2, from the same weights and inputs on the card and on
    the CPU: the cf decoder (512 wide, 8 heads, the 56 x 56 grid, a pooled
    prefix of 196 keys weighted 16, own keys pooled 4, tanh) and the imu
    decoder (384 wide, 6 heads, 3200 rows, 3136 prefix keys, erf). The
    stream and the pending MLP output within 1e-4 of their largest
    magnitude; on the card one qkv pass and one K2 launch."""
    from counterfactualworldmodels_tpu_torch.models import fast_vmae
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dim, heads, n, n0, pool, pw, gelu = (
        (512, 8, 3136, 196, 4, 16.0, 'tanh') if rung == 'cf pooled tanh'
        else (384, 6, 3200, 3136, 1, 1.0, 'erf'))
    g = torch.Generator().manual_seed(16)

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    p = {'norm1': {'scale': 1 + 0.1 * r(dim), 'bias': 0.1 * r(dim)},
         'norm2': {'scale': 1 + 0.1 * r(dim), 'bias': 0.1 * r(dim)},
         'attn': {'qkv_kernel': r(dim, 3 * dim, scale=dim ** -0.5),
                  'q_bias': 0.1 * r(dim), 'v_bias': 0.1 * r(dim),
                  'proj': {'kernel': r(dim, dim, scale=dim ** -0.5),
                           'bias': 0.1 * r(dim)}},
         'mlp': {'fc1': {'kernel': r(dim, 4 * dim, scale=dim ** -0.5),
                         'bias': 0.1 * r(4 * dim)},
                 'fc2': {'kernel': r(4 * dim, dim, scale=(4 * dim) ** -0.5),
                         'bias': 0.1 * r(dim)}}}
    d = dim // heads
    kv0 = (r(1, heads, n0, d), r(1, heads, n0, d))
    h, m = r(2, n, dim), r(2, n, dim, scale=0.5)
    outs = {}
    for where in ('cpu', dev):
        def to(t, where=where):
            if isinstance(t, dict):
                return {k: to(v) for k, v in t.items()}
            return t.to(where)
        kernels.reset_launches()
        out = fast_vmae.suffix_block_one(
            to(p), tuple(to(t) for t in kv0), to(h), heads,
            prefix_weight=pw, suffix_pool=pool,
            grid=(56, 56) if pool > 1 else None, gelu=gelu, r=to(m))
        outs[str(where)] = ([t.cpu() for t in out], dict(kernels.LAUNCHES))
    (cpu, lc), (card, lg) = outs['cpu'], outs['cuda']
    assert not any(lc.values())
    assert (lg['qkv_heads'], lg['flash_attention_prefix']) == (1, 1)
    for a, b in zip(cpu, card):
        assert _err(a, b) <= 1e-4 * float(a.abs().max()), rung


def _tiny_engine_runs(dev):
    """The shared-prefix engine at the tiny configuration in f32 (TF32
    off), on the CPU and on the card: a new scene (its prefix, then a
    pooled tanh suffix pass) and the cached prefix (an exact suffix pass).
    {device: (cold output, warm output, cold launches, warm launches)} and
    the model."""
    from counterfactualworldmodels_tpu_torch.models import fast_vmae, vmae
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True,
        init_values=0.5)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(12)
    x0 = _rand(rng, 1, 3, 32, 32)
    x1 = _rand(rng, 3, 3, 32, 32)
    mask1 = torch.from_numpy(rng.rand(3, 64) > 0.1)
    vis = fast_vmae.pad_vis1_idx(mask1, fast_vmae.sfx_bucket(
        int((~mask1).sum(-1).max()), 64))
    outs = {}
    for d in ('cpu', dev):
        fp = fast_vmae.stack_vmae_params(model, sd, dtype=torch.float32,
                                         device=d)
        kernels.reset_launches()
        cache = fast_vmae.encode_prefix(model, fp, x0.to(d))
        cold = fast_vmae.predict_frame1_from_prefix(
            model, fp, cache, x1.to(d), vis.to(d), prefix_pool=2,
            suffix_pool=2, gelu='tanh')
        n_cold = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        warm = fast_vmae.predict_frame1_from_prefix(
            model, fp, cache, x1.to(d), vis.to(d))
        outs[str(d)] = (cold.cpu(), warm.cpu(), n_cold,
                        dict(kernels.LAUNCHES))
    return outs, model


def test_engine_norms_run_the_kernel(dev):
    """The shared-prefix engine at the tiny configuration in f32 (TF32
    off), card against CPU: frame-1 predictions within 1e-4; one LayerNorm
    launch per norm, the residual add before it folded in: 4 Le + 4 Ld + 3
    for a new scene, 2 Le + 2 Ld + 2 on a cached prefix (147 and 74 at
    ViT-L, Le 24 and Ld 12)."""
    outs, model = _tiny_engine_runs(dev)
    le, ld = model.encoder_depth, model.decoder_depth
    (cc, cw, cn, cwn), (gc, gw, gn, gwn) = outs['cpu'], outs['cuda']
    assert cn['add_layer_norm'] == cwn['add_layer_norm'] == 0
    assert (gn['add_layer_norm'], gwn['add_layer_norm']) == (
        _cold_norms(le, ld), _warm_norms(le, ld))
    assert _cold_norms(24, 12) == 147 and _warm_norms(24, 12) == 74
    assert max(_err(cc, gc), _err(cw, gw)) <= 1e-4


def _cold_qkv(le, ld):
    """qkv passes of one shared-prefix dispatch on a new scene: one a
    block, the prefix's and the suffix's."""
    return 2 * (le + ld)


def test_engine_qkv_runs_the_kernel(dev):
    """The same runs: one qkv_heads launch a block, pooled or not, 2 (Le +
    Ld) for a new scene and Le + Ld on a cached prefix (72 and 36 at
    ViT-L), none on the CPU; beside each, the block's one attention
    launch."""
    outs, model = _tiny_engine_runs(dev)
    le, ld = model.encoder_depth, model.decoder_depth
    (_, _, cn, cwn), (_, _, gn, gwn) = outs['cpu'], outs['cuda']
    assert cn['qkv_heads'] == cwn['qkv_heads'] == 0
    assert (gn['qkv_heads'], gwn['qkv_heads']) == (_cold_qkv(le, ld),
                                                   le + ld)
    for n in (gn, gwn):
        assert n['qkv_heads'] == (n['flash_attention']
                                  + n['flash_attention_prefix'])
    assert _cold_qkv(24, 12) == 72


def test_flash_attention_prefix_refuses_a_gradient_on_the_card(dev):
    z = torch.zeros
    q = z(2, 2, 8, 64, device=dev, requires_grad=True)
    kv = [z(n, 2, 8, 64, device=dev) for n in (1, 1, 2, 2)]
    with pytest.raises(RuntimeError, match='no backward'):
        fa.flash_attention_prefix(q, *kv)
    with torch.no_grad():
        assert fa.flash_attention_prefix(q, *kv).shape == q.shape


def _fixed_draws(gen, seed):
    """numpy-seeded draws in place of the generator's, on its device."""
    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(gen.device)

    gen._draw_shifts = lambda s: tensor(rng.randint(-2, 3, (s, 2)))
    gen._draw_prompt_noise = lambda rows, n: tensor(
        (rng.rand(rows, n) * 0.999).astype(np.float32))
    gen._draw_patch_indices = lambda p, k: tensor(
        rng.randint(0, p.shape[1], (p.shape[0], k)))
    return gen


@pytest.mark.parametrize('engine', ['fast', 'exact'])
def test_flow_generator_on_the_card_matches_the_cpu(dev, engine):
    """FlowGenerator at the small configuration in f32 (TF32 off), from the
    same weights and draws on the card and on the CPU: masks equal, videos
    within 1e-4, flows within 1e-3 px; on the card the path's kernels ran
    (fast: K1 for the prefix, K2 for the suffix decoder, the lookup; exact:
    K1 in every block, the lookup), on the CPU none."""
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        FlowGenerator)
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(0))
    raft_cpu = weights.init_raft(RAFT(iters=2, device='cpu'),
                                 torch.Generator().manual_seed(1))
    rng = np.random.RandomState(6)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    outs = {}
    for d in ('cpu', 'cuda'):
        raft = raft_cpu
        if d == 'cuda':
            raft = RAFT(iters=2, device=d)
            raft.load_state_dict(raft_cpu.state_dict(), strict=True)
        gen = _fixed_draws(FlowGenerator(
            predictor=model, params=sd, flow_model=raft, raft_iters=2,
            imagenet_normalize_inputs=True, engine=engine, device=d), 7)
        kernels.reset_launches()
        flows, active, _ = gen.sample_counterfactual_motion_map(
            x, num_samples=4, sample_batch_size=2, do_filter=False)
        y, f = gen.predict_counterfactual_videos_and_flows(
            x, active, num_samples=4, sample_batch_size=4)
        outs[d] = ([v.cpu() for v in (flows, active, y, f)],
                   dict(kernels.LAUNCHES))
    (c, lc), (g, lg) = outs['cpu'], outs['cuda']
    assert torch.equal(c[1], g[1])
    assert _err(c[2], g[2]) <= 1e-4
    assert max(_err(c[0], g[0]), _err(c[3], g[3])) <= 1e-3
    assert not any(lc.values())
    depth = model.encoder_depth + model.decoder_depth
    le, ld = model.encoder_depth, model.decoder_depth
    # three chunks of prompts (two of the motion map, one of the call after
    # it), each with a 2-iteration RAFT: 2 lookups per chunk
    if engine == 'fast':
        # one scene: its prefix once (K1 in every block), then the suffix
        # (K2 in every encoder and decoder block) per chunk; the LayerNorms
        # of the cold chunk and of the two on the cached prefix
        want = dict(flash_attention=depth, flash_attention_prefix=3 * depth,
                    window_lookup=3 * 2,
                    add_layer_norm=_cold_norms(le, ld)
                    + 2 * _warm_norms(le, ld), qkv_heads=4 * depth)
    else:
        # apply_vmae per chunk (K1 in every block)
        want = dict(flash_attention=3 * depth, window_lookup=3 * 2)
    assert lg == dict({k: 0 for k in lg}, **want), lg


def _raft_on_both(cpu_model_fn, monkeypatch):
    """A RAFT with seeded weights on the CPU and the same weights on the
    card, and a spy that records the radius of every lookup call."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = weights.init_raft(cpu_model_fn('cpu'),
                            torch.Generator().manual_seed(1))
    gpu = cpu_model_fn('cuda')
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    radii = []
    real = traft.lookup_pyramid

    def spy(pyramid, coords, radius, *a):
        radii.append(radius)
        return real(pyramid, coords, radius, *a)

    monkeypatch.setattr(traft, 'lookup_pyramid', spy)
    return cpu, gpu, radii


def test_small_raft_runs_the_radius_3_lookup(dev, monkeypatch):
    """RAFT(small=True) at 64 px, 2 iterations, f32 (TF32 off): flows within
    1e-3 px of the CPU's; on the card one radius-3 lookup launch per
    iteration, on the CPU none."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    cpu, gpu, radii = _raft_on_both(
        lambda d: traft.RAFT(iters=2, small=True, device=d), monkeypatch)
    rng = np.random.RandomState(9)
    video = torch.from_numpy(rng.rand(3, 2, 3, 64, 64).astype(np.float32))
    kernels.reset_launches()
    ref = traft.apply_raft_shared0(cpu, video)
    assert kernels.LAUNCHES['window_lookup'] == 0
    out = traft.apply_raft_shared0(gpu, video.to(dev))
    assert kernels.LAUNCHES['window_lookup'] == 2
    assert radii == [3] * 4
    assert _err(out.cpu(), ref) <= 1e-3


def test_keypoint_raft_on_the_card_matches_the_cpu(dev, monkeypatch):
    """RAFT(output_dim=1) (the large model's keypoint head, convex
    upsampling of one channel) through RaftKeypointPredictor at 64 px: the
    map within 1e-4 of the CPU's, one radius-4 lookup per iteration."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    cpu, gpu, radii = _raft_on_both(
        lambda d: traft.RAFT(iters=2, output_dim=1, device=d), monkeypatch)
    x = torch.from_numpy(np.random.RandomState(10).rand(
        2, 2, 3, 64, 64).astype(np.float32))
    ref = traft.RaftKeypointPredictor(cpu)(x)
    kernels.reset_launches()
    out = traft.RaftKeypointPredictor(gpu)(x.to(dev))
    assert kernels.LAUNCHES['window_lookup'] == 2 and radii == [4] * 4
    assert out.shape == ref.shape == (2, 1, 1, 64, 64)
    assert _err(out.cpu(), ref) <= 1e-4


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_attention_kernels_at_the_imu_path_shapes(dev, dtype, atol):
    """K1 at the ViT-B 4x4 prefix [1,12,3136,3136,64] and at the IMU
    stream's head dim 32 (the context encoder and decoder of the exact
    engine: [4,12,25,25,32], [4,6,50,50,32]; flow2imu's one visible dummy
    token [1,12,1,1,32]), and K2 at the conjoined decoder suffix
    [16,6,3200; 3136+3200,64], against their plain versions. bf16 within
    atol of the plain output's largest magnitude, as chip_smoke.py."""
    rng = np.random.RandomState(3)
    for (b, h, nq, nk, d) in [(1, 12, 3136, 3136, 64), (4, 12, 25, 25, 32),
                              (4, 6, 50, 50, 32), (1, 12, 1, 1, 32)]:
        q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev, dtype)
        k, v = (_rand(rng, b, h, nk, d).to(dev, dtype) for _ in range(2))
        ref = fa.dense_attention(q, k, v)
        tol = atol if dtype == torch.float32 else atol * float(
            ref.float().abs().max())
        assert _err(fa.flash_attention(q, k, v), ref) <= tol, (b, h, nq, d)
    s, h, nq, n0, n1 = 16, 6, 3200, 3136, 3200
    q = _rand(rng, s, h, nq, 64, scale=0.125).to(dev, dtype)
    k0, v0 = (_rand(rng, 1, h, n0, 64).to(dev, dtype) for _ in range(2))
    k1, v1 = (_rand(rng, s, h, n1, 64).to(dev, dtype) for _ in range(2))
    before = kernels.LAUNCHES['flash_attention_prefix']
    out = fa.flash_attention_prefix(q, k0, v0, k1, v1)
    ref = fa._dense_attention_prefix(q, k0, v0, k1, v1, 1.0, 1.0)
    tol = (3e-5 if dtype == torch.float32
           else atol * float(ref.float().abs().max()))
    assert _err(out, ref) <= tol
    assert kernels.LAUNCHES['flash_attention_prefix'] == before + 1


def _small_imu(d):
    """The small IMU-conditioned predictor and flow2imu (every head dim 16)
    with seeded weights made on the CPU, and a RAFT-2, on device d."""
    from counterfactualworldmodels_tpu_torch.models import conjoined as C
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.utils import weights
    ctx = dict(is_imu=True, in_chans=6, sequence_length=48, imu_tubelet=8,
               encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
               decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=2,
               decoder_num_classes=48, mlp_ratio=2.0)
    main = dict(img_size=(64, 64), patch_size=(8, 8), encoder_embed_dim=64,
                encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
                decoder_depth=2, decoder_num_heads=2, mlp_ratio=2.0)
    wrappers = []
    for i, (m, c, kw) in enumerate((
            (dict(in_chans=3, num_frames=2, padded=True,
                  max_padding_tokens=8),
             dict(concat_dummy_token=False, padded=True,
                  max_padding_tokens=6), dict(main_input='rgb01')),
            (dict(in_chans=7, num_frames=1, decoder_num_classes=448),
             dict(concat_dummy_token=True), dict(
                 main_input='flowback_rgb01',
                 main_input_kwargs={'iters': 2}))), 1):
        spec = (C.StreamSpec(**m, **main), C.StreamSpec(**c, **ctx))
        cpu = C.ConjoinedVMAE(*spec, device='cpu')
        sd = weights.init_conjoined_state_dict(
            cpu, torch.Generator().manual_seed(i))
        model = C.ConjoinedVMAE(*spec, device=d)
        wrappers.append((model, sd, kw))
    raft = weights.init_raft(RAFT(iters=2, device='cpu'),
                             torch.Generator().manual_seed(3))
    if d != 'cpu':
        gpu = RAFT(iters=2, device=d)
        gpu.load_state_dict(raft.state_dict(), strict=True)
        raft = gpu
    out = []
    for model, sd, kw in wrappers:
        if 'main_input_kwargs' in kw:
            kw['main_input_kwargs']['flow_model'] = raft
        out.append(C.ConjoinedPredictorWrapper(
            model, params={k: v.to(d) for k, v in sd.items()},
            context_input='imu', **kw))
    return out, raft


@pytest.mark.parametrize('engine', ['fast', 'exact'])
def test_imu_generator_on_the_card_matches_the_cpu(dev, engine,
                                                   monkeypatch):
    """ImuConditionedFlowGenerator at the small configuration in f32 (TF32
    off), the static-scene IMU from flow2imu, from the same weights and
    draws on the card and on the CPU: videos and flows within 1e-3; on the
    card the path's kernels ran the counts the code gives (a LayerNorm
    launch for each of the engine's norm calls, as many as on the CPU), on
    the CPU none."""
    from counterfactualworldmodels_tpu_torch.models import fast_vmae
    from counterfactualworldmodels_tpu_torch.pipelines.imu import (
        ImuConditionedFlowGenerator)
    norm_calls, qkv_calls = [], []
    real_norm, real_qkv = fast_vmae.add_layer_norm, fast_vmae.qkv_heads

    def counted_norm(*args, **kwargs):
        norm_calls.append(args[0].device.type)
        return real_norm(*args, **kwargs)

    def counted_qkv(*args, **kwargs):
        qkv_calls.append(args[0].device.type)
        return real_qkv(*args, **kwargs)
    monkeypatch.setattr(fast_vmae, 'add_layer_norm', counted_norm)
    monkeypatch.setattr(fast_vmae, 'qkv_heads', counted_qkv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(4)
    x = rng.rand(1, 3, 64, 64).astype(np.float32)
    active = np.ones((1, 128, 4), dtype=bool)
    active[:, :64] = False
    for i in range(4):
        active[0, 64 + rng.choice(64, 2, replace=False), i] = False
    outs = {}
    for d in ('cpu', 'cuda'):
        (imu, f2i), raft = _small_imu(d)
        gen = _fixed_draws(ImuConditionedFlowGenerator(
            predictor=imu, head_motion_predictor=f2i, flow_model=raft,
            raft_iters=2, imagenet_normalize_inputs=True, engine=engine,
            device=d), 5)
        kernels.reset_launches()
        y, f = gen.predict_counterfactual_videos_and_flows(
            x, active, num_samples=4, sample_batch_size=2)
        outs[d] = (y.cpu(), f.cpu(), dict(kernels.LAUNCHES))
    (yc, fc, lc), (yg, fg, lg) = outs['cpu'], outs['cuda']
    assert max(_err(yc, yg), _err(fc, fg)) <= 1e-3
    assert not any(lc.values())
    # flow2imu once (K1 in its 8 blocks, RAFT-2 forward and backward), two
    # chunks: fast, the prefix once (4 main blocks) and K2 in both encoder
    # and both decoder blocks per chunk; exact, the predictor's 8 blocks
    # per chunk
    norms, qkvs = norm_calls.count('cuda'), qkv_calls.count('cuda')
    assert norms == norm_calls.count('cpu')
    assert qkvs == qkv_calls.count('cpu')
    assert (norms > 0) == (qkvs > 0) == (engine == 'fast')
    want = (dict(flash_attention=8 + 4, flash_attention_prefix=2 * 4,
                 window_lookup=4 + 4, add_layer_norm=norms, qkv_heads=qkvs)
            if engine == 'fast' else
            dict(flash_attention=8 + 16, window_lookup=4 + 4))
    assert lg == dict({k: 0 for k in lg}, **want), lg


def _service_pair(model, sd, raft_cpu, batch_window_ms=0.0):
    """A CwmService on the CPU and one on the card over the same weights,
    each drawing its rectangularizer noise from the same numpy seed."""
    from counterfactualworldmodels_tpu_torch import serve
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        FlowGenerator)
    out = {}
    for d in ('cpu', 'cuda'):
        raft = raft_cpu
        if d == 'cuda':
            raft = RAFT(iters=2, device=d)
            raft.load_state_dict(raft_cpu.state_dict(), strict=True)
        gen = FlowGenerator(predictor=model, params=sd, flow_model=raft,
                            raft_iters=2, imagenet_normalize_inputs=True,
                            device=d)
        svc = serve.CwmService(gen, 32, batch_window_ms=batch_window_ms)

        def draw(s_total, s_pad, n, svc=svc):
            rng = np.random.RandomState(svc._req_counter)
            a = (rng.rand(s_total, n) * 0.999).astype(np.float32)
            a = np.concatenate([a, np.repeat(a[-1:], s_pad - s_total, 0)])
            return torch.from_numpy(a).to(svc.device)
        svc._draw_noise = draw
        out[d] = svc
    return out


def test_service_fast_route_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The server's shared-prefix dispatches (one scene, then two scenes
    over stacked prefix caches: K2 with s0 = 2) at the small configuration
    in f32 (TF32 off), card against CPU from the same draws: videos within
    1e-4, flows and the raw segments within 1e-3; on the card the launches
    the code gives, run from a request thread with grad mode on there,
    with no autograd graph."""
    import threading
    from counterfactualworldmodels_tpu_torch import serve
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(0))
    raft_cpu = weights.init_raft(RAFT(iters=2, device='cpu'),
                                 torch.Generator().manual_seed(1))
    services = _service_pair(model, sd, raft_cpu)
    seen = []
    fast, multi = (serve.counterfactual_videos_and_flows_fast,
                   serve.counterfactual_videos_and_flows_fast_multi)

    def spy(fn):
        def wrapped(*args, **kwargs):
            y, f, m = fn(*args, **kwargs)
            seen.append((torch.is_grad_enabled(), y, f, m))
            return y, f, m
        return wrapped

    monkeypatch.setattr(serve, 'counterfactual_videos_and_flows_fast',
                        spy(fast))
    monkeypatch.setattr(serve, 'counterfactual_videos_and_flows_fast_multi',
                        spy(multi))
    rng = np.random.RandomState(3)
    imgs = [rng.rand(32, 32, 3).round(3).tolist() for _ in range(2)]
    req = dict(active=[[2, 3], [5, 1]], passive=[[0, 0]], shift=[1, -1],
               num_samples=3)
    outs = {}
    for d, svc in services.items():
        seen.clear()
        kernels.reset_launches()
        res = {}

        def request(svc=svc, res=res):
            assert torch.is_grad_enabled()
            res['one'] = svc.counterfactual(dict(req, image=imgs[0]))
            items = [svc._parse_cf_request(dict(req, image=im,
                                                num_samples=1))
                     for im in imgs]
            n_vis = int((~(items[0][1] & items[0][2])).sum())
            res['two'] = svc._dispatch_cf_batch(('cf', n_vis), items)

        th = threading.Thread(target=request)
        th.start()
        th.join(timeout=300)
        assert not th.is_alive() and 'two' in res
        outs[d] = ([(g, y.cpu(), f.cpu(), m.cpu(), y.requires_grad)
                    for g, y, f, m in seen], res, dict(kernels.LAUNCHES))
    (c, cres, lc), (g, gres, lg) = outs['cpu'], outs['cuda']
    assert len(c) == len(g) == 2
    for (cg, cy, cf, cm, _), (gg, gy, gf, gm, greq) in zip(c, g):
        assert not cg and not gg and not greq
        assert torch.equal(cm, gm)
        assert _err(cy, gy) <= 1e-4 and _err(cf, gf) <= 1e-3
    for a, b in zip([cres['one'], *cres['two']],
                    [gres['one'], *gres['two']]):
        assert np.abs(np.asarray(a['segment_raw'])
                      - np.asarray(b['segment_raw'])).max() <= 1e-3
        assert a['prefix_cache_hit'] == b['prefix_cache_hit']
    assert gres['two'][0]['scene_batched'] == 2
    assert not any(lc.values())
    depth = model.encoder_depth + model.decoder_depth
    le, ld = model.encoder_depth, model.decoder_depth
    # the first scene's prefix, the second scene's (the first is a hit),
    # the suffix (K2 in every block) in both dispatches, a RAFT-2 in each;
    # the LayerNorms: a cold dispatch, then the second scene's prefix (its
    # blocks' 2 Le + 2 Ld and enc_norm) and one suffix pass over both
    assert lg == dict({k: 0 for k in lg}, flash_attention=2 * depth,
                      flash_attention_prefix=2 * depth,
                      window_lookup=2 * 2,
                      add_layer_norm=_cold_norms(le, ld)
                      + (2 * le + 2 * ld + 1) + _warm_norms(le, ld),
                      qkv_heads=4 * depth), lg


# head dims the kernels run padded (zero columns up to 16, 32 or 64): the
# small conjoined trainer's 8 and 24, the tiny ChannelMAE's 48, the tests'
# tiny conjoined model's 12; tile edges crossed as above
_PADDED_SHAPES = [(2, 4, 50, 50, 8), (2, 4, 39, 70, 24), (3, 2, 13, 13, 48),
                  (1, 2, 129, 65, 12), (1, 2, 100, 77, 100)]


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_padded_head_dims_match_plain(dev, dtype, atol):
    """K1, K5 and K6 at head dims between the kernels' own, against the
    plain versions at the unpadded dim; one launch each, outputs and
    gradients of the caller's shape."""
    rng = np.random.RandomState(9)
    for (b, h, nq, nk, d) in _PADDED_SHAPES:
        q, k, v, do = _grad_inputs(rng, dev, dtype, b, h, nq, nk, d)
        kernels.reset_launches()
        out = fa.flash_attention(q, k, v)
        out5, lse = fa._flash_forward_lse(q, k, v)
        ref, ref_lse = fa.dense_attention(q, k, v, with_lse=True)
        assert out.shape == out5.shape == q.shape
        assert _err(out, ref) <= atol and _err(out5, ref) <= atol, d
        assert torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5), d
        delta = (do.float() * ref.float()).sum(-1)
        got = fa._flash_backward(q, k, v, do, ref_lse, delta)
        want = fa._chunked_attention_bwd(q, k, v, do, ref_lse, delta)
        for name, a, r in zip('qkv', got, want):
            assert a.shape == r.shape, (d, name)
            if dtype == torch.float32:
                assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), (d, name)
            else:
                assert _err(a, r) <= 2e-2 * float(r.float().abs().max()), (
                    d, name)
        assert [kernels.LAUNCHES[n] for n in (
            'flash_attention', 'flash_attention_lse', 'flash_attention_bwd',
            'flash_attention_prefix')] == [1, 1, 1, 0]
        # the autograd route slices the gradients before autograd sees them
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(fa.flash_attention(*leaves), leaves, do)
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_channel_mae_step_on_the_card_matches_the_cpu(dev):
    """Three train steps of a tiny ChannelMAE (encoder head dim 48, run
    padded; f32, TF32 off) from the same weights and masks: losses and
    gradient norms rtol 1e-4, parameters atol 1e-4."""
    from counterfactualworldmodels_tpu_torch.models import cmae
    from counterfactualworldmodels_tpu_torch.training import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(image_size=(32, 32), patch_size=(8, 8), in_channels=3,
              channel_partition=(1, 2), encoder_embed_dim=96,
              encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=32,
              decoder_depth=1, decoder_num_heads=2, mlp_ratio=2.0,
              attn_impl='flash')
    ref = cmae.ChannelMae(device='cpu', **kw)
    opt = train.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                               total_steps=10)
    train.init_cmae_train_state(ref, opt, seed=1)
    init = ref.state_dict()
    gen = torch.Generator().manual_seed(2)
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        mask, counts = cmae.group_uniform_mask(gen, ref.mask_size, 0.75, 4)
        batches.append((torch.from_numpy(rng.rand(4, 3, 32, 32).astype(
            np.float32)), mask))
    n_vis = ref.num_patches - sum(counts)
    runs = {}
    for d in ('cpu', dev):
        model = cmae.ChannelMae(device=d, **kw)
        model.load_state_dict(init, strict=True)
        state = train.TrainState(0, model, opt.init(model.parameters()))
        step = train.make_cmae_train_step(model, opt, n_vis, counts,
                                          remat='dots')
        kernels.reset_launches()
        metrics = [step(state, x, m)[1] for x, m in batches]
        runs[str(d)] = ([(float(m['loss']), float(m['grad_norm']))
                         for m in metrics], dict(kernels.LAUNCHES),
                        model.state_dict())
    (mc, lc, pc), (mg, lg, pg) = runs['cpu'], runs['cuda']
    for a, b in zip(mc, mg):
        assert np.allclose(a, b, rtol=1e-4, atol=0), (a, b)
    for name in pc:
        assert torch.allclose(pc[name], pg[name].cpu(), atol=1e-4), name
    assert not any(lc.values())
    assert lg['flash_attention_lse'] == 3 * 2 * 3
    assert lg['flash_attention_bwd'] == 3 * 3


def test_kernel_lookup_refuses_autograd_on_the_card(dev):
    """The lookup kernel has no backward: on the card the default routing
    raises where autograd records the pyramid or the coordinates, and runs
    (one launch) without recording; impl='gather' differentiates there,
    with gradients within 1e-5 of the CPU's."""
    rng = np.random.RandomState(21)
    c = _rand(rng, 2, 6, 6, 6, 6)
    coords = torch.from_numpy((rng.rand(2, 6, 6, 2) * 8 - 1).astype(
        np.float32))
    cot = _rand(rng, 2, 6, 6, 3 * 81)
    grads = {}
    for d in ('cpu', dev):
        pyr = [lv.to(d).clone().requires_grad_()
               for lv in corr.build_pyramid(c, 3)]
        xy = coords.to(d).clone().requires_grad_()
        if d == dev:
            with pytest.raises(RuntimeError, match="impl='gather'"):
                corr.lookup_pyramid(pyr, xy, 4)
            kernels.reset_launches()
            with torch.no_grad():
                corr.lookup_pyramid(pyr, xy, 4)
            assert kernels.LAUNCHES['window_lookup'] == 1
        out = corr.lookup_pyramid(pyr, xy, 4, impl='gather')
        (out * cot.to(d)).sum().backward()
        grads[str(d)] = [t.grad.cpu() for t in pyr + [xy]]
    for a, b in zip(grads['cpu'], grads['cuda']):
        assert _err(a, b) <= 1e-5
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    model = traft.RAFT(iters=1, small=True, device=dev)
    im = torch.rand(1, 3, 64, 64, device=dev) * 255
    with pytest.raises(RuntimeError, match='no backward'):
        model(im, im)
    with torch.no_grad():
        model(im, im)


def test_small_raft_train_steps_on_the_card_match_the_cpu(dev):
    """Three steps of make_raft_train_step and of make_keypoint_distill_step
    on the small RAFT (f32, TF32 off, 2 iterations, 64x64) from the same
    weights and batches: losses, EPE and gradient norms rtol 1e-4; the
    card runs the gather lookup, no kernel launch."""
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.training import raft as TR
    from counterfactualworldmodels_tpu_torch.training import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(22)
    g = torch.Generator().manual_seed(22)
    flow = [TR.synthetic_flow_batch(torch.from_numpy(
        (rng.rand(2, 3, 64, 64) * 255).astype(np.float32)), max_mag=3.0,
        generator=g) for _ in range(3)]
    kp = [(torch.from_numpy((rng.rand(2, 3, 64, 64) * 255).astype(
        np.float32)), torch.from_numpy(rng.rand(2, 1, 64, 64).astype(
            np.float32))) for _ in range(3)]
    opt = train.make_optimizer(learning_rate=1e-4, warmup_steps=1,
                               total_steps=10)
    for keypoint, batches in ((False, flow), (True, kp)):
        runs = {}
        for d in ('cpu', dev):
            model = RAFT(small=True, iters=2, device=d,
                         output_dim=1 if keypoint else None)
            state = TR.init_raft_train_state(model, opt, seed=5)
            step = (TR.make_keypoint_distill_step(model, opt)
                    if keypoint else TR.make_raft_train_step(model, opt))
            kernels.reset_launches()
            metrics = []
            for batch in batches:
                state, m = step(state, *batch)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[str(d)] = (metrics, dict(kernels.LAUNCHES))
        (mc, _), (mg, lg) = runs['cpu'], runs['cuda']
        for a, b in zip(mc, mg):
            for k in a:
                assert np.isclose(b[k], a[k], rtol=1e-4, atol=0), (k, a, b)
        assert not any(lg.values())
