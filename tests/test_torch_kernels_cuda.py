"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (and nvcc, to build the kernels); skips without one.
This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

bf16 attention runs on the tensor-core kernels (``*_sm90``: wgmma, shapes
cut into 64- and 128-row tiles), f32 on the CUDA-core ones; the shapes
below cross those tile edges (Nk under one tile, Nq and Nk one past a
boundary) at every head dim.

Tolerances: f32 2e-5 / 3e-5 (the JAX kernel tests' bounds: sums in another
order); bf16 2e-2 (outputs of magnitude ~1 differ by a couple of bf16 ulps:
the kernel rounds the unnormalised probabilities to bf16 before P.V, as
the JAX kernel does, where the plain version rounds the normalised ones);
the lookup 1e-5 (sums in another order), and its bf16 output bitwise
the f32 output cast. The training pair: the lse at 1e-4 and the f32 gradients
at atol 2e-4 / rtol 1e-4 (tests/test_flash_attention.py's bounds); bf16
gradients within 2e-2 of their largest magnitude.
"""
import numpy as np
import pytest
import torch

from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models.raft import corr
from counterfactualworldmodels_tpu_torch.ops import flash_attention as fa

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
        assert _err(out, fa._chunked_dense_attention(q, k, v)) <= atol


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
        ref = fa._dense_two_source(q, k0, v0, k1, v1, *w)
        assert _err(out, ref) <= atol, (s0, n0, n1, w, d)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                           q)
    with pytest.raises(ValueError, match='mixed dtypes'):
        fa.flash_attention(q, q.bfloat16(), q)
    q48 = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_attention(q48, q48, q48)


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
        ref, ref_lse = fa._chunked_dense_attention(q, k, v, with_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (b, h, nq)
        assert _err(out, ref) <= atol
        assert torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype):
    rng = np.random.RandomState(4)
    for (b, h, nq, nk, d) in _BWD_SHAPES:
        q, k, v, do = _grad_inputs(rng, dev, dtype, b, h, nq, nk, d)
        out, lse = fa._chunked_dense_attention(q, k, v, with_lse=True)
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
    for shape in [(2, 4, 333, 333, 64), (1, 2, 129, 65, 128),
                  (2, 2, 200, 77, 32)]:
        q, k, v, do = _grad_inputs(rng, dev, torch.bfloat16, *shape)
        out, lse = fa._flash_forward_lse(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        first = fa._flash_backward(q, k, v, do, lse, delta)
        second = fa._flash_backward(q, k, v, do, lse, delta)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), shape


def test_bf16_attention_runs_on_the_tensor_core_kernels(dev):
    """bf16 calls launch the wgmma kernels, f32 calls the CUDA-core ones."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(8)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = _grad_inputs(rng, dev, dtype, 1, 2, 130, 130, 64)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, lse = fa._flash_forward_lse(q, k, v)
            fa.flash_attention_prefix(q, k, v, k, v, 1.0, 4.0)
            fa._flash_backward(q, k, v, do, lse,
                               (do.float() * out.float()).sum(-1))
            torch.cuda.synchronize()
        names[dtype] = ' '.join(e.key for e in prof.key_averages())
    for kernel in ('attention_fwd_sm90', 'dkdv_sm90', 'dq_sm90'):
        assert kernel in names[torch.bfloat16]
        assert kernel not in names[torch.float32]
    for kernel in ('attention_kernel', 'dkdv_kernel', 'dq_kernel'):
        assert kernel in names[torch.float32]
        assert kernel not in names[torch.bfloat16]


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
    ref = torch.autograd.grad(fa._chunked_dense_attention(*ref_leaves),
                              ref_leaves, do)
    for name, a, r in zip('qkv', grads, ref):
        assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), name
    with torch.no_grad():
        fa.flash_attention(*leaves)
    assert kernels.LAUNCHES['flash_attention'] == 1


def test_flash_attention_prefix_refuses_a_gradient_on_the_card(dev):
    z = torch.zeros
    q = z(2, 2, 8, 64, device=dev, requires_grad=True)
    kv = [z(n, 2, 8, 64, device=dev) for n in (1, 1, 2, 2)]
    with pytest.raises(RuntimeError, match='no backward'):
        fa.flash_attention_prefix(q, *kv)
    with torch.no_grad():
        assert fa.flash_attention_prefix(q, *kv).shape == q.shape
