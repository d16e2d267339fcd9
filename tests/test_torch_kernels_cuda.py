"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (and nvcc, to build the kernels); skips without one.
This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 2e-5 / 3e-5 (the JAX kernel tests' bounds: sums in another
order); bf16 2e-2 (outputs of magnitude ~1 differ by a couple of bf16 ulps,
the kernel keeping probabilities in f32 where the plain version rounds
them to bf16); the lookup 1e-5.
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
                              (2, 2, 130, 200, 64), (1, 2, 70, 90, 128)]:
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
    rng = np.random.RandomState(1)
    for s0, w in [(1, (1.0, 1.0)), (1, (16.0, 16.0)), (3, (1.0, 4.0))]:
        q = _rand(rng, 3, 2, 50, 64, scale=0.125).to(dev, dtype)
        k0, v0 = (_rand(rng, s0, 2, 33, 64).to(dev, dtype) for _ in range(2))
        k1, v1 = (_rand(rng, 3, 2, 65, 64).to(dev, dtype) for _ in range(2))
        before = kernels.LAUNCHES['flash_attention_prefix']
        out = fa.flash_attention_prefix(q, k0, v0, k1, v1, *w)
        assert kernels.LAUNCHES['flash_attention_prefix'] == before + 1
        ref = fa._dense_two_source(q, k0, v0, k1, v1, *w)
        assert _err(out, ref) <= atol


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
