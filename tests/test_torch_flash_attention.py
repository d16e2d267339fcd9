"""Port parity: K1 (flash_attention) and K2 (flash_attention_prefix).

On CPU tensors the port's wrappers run their plain versions; these are
held against the JAX Pallas kernels run in interpret mode, as
tests/test_flash_attention.py runs them, at its tolerances (atol 2e-5 for
K1, 3e-5 for K2: f32 sums in another order). The kernels themselves are
compared with the plain versions on the card in test_torch_kernels_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.ops import flash_attention as jfa
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.ops import flash_attention as tfa

from torch_port_common import assert_close, t


def _qkv(rng, b, h, nq, nk, d):
    q = rng.randn(b, h, nq, d).astype(np.float32) * d ** -0.5
    k = rng.randn(b, h, nk, d).astype(np.float32)
    v = rng.randn(b, h, nk, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('nq,nk,d', [(64, 64, 64), (200, 200, 16),
                                     (70, 150, 32), (150, 40, 64)])
def test_flash_attention_plain_matches_jax_kernel(nq, nk, d):
    q, k, v = _qkv(np.random.RandomState(0), 2, 3, nq, nk, d)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), interpret=True))
    before = dict(kernels.LAUNCHES)
    out = tfa.flash_attention(t(q), t(k), t(v))
    assert kernels.LAUNCHES == before   # CPU tensors: plain version
    assert_close(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize('s0,w', [(1, (1.0, 1.0)), (1, (4.0, 4.0)),
                                  (3, (1.0, 1.0)), (3, (4.0, 16.0))])
def test_flash_attention_prefix_plain_matches_jax_kernel(s0, w):
    rng = np.random.RandomState(1)
    s, h, nq, n0, n1, d = 3, 2, 37, 70, 21, 16
    q = rng.randn(s, h, nq, d).astype(np.float32) * 0.3
    k0, v0 = (rng.randn(s0, h, n0, d).astype(np.float32) for _ in range(2))
    k1, v1 = (rng.randn(s, h, n1, d).astype(np.float32) for _ in range(2))
    ref = np.asarray(jfa.flash_attention_prefix(
        *(jnp.asarray(a) for a in (q, k0, v0, k1, v1)), interpret=True,
        prefix_weight=w[0], suffix_weight=w[1]))
    out = tfa.flash_attention_prefix(t(q), t(k0), t(v0), t(k1), t(v1),
                                     prefix_weight=w[0], suffix_weight=w[1])
    assert_close(out.numpy(), ref, atol=3e-5)


def test_flash_attention_prefix_rejections():
    z = torch.zeros
    q = z(3, 2, 5, 16)
    with pytest.raises(ValueError, match='prefix batch dim'):
        tfa.flash_attention_prefix(q, z(2, 2, 4, 16), z(2, 2, 4, 16),
                                   z(3, 2, 4, 16), z(3, 2, 4, 16))
    with pytest.raises(ValueError, match='empty panel'):
        tfa.flash_attention_prefix(q, z(1, 2, 0, 16), z(1, 2, 0, 16),
                                   z(3, 2, 4, 16), z(3, 2, 4, 16))
    with pytest.raises(ValueError, match='empty panel'):
        tfa.flash_attention_prefix(q, z(1, 2, 4, 16), z(1, 2, 4, 16),
                                   z(3, 2, 0, 16), z(3, 2, 0, 16))

