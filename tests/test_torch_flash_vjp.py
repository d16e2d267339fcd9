"""Port parity: the training half of flash attention, K5 (forward with
logsumexp) and K6 (fused backward), behind ``flash_attention``'s
autograd Function.

On CPU tensors the Function runs the plain versions of K5 and K6; these
are held against the JAX Pallas kernels run in interpret mode, with
``CWM_FLASH_BWD=pallas`` so that JAX differentiates through its Pallas
backward, as tests/test_flash_attention.py runs them, at its tolerances.
The CUDA kernels are compared with the plain versions on the card in
test_torch_kernels_cuda.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.ops import flash_attention as jfa
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.ops import flash_attention as tfa

from torch_port_common import assert_close, t


def _inputs(seed, b, h, n, nk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, n, d).astype(np.float32) * 0.3
    k = rng.randn(b, h, nk, d).astype(np.float32) * 0.3
    v = rng.randn(b, h, nk, d).astype(np.float32)
    co = rng.randn(b, h, n, d).astype(np.float32)
    return q, k, v, co


def test_lse_forward_plain_matches_jax_kernel():
    """K5's plain version against _flash_bhnd_lse, ragged on both axes."""
    q, k, v, _ = _inputs(3, 1, 3, 200, 333, 64)
    out, lse = jfa._flash_bhnd_lse(jnp.asarray(q[0]), jnp.asarray(k[0]),
                                   jnp.asarray(v[0]), 64, 128, True)
    before = dict(kernels.LAUNCHES)
    got, got_lse = tfa._flash_forward_lse(t(q), t(k), t(v))
    assert kernels.LAUNCHES == before   # CPU tensors: plain version
    assert got_lse.dtype == torch.float32 and got_lse.shape == (1, 3, 200)
    assert_close(got[0].numpy(), out, atol=1e-6)
    np.testing.assert_allclose(got_lse[0].numpy(), np.asarray(lse),
                               atol=1e-4, rtol=1e-5)


def test_bwd_plain_matches_jax_kernel():
    """K6's plain version against _flash_bwd_bhnd fed the same residuals."""
    q, k, v, co = _inputs(7, 1, 2, 200, 333, 64)
    _, lse = tfa._flash_forward_lse(t(q), t(k), t(v))
    out = tfa.dense_attention(t(q), t(k), t(v))
    delta = (t(co) * out).sum(-1)
    ref = jfa._flash_bwd_bhnd(*(jnp.asarray(a[0]) for a in (q, k, v, co)),
                              jnp.asarray(lse[0].numpy()),
                              jnp.asarray(delta[0].numpy()), 128, 128, True)
    got = tfa._chunked_attention_bwd(t(q), t(k), t(v), t(co), lse, delta)
    for name, a, r in zip('qkv', got, ref):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize('b,h,n,nk', [(1, 2, 200, 333), (1, 2, 256, 256)])
def test_function_gradients_match_jax_pallas_backward(monkeypatch, b, h, n,
                                                      nk):
    """Ragged cross-attention and exact-divisor self-attention, as
    test_flash_attention.py:326-372 run them."""
    monkeypatch.setenv('CWM_FLASH_BWD', 'pallas')
    q, k, v, co = _inputs(4, b, h, n, nk, 64)
    ref = jax.grad(lambda *a: jnp.sum(jfa.flash_attention(*a) * co),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    # the Function's own backward, not autograd through the plain forward
    assert type(out.grad_fn).__name__ == '_FlashAttentionBackward'
    grads = torch.autograd.grad(out, leaves, t(co))
    for name, a, r in zip('qkv', grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


def test_forward_without_a_gradient_keeps_no_graph():
    q, k, v, _ = _inputs(8, 1, 2, 40, 50, 32)
    out = tfa.flash_attention(t(q), t(k), t(v))
    assert out.grad_fn is None
    with torch.no_grad():
        out = tfa.flash_attention(t(q).requires_grad_(), t(k), t(v))
    assert out.grad_fn is None


def test_refuse_grad_guard_of_the_two_source_kernel():
    """flash_attention_prefix raises on the card when a gradient is asked
    for; this is the condition it checks."""
    a = torch.zeros(2, 3)
    b = torch.zeros(2, 3, requires_grad=True)
    tfa._refuse_grad('k2', a, a)
    with pytest.raises(RuntimeError, match='k2 has no backward'):
        tfa._refuse_grad('k2', a, b)
    with torch.no_grad():
        tfa._refuse_grad('k2', a, b)
