"""The block body's linears of ``ops.linear`` on the CPU.

``qkv_heads`` takes its plain version on CPU tensors; it must equal the
composition it replaced in the shared-prefix engine's block, kept here as
the oracle: the stacked ``[q_bias; 0; v_bias]`` added to the qkv product,
the ``permute().contiguous()`` head split, ``q * scale``, and the suffix's
pool of k and v (reshape, f32 mean, cast back). q and unpooled k, v bit for
bit in f32 and bf16; pooled k, v within one bf16 ulp (the kernel sums the
pool in another order). ``linear_gelu`` on the CPU must compute the GELU
it is asked for: ``torch._addmm_activation(..., use_gelu=True)`` is the
erf form on the CPU and the tanh form on the card, so the tanh rung's plain
route is the product then ``F.gelu(approximate='tanh')``. The card's kernel
is held against the plain version in tests/test_torch_kernels_cuda.py.
"""
import pytest
import torch
import torch.nn.functional as F

from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.ops import linear as lin


def _replaced(qkv, q_bias, v_bias, num_heads, scale, pool, grid):
    """The engine's composition before qkv_heads: bias add, head split,
    q * scale, _pool_kv_grid."""
    b, n, c = qkv.shape
    if q_bias is not None or v_bias is not None:
        zeros = torch.zeros(c // 3, dtype=qkv.dtype)
        qkv = qkv + torch.stack([zeros if q_bias is None else q_bias, zeros,
                                 zeros if v_bias is None else v_bias]
                                ).reshape(-1)
    qkv = qkv.reshape(b, n, 3, num_heads, c // (3 * num_heads))
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    if pool > 1:
        gh, gw = grid

        def pool_kv_grid(x):
            s, h, _, d = x.shape
            p = x.reshape(s, h, gh // pool, pool, gw // pool, pool, d)
            p = p.float().mean(dim=(3, 5))
            return p.reshape(s, h, (gh // pool) * (gw // pool),
                             d).to(x.dtype)
        k, v = pool_kv_grid(k), pool_kv_grid(v)
    return q * scale, k, v


def _bf16_ulp(a):
    """One bf16 ulp of each value's magnitude."""
    m = a.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


# (heads, d, tokens, pool, grid, q bias, v bias)
CASES = {
    'h8_d64_pool4_56x56': (8, 64, 3136, 4, (56, 56), True, True),
    'h16_d64_unpooled': (16, 64, 40, 1, None, True, True),
    'h6_d64_unpooled': (6, 64, 50, 1, None, True, True),
    'h4_d32_no_q_bias': (4, 32, 25, 1, None, False, True),
    'h4_d16_pool2_no_bias': (4, 16, 24, 2, (4, 6), False, False),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', list(CASES))
def test_plain_qkv_heads_is_the_composition_it_replaces(case, dtype):
    heads, d, n, pool, grid, has_q, has_v = CASES[case]
    g = torch.Generator().manual_seed(5)
    s, a = 2, heads * d
    qkv = (2 * torch.randn(s, n, 3 * a, generator=g)).to(dtype)
    q_bias = torch.randn(a, generator=g).to(dtype) if has_q else None
    v_bias = torch.randn(a, generator=g).to(dtype) if has_v else None
    scale = d ** -0.5
    q, k, v = lin.qkv_heads(qkv, q_bias, v_bias, heads, scale, pool, grid)
    wq, wk, wv = _replaced(qkv, q_bias, v_bias, heads, scale, pool, grid)
    n_kv = n // (pool * pool)
    assert q.shape == (s, heads, n, d) and q.is_contiguous()
    assert k.shape == v.shape == (s, heads, n_kv, d)
    assert k.is_contiguous() and v.is_contiguous()
    assert q.dtype == k.dtype == v.dtype == dtype
    assert torch.equal(q, wq)
    for got, want in ((k, wk), (v, wv)):
        if pool == 1:
            assert torch.equal(got, want)
        else:
            assert ((got.float() - want.float()).abs()
                    <= _bf16_ulp(want)).all()


def test_engine_qkv_is_the_product_then_qkv_heads():
    """fast_vmae._qkv: the plain qkv product, then qkv_heads with the
    block's biases and the scale it is given, pooled when asked."""
    g = torch.Generator().manual_seed(6)
    h = torch.randn(2, 16, 32, generator=g)
    p_attn = {'qkv_kernel': torch.randn(32, 96, generator=g),
              'q_bias': torch.randn(32, generator=g),
              'v_bias': torch.randn(32, generator=g)}
    scale = 8 ** -0.5
    qkv = torch.matmul(h, p_attn['qkv_kernel'])
    for pool, grid in ((1, None), (2, (4, 4))):
        got = tfv._qkv(p_attn, h, 4, scale, pool, grid)
        want = _replaced(qkv, p_attn['q_bias'], p_attn['v_bias'], 4, scale,
                         pool, grid)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_qkv_heads_takes_an_empty_batch():
    q, k, v = lin.qkv_heads(torch.zeros(0, 16, 24), None, None, 2, 0.5, 2,
                            (4, 4))
    assert q.shape == (0, 2, 16, 4) and k.shape == v.shape == (0, 2, 4, 4)


def _mlp_params(g, dim, hidden):
    return {'fc1': {'kernel': torch.randn(dim, hidden, generator=g) * 0.3,
                    'bias': torch.randn(hidden, generator=g)},
            'fc2': {'kernel': torch.randn(hidden, dim, generator=g) * 0.3,
                    'bias': torch.randn(dim, generator=g)}}


@pytest.mark.parametrize('gelu,approximate', [('tanh', 'tanh'),
                                              ('erf', 'none')])
def test_mlp_on_the_cpu_computes_the_gelu_it_is_asked_for(gelu,
                                                          approximate):
    """_mlp on CPU tensors in f32: fc2(GELU(fc1(x))) with the rung's GELU,
    to f32 precision; the two GELUs differ far more than that, so a plain
    route that took _addmm_activation (erf on the CPU) at the tanh rung
    fails here."""
    g = torch.Generator().manual_seed(7)
    p = _mlp_params(g, 24, 96)
    x = torch.randn(3, 10, 24, generator=g)

    def fc(q, t):
        return torch.matmul(t, q['kernel']) + q['bias']

    got = tfv._mlp(p, x, gelu)
    want = fc(p['fc2'], F.gelu(fc(p['fc1'], x), approximate=approximate))
    other = fc(p['fc2'], F.gelu(fc(p['fc1'], x), approximate='none'
                                if approximate == 'tanh' else 'tanh'))
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float((other - want).abs().max()) > 1e-3


def test_linear_is_the_product_plus_its_bias():
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 5, 12, generator=g)
    w, b = torch.randn(12, 7, generator=g), torch.randn(7, generator=g)
    torch.testing.assert_close(lin.linear(x, w, b), x @ w + b, rtol=1e-6,
                               atol=1e-6)
    assert lin.linear(x, w, b).shape == (2, 5, 7)
    # a strided input (the attention output's transposed view) too
    xt = torch.randn(2, 12, 5, generator=g).transpose(1, 2)
    torch.testing.assert_close(lin.linear(xt, w, b), xt @ w + b, rtol=1e-6,
                               atol=1e-6)
