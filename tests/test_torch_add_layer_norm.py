"""The residual add + LayerNorm wrapper and the shared-prefix engine's
pending-residual block loops, on the CPU.

``ops.layer_norm.add_layer_norm`` takes its plain version on CPU tensors:
``x + r`` then ``models.layers.layer_norm``, bit for bit. The engine's
blocks hand their MLP output pending to the next norm; below, the loops
are held bitwise against the settled form (each residual added where it
arises, each norm on the settled stream), written out here as the engine
had it, in f32 and bf16, for the prefix, the two-source encoder suffix
with pad keys, and the decoder suffix at the exact and the pooled rung.
The card's kernel is held against the plain version in
tests/test_torch_kernels_cuda.py.
"""
import pytest
import torch

from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models import layers, vmae
from counterfactualworldmodels_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_prefix, own_lengths)
from counterfactualworldmodels_tpu_torch.ops.layer_norm import add_layer_norm
from counterfactualworldmodels_tpu_torch.utils import weights

DTYPES = [torch.float32, torch.bfloat16]


def _rows(g, shape, dtype):
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_plain_add_layer_norm_is_add_then_layer_norm(dtype, residual):
    g = torch.Generator().manual_seed(0)
    for d in (32, 48, 100, 512, 1024):
        x = _rows(g, (3, 7, d), dtype) * 3
        r = _rows(g, (3, 7, d), dtype) if residual else None
        scale = 1 + 0.1 * torch.randn(d, generator=g)
        bias = 0.1 * torch.randn(d, generator=g)
        for p in (scale, scale.to(dtype)):
            b = bias.to(p.dtype)
            h, y = add_layer_norm(x, r, p, b, 1e-6)
            want_h = x + r if residual else x
            assert torch.equal(h, want_h)
            assert torch.equal(y, layers.layer_norm(want_h, p, b, 1e-6))
            assert y.dtype == dtype
        # a strided view takes the same path
        h, y = add_layer_norm(x[:, 1:5], None if r is None else r[:, 1:5],
                              scale, bias)
        assert torch.equal(y, layers.layer_norm(
            x[:, 1:5] + (0 if r is None else r[:, 1:5]), scale, bias))


# -- the settled form: the engine's block bodies before the residual went
# pending (each `h + o` / `h + m` added at once, each norm on its own)

def _settled_ln(x, p):
    return layers.layer_norm(x, p['scale'], p['bias'], 1e-6)


def _settled_prefix_block(p, h, num_heads):
    scale = (h.shape[-1] // num_heads) ** -0.5
    b, n, _ = h.shape
    ln = _settled_ln(h, p['norm1'])
    q, k, v = tfv._qkv(p['attn'], ln, num_heads, scale)
    o = tfv._proj(p['attn'], flash_attention(q, k, v), b, n)
    if 'gamma_1' in p:
        o = p['gamma_1'] * o
    h = h + o
    m = tfv._mlp(p['mlp'], _settled_ln(h, p['norm2']))
    if 'gamma_2' in p:
        m = p['gamma_2'] * m
    return h + m, (k, v)


def _settled_suffix_block(p, kv0, h, num_heads, prefix_weight=1.0,
                          suffix_pool=1, grid=None, gelu='erf',
                          key_valid=None):
    scale = (h.shape[-1] // num_heads) ** -0.5
    s, n, _ = h.shape
    k0, v0 = kv0
    ln = _settled_ln(h, p['norm1'])
    q, k, v = tfv._qkv(p['attn'], ln, num_heads, scale, suffix_pool, grid)
    o = flash_attention_prefix(
        q, k0, v0, k, v, prefix_weight=prefix_weight,
        suffix_weight=float(suffix_pool * suffix_pool),
        own_len=None if key_valid is None else own_lengths(key_valid))
    o = tfv._proj(p['attn'], o, s, n)
    if 'gamma_1' in p:
        o = p['gamma_1'] * o
    h = h + o
    m = tfv._mlp(p['mlp'], _settled_ln(h, p['norm2']), gelu)
    if 'gamma_2' in p:
        m = p['gamma_2'] * m
    return h + m


def _settled_prefix(stacked, h, num_heads, norm):
    ks, vs = [], []
    for i in range(tfv._num_layers(stacked)):
        h, (k, v) = _settled_prefix_block(tfv._layer(stacked, i), h,
                                          num_heads)
        ks.append(k)
        vs.append(v)
    return _settled_ln(h, norm), torch.stack(ks), torch.stack(vs)


def _settled_suffix(stacked, kvs, hs, norm, *args, **kw):
    for i in range(tfv._num_layers(stacked)):
        hs = _settled_suffix_block(tfv._layer(stacked, i),
                                   (kvs[0][i], kvs[1][i]), hs, *args, **kw)
    return _settled_ln(hs, norm)


@pytest.fixture(scope='module')
def engine():
    """A tiny VMAE with layer scale (gamma) and perturbed norm affines."""
    model = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True,
        init_values=0.5)
    g = torch.Generator().manual_seed(3)
    sd = weights.init_vmae_state_dict(model, g)
    for k in sd:
        if '.gamma_' in k or ('norm' in k and k.endswith(('weight', 'bias'))):
            sd[k] = sd[k] + 0.2 * torch.randn(sd[k].shape, generator=g)
    return model, sd


@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_block_loops_match_the_settled_form(engine, dtype):
    """The prefix (K1) and the encoder suffix (K2 with pad keys): stream,
    keys and values bitwise the settled form's."""
    model, sd = engine
    fp = tfv.stack_vmae_params(model, sd, dtype=dtype, device='cpu')
    g = torch.Generator().manual_seed(4)
    eh, dh = model.encoder_num_heads, model.decoder_num_heads
    tokens0 = _rows(g, (1, 64, 64), dtype)
    h, m, kvs = tfv._prefix_blocks(fp.enc_blocks, tokens0, eh)
    _, y = tfv._add_ln(h, m, fp.enc_norm)
    want_y, want_k, want_v = _settled_prefix(fp.enc_blocks, tokens0, eh,
                                             fp.enc_norm)
    assert torch.equal(y, want_y)
    assert torch.equal(kvs[0], want_k) and torch.equal(kvs[1], want_v)
    assert m is not None and m.dtype == dtype

    z0 = _rows(g, (1, 64, 32), dtype)
    _, _, dec_kvs = tfv._prefix_blocks(fp.dec_blocks, z0, dh)
    _, want_dk, want_dv = _settled_prefix(fp.dec_blocks, z0, dh, fp.dec_norm)
    assert torch.equal(dec_kvs[0], want_dk)
    assert torch.equal(dec_kvs[1], want_dv)

    tok = _rows(g, (3, 8, 64), dtype)
    valid = torch.ones(3, 8, dtype=torch.bool)
    valid[0, 5:] = False
    valid[2, 1:] = False
    hs, ms = tfv._suffix_blocks(fp.enc_blocks, kvs, tok, eh, key_valid=valid)
    _, ys = tfv._add_ln(hs, ms, fp.enc_norm)
    assert torch.equal(ys, _settled_suffix(fp.enc_blocks, kvs, tok,
                                           fp.enc_norm, eh, key_valid=valid))


@pytest.mark.parametrize('rung', [(1, 1, 'erf'), (2, 2, 'tanh'),
                                  (4, 4, 'tanh')],
                         ids=['exact', 'pool2', 'pool4'])
@pytest.mark.parametrize('dtype', DTYPES, ids=['f32', 'bf16'])
def test_suffix_decoder_matches_the_settled_form(engine, dtype, rung):
    """The decoder suffix over the full frame-1 grid (8 x 8 tokens) on K2
    (pooled prefix and own keys on the pooled rungs), then dec_norm:
    bitwise the settled form's."""
    model, sd = engine
    pp, sp, gelu = rung
    fp = tfv.stack_vmae_params(model, sd, dtype=dtype, device='cpu')
    g = torch.Generator().manual_seed(5)
    dh = model.decoder_num_heads
    z0 = _rows(g, (1, 64, 32), dtype)
    _, _, dec_kvs = tfv._prefix_blocks(fp.dec_blocks, z0, dh)
    pw = 1.0
    if pp > 1:
        dec_kvs = tfv.pool_dec_prefix(dec_kvs, pp, 8, 8)
        pw = float(pp * pp)
    z1 = _rows(g, (3, 64, 32), dtype)
    args = (dh, pw, sp, (8, 8), gelu)
    y1, m1 = tfv._suffix_blocks(fp.dec_blocks, dec_kvs, z1, *args)
    _, y1 = tfv._add_ln(y1, m1, fp.dec_norm)
    want = _settled_suffix(fp.dec_blocks, dec_kvs, z1, fp.dec_norm, *args)
    assert torch.equal(y1, want)
