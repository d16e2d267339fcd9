"""Port parity: the exact VMAE (models/layers.py, models/vmae.py) against
the JAX flax modules, both attention implementations, at the tolerance of
tests/test_vmae.py (atol 2e-4 / rtol 1e-4). Weights are initialised in JAX
and bridged with utils/weights.vmae_state_dict_from_jax; with
attn_impl='flash' JAX runs its Pallas kernel in interpret mode and the port
its kernel's plain version (CPU tensors)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import layers as jlayers
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models import layers as tlayers
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import SMALL_VMAE, assert_close, t

TOL = dict(atol=2e-4, rtol=1e-4)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _block_state(node, prefix='b'):
    sd = {}
    weights._block(sd, prefix, _np_tree(node))
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def _attention_state(node):
    node = _np_tree(node)
    w = node['qkv_kernel']                              # [D, 3, A]
    return {'qkv.weight': t(w.reshape(w.shape[0], -1).T),
            'q_bias': t(node['q_bias']), 'v_bias': t(node['v_bias']),
            'proj.weight': t(node['proj']['kernel'].T),
            'proj.bias': t(node['proj']['bias'])}


def _tokens(seed, b, n, d):
    return np.random.RandomState(seed).randn(b, n, d).astype(np.float32)


@pytest.mark.parametrize('attn_impl', ['dense', 'flash'])
def test_attention_matches_jax(attn_impl):
    x = _tokens(0, 2, 37, 64)
    jm = jlayers.Attention(64, 4, qkv_bias=True, attn_impl=attn_impl)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))['params']
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape),
        params)   # nonzero q/v biases
    ref = np.asarray(jm.apply({'params': params}, jnp.asarray(x)))
    tm = tlayers.Attention(64, 4, qkv_bias=True, attn_impl=attn_impl)
    tm.load_state_dict(_attention_state(params), strict=True)
    with torch.no_grad():
        out = tm(t(x))
    assert_close(out.numpy(), ref, **TOL)


@pytest.mark.parametrize('attn_impl,init_values', [('dense', None),
                                                   ('flash', None),
                                                   ('dense', 0.5)])
def test_block_matches_jax(attn_impl, init_values):
    x = _tokens(1, 2, 41, 64)
    jm = jlayers.Block(64, 4, 2.0, qkv_bias=True, init_values=init_values,
                       attn_impl=attn_impl)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))['params']
    ref = np.asarray(jm.apply({'params': params}, jnp.asarray(x)))
    tm = tlayers.Block(64, 4, 2.0, qkv_bias=True, init_values=init_values,
                       attn_impl=attn_impl)
    tm.load_state_dict(_block_state(params), strict=True)
    with torch.no_grad():
        out = tm(t(x))
    assert_close(out.numpy(), ref, **TOL)


def _pair(**kw):
    cfg = dict(SMALL_VMAE, **kw)
    jm = jvmae.PretrainVisionTransformer(**cfg)
    params = jvmae.init_params(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**cfg)
    module = tvmae.PretrainVisionTransformerModule(tm, device='cpu')
    module.load_state_dict(weights.vmae_state_dict_from_jax(
        _np_tree(params), 3, tm.full_patch_size), strict=True)
    return jm, params, tm, module


def _batch(seed, cfg, b, n_vis):
    rng = np.random.RandomState(seed)
    h, w = cfg.img_size
    x = rng.randn(b, 3, cfg.num_frames, h, w).astype(np.float32)
    mask = np.ones((b, cfg.num_patches), dtype=bool)
    for i in range(b):
        mask[i, rng.choice(cfg.num_patches, n_vis, replace=False)] = False
    return x, mask


VARIANTS = [dict(attn_impl='dense'), dict(attn_impl='flash'),
            dict(init_values=0.5, tubelet_size=2),
            dict(use_learnable_pos_emb=True)]


@pytest.mark.parametrize('kw', VARIANTS)
def test_encoder_matches_jax(kw):
    jm, params, tm, module = _pair(**kw)
    x, mask = _batch(1, tm, 2, 20)
    ref = np.asarray(jm.apply({'params': params}, jnp.asarray(x),
                              jnp.asarray(mask), 20, method=jm.encode))
    with torch.no_grad():
        out = module.encode(t(x), t(mask), 20)
    assert_close(out.numpy(), ref, **TOL)


@pytest.mark.parametrize('kw', VARIANTS)
def test_apply_vmae_matches_jax(kw):
    jm, params, tm, module = _pair(**kw)
    n_vis = 30
    x, mask = _batch(2, tm, 2, n_vis)
    ref = np.asarray(jvmae.apply_vmae(jm, params, jnp.asarray(x),
                                      jnp.asarray(mask), n_vis))
    before = dict(kernels.LAUNCHES)
    out = tvmae.apply_vmae(module, t(x), t(mask), n_vis)
    assert kernels.LAUNCHES == before   # CPU tensors: plain versions
    assert out.shape == ref.shape and out.grad_fn is None
    assert_close(out.numpy(), ref, **TOL)


@pytest.mark.parametrize('count', [0, -1, 5])
def test_decoder_last_tokens_rules_match_jax(count):
    jm, params, tm, module = _pair()
    x = _tokens(3, 2, 12, tm.decoder_embed_dim)
    jdec = jvmae.VMAEDecoder(embed_dim=tm.decoder_embed_dim,
                             depth=tm.decoder_depth,
                             num_heads=tm.decoder_num_heads,
                             num_classes=tm.out_dim)
    ref = np.asarray(jdec.apply({'params': params['decoder']},
                                jnp.asarray(x), count))
    with torch.no_grad():
        out = module.decoder(t(x), count)
    assert out.shape == ref.shape
    assert_close(out.numpy(), ref, **TOL)


def test_take_tokens_and_mask_token_lerp_match_jax():
    rng = np.random.RandomState(4)
    tokens = rng.randn(2, 9, 5).astype(np.float32)
    idx = np.stack([rng.permutation(9)[:4] for _ in range(2)])
    assert_close(tvmae.take_tokens(t(tokens), t(idx)).numpy(),
                 np.asarray(jvmae.take_tokens(jnp.asarray(tokens),
                                              jnp.asarray(idx))), atol=0)
    mask = rng.rand(2, 9).astype(np.float32) * 1.4 - 0.2
    token = rng.randn(1, 1, 5).astype(np.float32)
    for invert in (True, False):
        ref = jlayers.interpolate_with_mask_token(
            jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(token),
            invert)
        out = tlayers.interpolate_with_mask_token(t(tokens), t(mask),
                                                  t(token), invert)
        assert_close(out.numpy(), np.asarray(ref), atol=1e-6)


def test_seeded_init_and_bf16_module():
    """init_params is reproducible from its seed; a bf16 model keeps f32
    parameters and computes in bf16."""
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE, dtype=torch.bfloat16)
    a = tvmae.init_params(tm, seed=3, device='cpu')
    b = tvmae.init_params(tm, seed=3, device='cpu')
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert p.dtype == torch.float32 and torch.equal(p, q), name
    x, mask = _batch(5, tm, 1, 70)
    out = tvmae.apply_vmae(a, t(x), t(mask), 70)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
