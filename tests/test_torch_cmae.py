"""Port parity: ChannelMAE (models/cmae.py), its Soft variants, the weight
bridge, ImagePatchEmbed and the head-dim padding of the attention wrappers,
against the JAX package on the same numpy inputs and JAX-initialised weights
(bridged by utils/weights.channel_mae_state_dict_from_jax, loaded with
strict=True).

Tolerances (tests/test_cmae.py's): outputs and images atol 5e-4, labels
1e-6, losses rtol 1e-4; masks bitwise on JAX's draws."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import cmae as jcmae
from counterfactualworldmodels_tpu.models import layers as jlayers
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models import cmae as tcmae
from counterfactualworldmodels_tpu_torch.models import layers as tlayers
from counterfactualworldmodels_tpu_torch.ops import flash_attention as fa
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import assert_close, t

IMG, PATCH = 32, 8
KW = dict(image_size=(IMG, IMG), patch_size=(PATCH, PATCH),
          encoder_embed_dim=48, encoder_depth=2, encoder_num_heads=4,
          decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=4,
          mlp_ratio=2.0, qkv_bias=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(cls, partition, base=(), attn_impl='dense'):
    """(JAX model, its params, the port's model with them loaded)."""
    kw = dict(KW, in_channels=sum(partition), channel_partition=partition,
              concat_base_channels=base)
    jm = getattr(jcmae, cls)(**kw)
    x = jnp.zeros((2, sum(partition), IMG, IMG))
    if cls == 'ChannelMae':
        mask, counts = jcmae.group_uniform_mask(
            jax.random.PRNGKey(1), jm.mask_size, 0.5, 2)
        n_vis = mask.shape[1] - sum(counts)
        init = jax.jit(lambda k: jm.init(k, x, mask, n_vis, counts,
                                         method=jm.forward_groups))
    else:
        init = jax.jit(lambda k: jm.init(k, x, jnp.zeros((2, jm.num_patches))))
    params = init(jax.random.PRNGKey(0))['params']
    tm = getattr(tcmae, cls)(**kw, attn_impl=attn_impl, device='cpu')
    tm.load_state_dict(weights.channel_mae_state_dict_from_jax(
        _np(params), partition, (PATCH, PATCH)), strict=True)
    return jm, params, tm


@pytest.fixture(scope='module')
def hard():
    """Groups (1, 2) with the base channel 0 appended to each (the bridge
    takes each patch embedding's width from its kernel)."""
    return _pair('ChannelMae', (1, 2), base=(0,))


def _inputs(jm, seed=0, b=2, ratio=0.75):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, sum(jm.partition), IMG, IMG).astype(np.float32)
    mask, counts = jcmae.group_uniform_mask(jax.random.PRNGKey(seed + 5),
                                            jm.mask_size, ratio, b)
    mask = np.asarray(mask)
    return x, mask, mask.shape[1] - sum(counts), counts


@pytest.mark.parametrize('attn_impl', ['dense', 'flash'])
def test_forward_groups_matches_jax(hard, attn_impl):
    jm, params, tm = hard
    attns = [m for m in tm.modules() if isinstance(m, tlayers.Attention)]
    for a in attns:
        a.attn_impl = attn_impl
    x, mask, n_vis, counts = _inputs(jm)
    ref = jcmae.apply_channel_mae(jm, params, jnp.asarray(x), mask, n_vis,
                                  counts)
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got = tcmae.apply_channel_mae(tm, t(x), t(mask), n_vis, counts)
        same = tm(t(x), t(mask), n_vis, counts)
    for a in attns:
        a.attn_impl = 'dense'
    assert kernels.LAUNCHES == before
    assert len(got) == len(ref) == 2
    for g, r, s in zip(got, ref, same):
        assert g.shape == r.shape
        assert_close(g, r, atol=5e-4)
        assert torch.equal(g, s)


def test_labels_loss_and_predicted_image_match_jax(hard):
    jm, params, tm = hard
    x, mask, n_vis, counts = _inputs(jm, seed=1)
    jx = jnp.asarray(x)
    labels = jm.apply({'params': params}, jx, mask, counts,
                      method=jm.compute_labels)
    loss = jcmae.channel_mae_train_loss(jm, params, jx, mask, n_vis, counts)
    image = jcmae.channel_mae_predict_image(jm, params, jx, mask, n_vis,
                                            counts)
    with torch.no_grad():
        tl = tm.compute_labels(t(x), t(mask), counts)
        tloss = tcmae.channel_mae_train_loss(tm, t(x), t(mask), n_vis, counts)
        timg = tcmae.channel_mae_predict_image(tm, t(x), t(mask), n_vis,
                                               counts)
    for g, r in zip(tl, labels):
        assert_close(g, r, atol=1e-6)
    assert np.isclose(float(tloss), float(loss), rtol=1e-4, atol=0)
    assert timg.shape == image.shape == x.shape
    assert_close(timg, image, atol=5e-4)
    # visible patches come from the input unchanged
    vis = ~mask.reshape(2, 2, 4, 4)[:, 0]        # group 0: channel 0
    got_p = timg[:, :1].reshape(2, 1, 4, PATCH, 4, PATCH)
    in_p = t(x)[:, :1].reshape(2, 1, 4, PATCH, 4, PATCH)
    for b in range(2):
        for i, j in zip(*np.nonzero(vis[b])):
            assert torch.equal(got_p[b, :, i, :, j], in_p[b, :, i, :, j])


def test_properties_match_jax(hard):
    jm, _, tm = hard
    for name in ('partition', 'num_channel_groups', 'patch_dim',
                 'patches_per_group', 'num_patches', 'mask_size',
                 'channel_group_start_inds'):
        assert tuple(np.atleast_1d(getattr(tm, name))) == tuple(
            np.atleast_1d(getattr(jm, name))), name
    assert tm.encoder.mask_size == jm.mask_size
    assert [e.proj.weight.shape[1] for e in tm.encoder.patch_embed] == [2, 3]


@pytest.mark.parametrize('ratio,b', [(0.75, 3), (0.5, 1), (0.0, 2)])
def test_group_uniform_mask_bitwise_on_jax_draws(ratio, b):
    """The scores are JAX's: uniform draws on B * G split keys, as
    group_uniform_mask splits them."""
    size = (3, 4, 4)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, b * 3).reshape(b, 3, 2)
    scores = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (16,))))(keys)
    ref, ref_counts = jcmae.group_uniform_mask(key, size, ratio, b)
    got, counts = tcmae.group_uniform_mask(t(scores), size, ratio, b)
    assert counts == ref_counts
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    drawn, c2 = tcmae.group_uniform_mask(torch.Generator().manual_seed(0),
                                         size, ratio, b)
    assert c2 == counts and drawn.shape == (b, 48)
    assert (drawn.reshape(b, 3, 16).sum(-1) == counts[0]).all()
    with pytest.raises(ValueError, match='draws'):
        tcmae.group_uniform_mask(t(scores)[:, :2], size, ratio, b)


@pytest.mark.parametrize('cls', ['SoftChannelMae', 'SoftInputChannelMae'])
def test_soft_variants_match_jax(cls):
    jm, params, tm = _pair(cls, (1, 2))
    rng = np.random.RandomState(3)
    x = rng.rand(2, 3, IMG, IMG).astype(np.float32)
    soft = rng.rand(2, jm.num_patches).astype(np.float32)
    soft[:, :5] = 0.0
    jx, js = jnp.asarray(x), jnp.asarray(soft)
    ref = jm.apply({'params': params}, jx, js)
    labels = jm.apply({'params': params}, jx,
                      method=jcmae.SoftChannelMae.compute_labels)
    loss = jcmae.soft_channel_mae_train_loss(jm, params, jx, js)
    rec = jcmae.soft_channel_mae_recombine(jm, ref)
    with torch.no_grad():
        got = tm(t(x), t(soft))
        tl = tm.compute_labels(t(x))
        tloss = tcmae.soft_channel_mae_train_loss(tm, t(x), t(soft))
        trec = tcmae.soft_channel_mae_recombine(tm, got)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert_close(g, r, atol=5e-4)
    for g, r in zip(tl, labels):
        assert_close(g, r, atol=1e-6)
    assert np.isclose(float(tloss), float(loss), rtol=1e-4, atol=0)
    assert trec.shape == rec.shape
    assert_close(trec, rec, atol=5e-4)
    for replace in (True, False):
        img = jcmae.soft_channel_mae_predict_image(
            jm, params, jx, js, replace_visible_patches_with_input=replace)
        with torch.no_grad():
            timg = tcmae.soft_channel_mae_predict_image(
                tm, t(x), t(soft), replace_visible_patches_with_input=replace)
        assert_close(timg, img, atol=5e-4)
    # differentiable in the soft mask
    sm = t(soft).requires_grad_()
    tcmae.soft_channel_mae_train_loss(tm, t(x), sm).backward()
    assert sm.grad is not None and float(sm.grad.abs().sum()) > 0


@pytest.mark.parametrize('cls', ['ChannelMae', 'SoftChannelMae',
                                 'SoftInputChannelMae'])
def test_seeded_weights_load_strictly(cls):
    kw = dict(KW, in_channels=3, channel_partition=(1, 2))
    model = getattr(tcmae, cls)(**kw, device='cpu')
    sd = weights.init_channel_mae_state_dict(model,
                                             torch.Generator().manual_seed(0))
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    assert 0.01 < float(sd['mask_token'].std()) < 0.04
    qkv = sd['encoder.blocks.0.attn.qkv.weight']
    assert float(qkv.abs().max()) <= (6.0 / (3 * 48 + 48 * 48)) ** 0.5
    again = weights.init_channel_mae_state_dict(
        model, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_image_patch_embed_matches_jax():
    jm = jlayers.ImagePatchEmbed(patch_size=(4, 4), embed_dim=24)
    x = np.random.RandomState(4).rand(2, 3, 16, 12).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    ref = jm.apply({'params': params}, jnp.asarray(x))
    tm = tlayers.ImagePatchEmbed((4, 4), 3, 24)
    tm.load_state_dict({'proj.weight': t(np.asarray(params['proj']['kernel']).T),
                        'proj.bias': t(params['proj']['bias'])}, strict=True)
    with torch.no_grad():
        got = tm(t(x))
        five = tm(t(x)[:, :, None])
    assert got.shape == ref.shape == (2, 12, 24)
    assert_close(got, ref, atol=1e-5)
    assert torch.equal(got, five)
    with pytest.raises(ValueError, match='one frame'):
        tm(torch.zeros(1, 3, 2, 16, 12))


@pytest.mark.parametrize('d', [8, 12, 24, 48, 100])
def test_head_dim_padding_is_exact_in_the_plain_versions(d):
    """The card wrappers pad q, k, v (and dO) with zero columns up to the
    next kernel head dim and slice the results back: run through the plain
    versions, the padded route equals the unpadded one (the forward, the
    lse and the three gradients)."""
    kd = fa.kernel_head_dim(d)
    assert kd in (16, 32, 64, 128) and kd >= d
    rng = np.random.RandomState(d)
    q = t((rng.randn(2, 3, 37, d) * d ** -0.5).astype(np.float32))
    k, v, do = (t(rng.randn(2, 3, n, d).astype(np.float32))
                for n in (29, 29, 37))
    pq, pk, pv, pdo = fa.pad_head_dim(q, k, v, do)
    assert pq.shape[-1] == kd and torch.equal(pq[..., :d], q)
    assert not pq[..., d:].any()
    out, lse = fa.dense_attention(q, k, v, with_lse=True)
    pout, plse = fa.dense_attention(pq, pk, pv, with_lse=True)
    assert_close(pout[..., :d], out, atol=1e-6)
    assert not pout[..., d:].any()
    assert_close(plse, lse, atol=1e-6)
    delta = (do * out).sum(-1)
    grads = fa._chunked_attention_bwd(q, k, v, do, lse, delta)
    pgrads = fa._chunked_attention_bwd(pq, pk, pv, pdo, lse, delta)
    for g, pg in zip(grads, pgrads):
        assert_close(pg[..., :d], g, atol=1e-6)
        assert not pg[..., d:].any()


def test_head_dims_beyond_the_kernels_raise():
    assert fa.kernel_head_dim(128) == 128 and fa.kernel_head_dim(1) == 16
    with pytest.raises(ValueError, match='head dim'):
        fa.kernel_head_dim(129)
    q = torch.zeros(1, 2, 4, 160)
    with pytest.raises(ValueError, match='head dim'):
        fa._check_cuda('flash_attention', q, q, q)
    q = torch.zeros(1, 2, 4, 48)
    fa._check_cuda('flash_attention', q, q, q)      # padded on the card
