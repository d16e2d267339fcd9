"""Port parity: the conjoined (two-stream) VMAE, its cross-attention blocks,
the stream preprocessors and the weight bridge, against the JAX package on
the CPU.

Tiny configurations like tests/test_fast_conjoined.py:_tiny (64 px, 8x8
patches, 2 layers, widths <= 48), in both flavours: a padded IMU context
without a dummy token, and a non-padded context with one. Weights are
JAX-initialised and carried across by
``utils/weights.conjoined_state_dict_from_jax``, which must equal the JAX
package's ``export_conjoined`` key for key and bitwise. The port's models
run attn_impl 'flash' (the kernel's plain version on the CPU) against
JAX's dense route. Masks bitwise; model outputs within 1e-4 (f32); the
flow preprocessor's output (flows normalised by half the image size, and
RGB) within 1e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import conjoined as jconj
from counterfactualworldmodels_tpu.models import preprocessor as jpre
from counterfactualworldmodels_tpu.models import transformer as jtr
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.utils import torch_export
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import preprocessor as tpre
from counterfactualworldmodels_tpu_torch.models import transformer as ttr
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (IMG, IMU_LEN, IMU_TOK, N, N0, assert_close,
                               conj_pair, conj_specs, t)

FLAVOURS = ['padded', 'dummy']
specs, model_pair = conj_specs, conj_pair
_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def inputs(rng, b=3, vis_per_row=(2, 2, 2), imu_vis=IMU_TOK):
    """Video [B, 3, 2, H, W] (predictor layout), IMU [B, 6, L], masks with
    frame 0 visible and vis_per_row[i] visible frame-1 patches, and an IMU
    mask with the first imu_vis tokens visible."""
    x = rng.rand(b, 3, 2, IMG, IMG).astype(np.float32)
    imu = (rng.randn(b, 6, IMU_LEN) * 0.1).astype(np.float32)
    mask = np.ones((b, N), bool)
    mask[:, :N0] = False
    for i, k in enumerate(vis_per_row):
        mask[i, N0 + rng.choice(N - N0, k, replace=False)] = False
    mask_c = np.ones((b, IMU_TOK), bool)
    mask_c[:, :imu_vis] = False
    return x, imu, mask, mask_c


def wrappers(jm, params, tm, sd):
    kw = dict(main_input='rgb01', main_input_kwargs={'unnormalize': False},
              context_input='imu')
    return (jconj.ConjoinedPredictorWrapper(jm, params=params, **kw),
            tconj.ConjoinedPredictorWrapper(tm, params=sd, **kw))


@pytest.mark.parametrize('flavour', FLAVOURS)
def test_bridge_equals_export_conjoined(flavour):
    jm, params, tm, sd = model_pair(flavour)
    ref = torch_export.export_conjoined(jm, params)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    # the module's own keys are the reference layout, nothing more
    assert sorted(tm.state_dict()) == sorted(ref)
    assert ('context_stream.encoder.dummy_token' in sd) == (flavour == 'dummy')
    assert ('main_stream.null_token_enc' in sd) == (flavour == 'padded')


@pytest.mark.parametrize('flavour', FLAVOURS)
@pytest.mark.parametrize('outputs', [(True, False), (False, True),
                                     (True, True)],
                         ids=['main', 'context', 'both'])
def test_exact_forward_matches_jax(flavour, outputs):
    """The wrapper's forward (stream inputs, static visible counts, the
    two-stream model) on ragged rows where the stream pads them."""
    jm, params, tm, sd = model_pair(flavour)
    jw, tw = wrappers(jm, params, tm, sd)
    rng = np.random.RandomState(1)
    ragged = flavour == 'padded'
    x, imu, mask, mask_c = inputs(rng, vis_per_row=(1, 3, 2) if ragged
                                  else (2, 2, 2), imu_vis=4)
    if ragged:
        mask_c[1, 3] = True          # a ragged IMU mask too
    om, oc = outputs
    ref = jw(jnp.asarray(x), jnp.asarray(mask), x_context=jnp.asarray(imu),
             mask_context=jnp.asarray(mask_c), output_main=om,
             output_context=oc)
    out = tw(t(x), t(mask), x_context=t(imu), mask_context=t(mask_c),
             output_main=om, output_context=oc)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape
        assert_close(a.numpy(), b, 1e-4)


@pytest.mark.parametrize('flavour', FLAVOURS)
def test_missing_imu_matches_jax(flavour):
    """No x_context: the zeroed, fully masked IMU stream."""
    jm, params, tm, sd = model_pair(flavour)
    jw, tw = wrappers(jm, params, tm, sd)
    x, _, mask, _ = inputs(np.random.RandomState(2))
    ref = jw(jnp.asarray(x), jnp.asarray(mask), output_main=True,
             output_context=True)
    out = tw(t(x), t(mask), output_main=True, output_context=True)
    for a, b in zip(out, ref):
        assert_close(a.numpy(), b, 1e-4)
    with pytest.raises(ValueError, match='mask_context is required'):
        tw(t(x), t(mask), x_context=torch.zeros(3, 6, IMU_LEN))


def test_static_n_vis_rules_and_strip_padding():
    """_static_n_vis: padded streams pad to the widest row (at least one
    null), refuse a spread the null budget cannot cover; unequal
    non-padded rows raise. strip_padding drops max - min padding rows and
    nothing when that is 0."""
    for flavour in FLAVOURS:
        jm, params, tm, sd = model_pair(flavour)
        jw, tw = wrappers(jm, params, tm, sd)
        for rows in ([3, 3], [1, 5], [0, 0]):
            mask = np.ones((2, N), bool)
            for i, k in enumerate(rows):
                mask[i, :k] = False
            spec_j, spec_t = jm.main, tm.main
            try:
                ref = jw._static_n_vis(jnp.asarray(mask), spec_j)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    tw._static_n_vis(t(mask), spec_t)
                continue
            assert tw._static_n_vis(t(mask), spec_t) == ref
        y = np.arange(2 * 20 * 3, dtype=np.float32).reshape(2, 20, 3)
        np.testing.assert_array_equal(tw.strip_padding(t(y)).numpy(),
                                      np.asarray(jw.strip_padding(y)))
    main, ctx, pairs = specs(tconj, 'padded')
    main.max_padding_tokens = 10
    with pytest.raises(ValueError, match='spread'):
        tconj.ConjoinedPredictorWrapper._static_n_vis(
            None, t(np.array([[False] * 12 + [True] * 4,
                              [True] * 16])), main)
    main.min_padding_tokens = 10
    m = tconj.ConjoinedVMAE(main=main, context=ctx, device='cpu', **pairs)
    w = tconj.ConjoinedPredictorWrapper(m, main_input='rgb01',
                                        context_input='imu')
    y = torch.ones(1, 5, 2)
    assert w.strip_padding(y) is y          # num_pad == 0: keep all


def test_pad_tokens_and_mask_matches_jax():
    rng = np.random.RandomState(3)
    tokens = rng.randn(3, 10, 4).astype(np.float32)
    null = rng.randn(1, 1, 4).astype(np.float32)
    mask = rng.rand(3, 10) > 0.5
    n_vis = int((~mask).sum(-1).max()) + 1
    jt_, jmask = jconj.pad_tokens_and_mask(jnp.asarray(tokens),
                                           jnp.asarray(mask),
                                           jnp.asarray(null), n_vis, 6)
    tt, tmask = tconj.pad_tokens_and_mask(t(tokens), t(mask), t(null), n_vis,
                                          6)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt_))
    assert ((~tmask).sum(-1) == n_vis).all()


@pytest.mark.parametrize('dummy', [False, True])
def test_imu_encoder_tokens_match_jax(dummy):
    """append_dummy + tokenize (the Conv3d weight [E, C, pt, 1, 1] as a
    matmul on (pt, c) patches), and the missing-IMU path."""
    flavour = 'dummy' if dummy else 'padded'
    jm, params, tm, sd = model_pair(flavour)
    enc = jconj.ImuEncoder(sequence_length=IMU_LEN, tubelet_size=8,
                           in_chans=6, embed_dim=32, depth=2, num_heads=4,
                           mlp_ratio=2.0, concat_dummy_token=dummy)
    imu = np.random.RandomState(4).randn(2, 6, IMU_LEN, 1, 1).astype(
        np.float32)
    mask = np.zeros((2, IMU_TOK), bool)

    def tok(mod, imu5, m):
        imu5, m = mod.append_dummy(imu5, m)
        return mod.tokenize(imu5), m

    for given in (imu, None):
        ref, rmask = enc.apply({'params': params['context_encoder']},
                               None if given is None else jnp.asarray(given),
                               jnp.asarray(mask), method=tok)
        te = tm.context_stream.encoder
        x5, m5 = te.append_dummy(None if given is None else t(given),
                                 t(mask))
        assert_close(te.tokenize(x5).detach().numpy(), ref, 1e-5)
        np.testing.assert_array_equal(m5.numpy(), np.asarray(rmask))


def _cross_pair(rng, **kw):
    blk = jtr.CrossAttentionTransformerBlock(in_dim=48, in_dim_src=32,
                                             num_heads=4, mlp_ratio=2.0, **kw)
    x = rng.randn(2, 10, 48).astype(np.float32)
    src = rng.randn(2, 7, 32).astype(np.float32)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(src))['params']
    if kw.get('init_values'):
        # non-trivial layerscales, so a misplaced gamma shows
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v * (1.0 + 0.1 * jnp.arange(v.shape[0]))
            if 'gamma' in jax.tree_util.keystr(p) else v, params)
    sd = {}
    weights._cross_block(sd, 'b', _np_tree(params))
    mine = ttr.CrossAttentionTransformerBlock(48, 4, in_dim_src=32,
                                              mlp_ratio=2.0, **kw)
    mine.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return blk, params, mine, x, src


@pytest.mark.parametrize('kw', [
    dict(with_self_attention=False),
    dict(with_self_attention=False, shared_similarity=True),
    dict(with_self_attention=True, qkv_bias=True, init_values=0.5),
    dict(with_self_attention=False, unidirectional=True, qkv_bias=True),
], ids=['bidirectional', 'shared', 'self-attention+gammas', 'unidirectional'])
def test_cross_blocks_match_flax(kw):
    blk, params, mine, x, src = _cross_pair(np.random.RandomState(5), **kw)
    y_ref, s_ref = blk.apply({'params': params}, jnp.asarray(x),
                             jnp.asarray(src))
    with torch.no_grad():
        y, s = mine(t(x), t(src))
    assert_close(y.numpy(), y_ref, 1e-5)
    if kw.get('unidirectional'):
        assert s_ref is not None and s is not None
    assert_close(s.numpy(), s_ref, 1e-5)


def test_transformer_block_matches_flax():
    """A width-changing block: the bias-free shortcut, the attention's
    out_dim, the mlp and the layerscales."""
    rng = np.random.RandomState(6)
    blk = jtr.TransformerBlock(in_dim=32, num_heads=4, out_dim=48,
                               qkv_bias=True, init_values=0.3, mlp_ratio=2.0)
    x = rng.randn(2, 9, 32).astype(np.float32)
    p = _np_tree(blk.init(jax.random.PRNGKey(1), jnp.asarray(x))['params'])
    mine = ttr.TransformerBlock(32, 4, out_dim=48, qkv_bias=True,
                                init_values=0.3, mlp_ratio=2.0)
    a = p['attention']
    w = a['qkv_kernel']
    sd = {'attention.qkv.weight': t(w.reshape(w.shape[0], -1).T),
          'attention.q_bias': t(a['q_bias']),
          'attention.v_bias': t(a['v_bias']),
          'attention.projection.weight': t(a['projection']['kernel'].T),
          'attention.projection.bias': t(a['projection']['bias']),
          'shortcut.weight': t(p['shortcut']['kernel'].T),
          'gamma_1': t(p['gamma_1']), 'gamma_2': t(p['gamma_2'])}
    for n in ('norm1', 'norm2'):
        sd[f'{n}.weight'], sd[f'{n}.bias'] = t(p[n]['scale']), t(p[n]['bias'])
    for i in (0, 2):
        sd[f'mlp.layers.{i}.weight'] = t(p['mlp'][f'layers_{i}']['kernel'].T)
        sd[f'mlp.layers.{i}.bias'] = t(p['mlp'][f'layers_{i}']['bias'])
    mine.load_state_dict(sd, strict=True)
    with torch.no_grad():
        assert_close(mine(t(x)).numpy(),
                     blk.apply({'params': p}, jnp.asarray(x)), 1e-5)


def test_factories_match_jax_shapes():
    """Both released configurations: the port's module (on the meta device,
    no memory) has the JAX model's parameter count, and the stream counts
    of the released checkpoints."""
    for jf, tf in ((jconj.imu400_base_4x4patch_2frames_1tube,
                    tconj.imu400_base_4x4patch_2frames_1tube),
                   (jconj.imu400_8x8patch_2frames_1tube_flowbackrgb01,
                    tconj.imu400_8x8patch_2frames_1tube_flowbackrgb01)):
        jm = jf()
        shapes = jax.eval_shape(lambda: jconj.init_conjoined_params(jm))
        n_jax = sum(int(np.prod(s.shape))
                    for s in jax.tree_util.tree_leaves(shapes))
        tm = tf(device='meta')
        assert sum(p.numel() for p in tm.state_dict().values()) == n_jax
        assert tm.main.num_patches == jm.main.num_patches
        assert tm.context.total_tokens == jm.context.total_tokens
        assert tm.attn_impl == 'flash'
    tm = tconj.imu400_base_4x4patch_2frames_1tube(device='meta')
    assert tm.main.padded and tm.context.padded
    assert tm.enc_pairs == ((0, 0), (3, 3), (6, 6), (9, 9))
    assert sorted(tm.decoder_conjoining_blocks) == ['0-0', '1-1', '2-2', '3-3']
    with pytest.raises(ValueError, match='non-decreasing'):
        main, ctx, _ = specs(tconj, 'padded')
        tconj.ConjoinedVMAE(main=main, context=ctx,
                            conjoin_encoder_layers=((0, 1), (1, 0)),
                            device='meta')


def test_seeded_init_loads_strictly():
    """init_conjoined_state_dict gives every key of the module, at its
    shape, from a seed (the same seed gives the same weights)."""
    for flavour in FLAVOURS:
        main, ctx, pairs = specs(tconj, flavour)
        m = tconj.ConjoinedVMAE(main=main, context=ctx, device='cpu', **pairs)
        sd = weights.init_conjoined_state_dict(
            m, torch.Generator().manual_seed(3))
        m.load_state_dict(sd, strict=True)
        again = weights.init_conjoined_state_dict(
            m, torch.Generator().manual_seed(3))
        assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_checkpoint_load_path(tmp_path):
    """A reference .pth ({'model': ...} with DDP prefixes) loads with
    strict=True through the wrapper's load_path; a missing key fails."""
    jm, params, tm, sd = model_pair('padded')
    path = tmp_path / 'conj.pth'
    torch.save({'model': {'module.' + k: v for k, v in sd.items()}}, path)
    main, ctx, pairs = specs(tconj, 'padded')
    fresh = tconj.ConjoinedVMAE(main=main, context=ctx, device='cpu', **pairs)
    w = tconj.ConjoinedPredictorWrapper(fresh, load_path=str(path))
    for k, v in sd.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert sorted(w.params) == sorted(sd)
    bad = dict(sd)
    bad.pop('main_stream.mask_token')
    torch.save(bad, tmp_path / 'bad.pth')
    with pytest.raises(RuntimeError, match='mask_token'):
        tconj.ConjoinedPredictorWrapper(fresh, load_path=str(tmp_path
                                                             / 'bad.pth'))


@pytest.fixture(scope='module')
def rafts():
    jr = jraft.RAFT(iters=2)
    rp = _init_raft(jr, jax.random.PRNGKey(7), IMG)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(_np_tree(rp)),
                       strict=True)
    return jr, rp, tr


@pytest.mark.parametrize('name,kw', [
    ('flowback_rgb01', {}), ('flow01', {}), ('flow_rgb01', {}),
    ('flowback01', {'unnormalize_rgb': False})])
def test_frame_pair_flow_matches_jax(rafts, name, kw):
    """The flow preprocessors on the port's RAFT: forward (and backward)
    flow normalised by half the image size, the RGB frame concatenated,
    the output frame count recorded at call time."""
    jr, rp, tr = rafts
    rng = np.random.RandomState(8)
    coarse = rng.rand(1, 3, 8, 8).astype(np.float32)
    img = np.asarray(jax.image.resize(jnp.asarray(coarse), (1, 3, IMG, IMG),
                                      'bilinear'))
    x = np.stack([img, np.roll(img, 3, axis=-1)], axis=2)   # [1,3,2,H,W]
    jp = jpre.get_preprocessor(name, flow_model=jr, flow_params=rp, iters=2,
                               **kw)
    tp = tpre.get_preprocessor(name, flow_model=tr, iters=2, device='cpu',
                               **kw)
    ref = jp(jnp.asarray(x))
    out = tp(t(x))
    assert tuple(out.shape) == ref.shape
    assert_close(out.numpy(), ref, 1e-4)
    assert tp.num_channels == jp.num_channels == out.shape[1]
    m3 = np.arange(2 * 2 * 5).reshape(2, 2, 5) % 3 == 0
    np.testing.assert_array_equal(
        tp.get_output_frames(t(m3), temporal_dim=1).numpy(),
        np.asarray(jp.get_output_frames(jnp.asarray(m3), temporal_dim=1)))


@pytest.mark.parametrize('name', ['rgb01', 'rgb02', 'rgb0', 'rgb1', 'rgb12',
                                  'rgb012', 'rgb01stack', 'imu'])
@pytest.mark.parametrize('unnormalize', [True, False])
def test_registry_preprocessors_match_jax(name, unnormalize):
    rng = np.random.RandomState(9)
    if name == 'imu':
        x = rng.randn(2, 6, IMU_LEN).astype(np.float32)
    else:
        x = rng.rand(2, 3, 3, 8, 8).astype(np.float32)
    jp = jpre.get_preprocessor(name, unnormalize=unnormalize)
    tp = tpre.get_preprocessor(name, unnormalize=unnormalize)
    assert_close(tp(t(x)).numpy(), jp(jnp.asarray(x)), 1e-6)
    assert tp.get_num_frames() == jp.get_num_frames()
    if name != 'imu':
        m3 = rng.rand(2, 3, 4) > 0.5
        np.testing.assert_array_equal(
            tp.get_output_frames(t(m3), temporal_dim=1).numpy(),
            np.asarray(jp.get_output_frames(jnp.asarray(m3),
                                            temporal_dim=1)))


def test_noise_and_normalize_preprocessors():
    """Noise takes its draws as an input (or from a Generator);
    ImagenetNormalize both ways as JAX's."""
    rng = np.random.RandomState(10)
    x = rng.rand(2, 3, 2, 8, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jn = jpre.Noise1()
    ref = jn(jnp.asarray(x), key=key)
    draws = np.asarray(jax.random.uniform(key, ref.shape, ref.dtype))
    tn = tpre.Noise1()
    np.testing.assert_array_equal(tn(t(x), noise=t(draws)).numpy(),
                                  np.asarray(ref))
    g = tpre.Noise1(generator=torch.Generator().manual_seed(0))
    a, b = g(t(x)), g(t(x))
    assert a.shape == (2, 3, 1, 8, 8) and not torch.equal(a, b)
    assert float(a.min()) >= 0 and float(a.max()) < 1
    for un in (False, True):
        assert_close(tpre.ImagenetNormalize(unnormalize=un)(t(x)).numpy(),
                     jpre.ImagenetNormalize(unnormalize=un)(jnp.asarray(x)),
                     1e-6)
