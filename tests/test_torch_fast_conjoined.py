"""Port parity: the conjoined shared-prefix engine
(models/fast_conjoined.py) against the JAX package's on the CPU.

The tiny conjoined model of tests/test_fast_conjoined.py in both flavours
(padded IMU context without a dummy token; non-padded context with one),
JAX-initialised weights bridged by ``conjoined_state_dict_from_jax`` and
re-laid-out by ``cast_params``. The JAX engine runs its dense route (the
JAX package's CPU route); the port's kernel wrappers take their plain
versions on CPU tensors. Prefix caches, frame-1 predictions and videos
within 1e-4 (f32); masks and routing exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import fast_conjoined as jfc
from counterfactualworldmodels_tpu.models import conjoined as jconj
from counterfactualworldmodels_tpu.ops.normalization import (
    imagenet_normalize as jnorm)
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import fast_conjoined as tfc

from torch_port_common import (IMG, IMU_LEN, IMU_TOK, N, N0, assert_close,
                               conj_pair, t)

FLAVOURS = ['padded', 'dummy']

# the JAX engine's pieces under jit: one compile instead of an op-by-op run
_jencode = jax.jit(jfc.encode_conjoined_prefix, static_argnums=(0, 4))
_jframe1 = jax.jit(jfc.predict_frame1_conjoined, static_argnums=(0, 5, 6))
_jcross_full = jax.jit(jfc._cross_full, static_argnums=3)
_jcross_suffix = jax.jit(jfc._cross_suffix, static_argnums=4)


def engines(flavour, **kw):
    """(JAX model, params, wrapper; port model, engine params, wrapper)."""
    jm, params, tm, sd = conj_pair(flavour, **kw)
    wkw = dict(main_input='rgb01', main_input_kwargs={'unnormalize': False},
               context_input='imu')
    jw = jconj.ConjoinedPredictorWrapper(jm, params=params, **wkw)
    tw = tconj.ConjoinedPredictorWrapper(tm, params=sd, **wkw)
    tp = tfc.cast_params(tm, sd, torch.float32, 'cpu')
    return jm, params, jw, tm, tp, tw


def workload(seed, s=3, counts=(4, 4, 4)):
    """x_mocos [S, 2, 3, H, W] sharing frame 0 (a smooth image and its
    shift; frame 1 perturbed per sample), masks with frame 0 visible and
    counts[i] visible frame-1 patches, and one IMU [1, 6, L]."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(1, 3, 8, 8).astype(np.float32)
    img = np.asarray(jax.image.resize(jnp.asarray(coarse), (1, 3, IMG, IMG),
                                      'bilinear'))
    x = np.stack([img, np.roll(img, 3, axis=-1)], axis=1)
    x = np.repeat(x, s, axis=0)
    x[1:, 1] += 0.05 * rng.randn(s - 1, 3, IMG, IMG).astype(np.float32)
    imu = (rng.randn(1, 6, IMU_LEN) * 0.1).astype(np.float32)
    mask = np.ones((s, N), bool)
    mask[:, :N0] = False
    for i, k in enumerate(counts):
        mask[i, N0 + rng.choice(N - N0, k, replace=False)] = False
    return x, mask, imu


def test_cast_params_and_support():
    """cast_params casts every leaf once; conjoined_fast_supported matches
    JAX's on the model variants it gates."""
    _, _, _, tm, _, _ = engines('padded')
    _, _, _, _, sd = (None,) + conj_pair('padded')
    p16 = tfc.cast_params(tm, sd, torch.bfloat16, 'cpu')
    leaves = []

    def walk(n):
        if isinstance(n, dict):
            [walk(v) for v in n.values()]
        elif isinstance(n, list):
            [walk(v) for v in n]
        else:
            leaves.append(n)
    walk(p16)
    assert leaves and all(v.dtype == torch.bfloat16 for v in leaves)
    for flavour in FLAVOURS:
        jm, _, tm_, _ = conj_pair(flavour)
        assert tfc.conjoined_fast_supported(tm_) == \
            jfc.conjoined_fast_supported(jm) is True
    jm, _, tm_, _ = conj_pair('padded')
    tm_.main.min_padding_tokens = 1
    try:
        assert not tfc.conjoined_fast_supported(tm_)
        with pytest.raises(ValueError, match='does not support'):
            tfc.cast_params(tm_, sd)
    finally:
        tm_.main.min_padding_tokens = 0


def _port_cross(pc_jax):
    """A JAX cross block's params as the engine's dict (through the
    bridge's layout)."""
    from counterfactualworldmodels_tpu_torch.utils import weights
    sd = {}
    weights._cross_block(sd, 'b', jax.tree_util.tree_map(np.asarray, pc_jax))
    return tfc._cross_params(sd, 'b')


@pytest.mark.parametrize('stacked', [False, True])
def test_cross_primitives_match_jax(stacked):
    """_cross_full and _cross_suffix (shared or per-sample cached prefix
    keys, with suffix_valid pad masking) against JAX's."""
    from counterfactualworldmodels_tpu.models.transformer import (
        CrossAttentionTransformerBlock)
    rng = np.random.RandomState(1)
    blk = CrossAttentionTransformerBlock(
        in_dim=48, in_dim_src=32, num_heads=4, mlp_ratio=2.0,
        with_self_attention=False)
    s = 3
    x = rng.randn(s if stacked else 1, 10, 48).astype(np.float32)
    src = rng.randn(s, 7, 32).astype(np.float32)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(src[:x.shape[0]]))['params']
    pc = _port_cross(params)
    jx, js, jkv = _jcross_full(params, jnp.asarray(x),
                               jnp.asarray(src[:x.shape[0]]), 4)
    tx, ts, tkv = tfc._cross_full(pc, t(x), t(src[:x.shape[0]]), 4)
    for a, b in zip((tx, ts, *tkv), (jx, js, *jkv)):
        assert_close(a.numpy(), b, 1e-5)
    h = rng.randn(s, 5, 48).astype(np.float32)
    valid = np.ones((s, 5), bool)
    valid[0, 3:] = False
    valid[2, :] = False                 # a row whose keys are all pad
    jh, jsrc = _jcross_suffix(params, jnp.asarray(h), jnp.asarray(src),
                              jkv, 4, suffix_valid=jnp.asarray(valid))
    th, tsrc = tfc._cross_suffix(pc, t(h), t(src), tkv, 4,
                                 suffix_valid=t(valid))
    assert torch.isfinite(tsrc).all() and torch.isfinite(th).all()
    assert_close(th.numpy(), jh, 1e-5)
    assert_close(tsrc.numpy(), jsrc, 1e-5)


@pytest.mark.parametrize('flavour', FLAVOURS)
@pytest.mark.parametrize('cross', [
    (((0, 0), (-1, -1)), ((0, 0), (1, 1))),
    (((1, 0),), ((0, 1),)),
    ((), ())], ids=['released', 'asymmetric', 'uncoupled'])
def test_prefix_and_frame1_match_jax(flavour, cross):
    """encode_conjoined_prefix (every cached K/V and the context tokens)
    and predict_frame1_conjoined, at exact width."""
    enc, dec = cross
    jm, params, jw, tm, tp, tw = engines(flavour, enc_cross=enc,
                                         dec_cross=dec)
    x, mask, imu = workload(2)
    xm = np.asarray(jnorm(jnp.asarray(x), temporal_dim=1)).swapaxes(1, 2)
    vis1 = np.stack([np.nonzero(~mask[i, N0:])[0] for i in range(3)])
    jcache = _jencode(jm, params, jnp.asarray(xm[0:1, :, 0]),
                      jnp.asarray(imu), False)
    tcache = tfc.encode_conjoined_prefix(tm, tp, t(xm[0:1, :, 0]), t(imu))
    jl = jax.tree_util.tree_leaves(jcache)
    tl = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda v: v.numpy(), tuple(tcache)))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        assert_close(a, b, 1e-4)
    jy = _jframe1(jm, params, jcache, jnp.asarray(xm[:, :, 1]),
                  jnp.asarray(vis1), False, False)
    ty = tfc.predict_frame1_conjoined(tm, tp, tcache, t(xm[:, :, 1]),
                                      t(vis1).long())
    assert_close(ty.numpy(), jy, 1e-4)


@pytest.mark.parametrize('flavour', FLAVOURS)
def test_videos_with_bucketing_and_ragged_rows_match_jax(flavour):
    """predict_videos_conjoined_prefix on rows of 0, 3 and 5 visible
    frame-1 patches in one bucket of 8: a row whose suffix keys are all
    pad stays finite, and every row equals JAX's and its own exact-width
    run."""
    jm, params, jw, tm, tp, tw = engines(flavour)
    x, mask, imu = workload(3, counts=(0, 3, 5))
    mask_c = np.zeros((1, IMU_TOK), bool)
    n_vis = N0 + 5
    jy = jfc.predict_videos_conjoined_prefix(
        jw, params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(imu),
        jnp.asarray(mask_c), n_vis, True, False)
    ty = tfc.predict_videos_conjoined_prefix(
        tw, tp, t(x), t(mask), t(imu), t(mask_c), n_vis, True)
    assert torch.isfinite(ty).all()
    assert_close(ty.numpy(), jy, 1e-4)
    for i, k in enumerate((0, 3, 5)):
        # the row at its exact width: a suffix of k tokens, no pad slot
        yi = tfc._conjoined_videos_core(
            tw, tp, t(x[i:i + 1]), t(mask[i:i + 1]), t(imu), t(mask_c), k,
            True)
        assert_close(ty[i].numpy(), yi[0].numpy(), 1e-5)
    assert n_vis > N0


def test_stacked_caches_match_serial_and_jax():
    """stack_conjoined_prefix_caches: one prompt on each of 3 (scene, IMU)
    pairs in one dispatch == the per-scene calls, and == JAX's."""
    jm, params, jw, tm, tp, tw = engines('padded')
    scenes, serial, jserial = [], [], []
    mask_c = np.zeros((1, IMU_TOK), bool)
    for seed in (11, 12, 13):
        x, mask, imu = workload(seed, s=1, counts=(4,))
        cache = tfc.make_conjoined_prefix_cache(tw, tp, t(x[0:1]), t(imu),
                                                True)
        serial.append(tfc.predict_videos_conjoined_prefix(
            tw, tp, t(x), t(mask), t(imu), t(mask_c), N0 + 4, True,
            cache=cache))
        jcache = jfc.make_conjoined_prefix_cache(
            jw, params, jnp.asarray(x[0:1]), jnp.asarray(imu), True, False)
        scenes.append((x, mask, imu, cache, jcache))
    cat = lambda i: np.concatenate([s[i] for s in scenes])  # noqa: E731
    stacked = tfc.stack_conjoined_prefix_caches([s[3] for s in scenes])
    assert stacked.ctx_tokens.shape[0] == 3
    mc = np.zeros((3, IMU_TOK), bool)
    ty = tfc.predict_videos_conjoined_prefix(
        tw, tp, t(cat(0)), t(cat(1)), t(cat(2)), t(mc), N0 + 4, True,
        cache=stacked)
    assert_close(ty.numpy(), torch.cat(serial).numpy(), 2e-5)
    jy = jfc.predict_videos_conjoined_prefix(
        jw, params, jnp.asarray(cat(0)), jnp.asarray(cat(1)),
        jnp.asarray(cat(2)), jnp.asarray(mc), N0 + 4, True, False,
        cache=jfc.stack_conjoined_prefix_caches([s[4] for s in scenes]))
    assert_close(ty.numpy(), jy, 1e-4)
    assert tfc.stack_conjoined_prefix_caches([scenes[0][3]]) is scenes[0][3]


def test_lru_keys_on_scene_and_imu():
    """The LRU hits on the same frame 0 and IMU (whatever frame 1), misses
    on a new IMU embedding of the same frame, and an injected cache gives
    the implicit one's videos."""
    jm, params, jw, tm, tp, tw = engines('dummy')
    x, mask, imu = workload(5)
    mask_c = np.zeros((1, IMU_TOK), bool)
    implicit = tfc.predict_videos_conjoined_prefix(
        tw, tp, t(x), t(mask), t(imu), t(mask_c), N0 + 4, True)
    lru = tfc.ConjoinedPrefixLru(tw, tp, True, size=2)
    cache, hit = lru.get(t(x[0:1]), t(imu))
    assert not hit and lru.misses == 1
    injected = tfc.predict_videos_conjoined_prefix(
        tw, tp, t(x), t(mask), t(imu), t(mask_c), N0 + 4, True,
        cache=cache)
    assert_close(injected.numpy(), implicit.numpy(), 1e-6)
    other1 = x[0:1].copy()
    other1[:, 1] += 1.0
    _, hit = lru.get(t(other1), t(imu))
    assert hit and lru.hits == 1
    _, hit = lru.get(t(x[0:1]), t(imu + 1.0))
    assert not hit and lru.misses == 2


def test_guards_and_zero_suffix():
    """The eager guards raise as JAX's; frame 1 fully masked (n_vis == n0)
    runs and passes frame 0 through."""
    jm, params, jw, tm, tp, tw = engines('padded')
    x, mask, imu = workload(6, s=2, counts=(2, 2))
    mc = t(np.zeros((1, IMU_TOK), bool))
    bad = mask.copy()
    bad[0, 3] = True
    with pytest.raises(ValueError, match='frame 0'):
        tfc.predict_videos_conjoined_prefix(tw, tp, t(x), t(bad), t(imu), mc,
                                            N0 + 2, True)
    with pytest.raises(ValueError, match='mask_context'):
        tfc.predict_videos_conjoined_prefix(
            tw, tp, t(x), t(mask), t(imu), ~mc, N0 + 2, True)
    with pytest.raises(ValueError, match='n_vis'):
        tfc.predict_videos_conjoined_prefix(tw, tp, t(x), t(mask), t(imu), mc,
                                            N0 - 1, True)
    full = np.ones((2, N), bool)
    full[:, :N0] = False
    ty = tfc.predict_videos_conjoined_prefix(tw, tp, t(x), t(full), t(imu),
                                             mc, N0, True)
    jy = jfc.predict_videos_conjoined_prefix(
        jw, params, jnp.asarray(x), jnp.asarray(full), jnp.asarray(imu),
        jnp.asarray(mc.numpy()), N0, True, False)
    assert torch.isfinite(ty).all()
    assert_close(ty.numpy(), jy, 1e-4)
    np.testing.assert_array_equal(ty[:, 0].numpy(), x[:, 0])
