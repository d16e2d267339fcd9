"""Port parity: the IMU-conditioned pipeline (pipelines/imu.py) and the IMU
movability predictor against the JAX package on the CPU.

The IMU-conditioned predictor is the tiny padded conjoined model of
tests/test_fast_conjoined.py; flow2imu is the same size with a 7-channel,
one-frame main stream (forward + backward flow + RGB through
``FramePairFlow``) and a non-padded IMU context with a dummy token; RAFT
runs 2 iterations at 64 px. JAX-initialised weights are bridged by
utils/weights.py. The JAX generator draws from its key; the port's draw
methods (shifts, rectangularizer noise, the sampler's categorical indices
and the stream mask generators' masks) replay that key schedule
(``ImuDraws``). Masks and patches bitwise; IMU tokens and videos within
1e-4 (f32); flows and movability maps within 1e-3 px.
"""
import ast
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.masking import generators as jgen
from counterfactualworldmodels_tpu.models import conjoined as jconj
from counterfactualworldmodels_tpu.models import fast_conjoined as jfc
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import imu as jimu
from counterfactualworldmodels_tpu.pipelines import movability as jmov
from counterfactualworldmodels_tpu_torch.masking import generators as tgen
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import fast_conjoined as tfc
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.pipelines import imu as timu
from counterfactualworldmodels_tpu_torch.pipelines import movability as tmov
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (IMG, IMU_LEN, IMU_TOK, N, N0, JaxDraws,
                               assert_close, conj_pair, conj_specs,
                               jax_uniform_noise, t)

GRID = 8
_init_conj = jax.jit(jconj.init_conjoined_params, static_argnums=0)
_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _flow2imu(mod):
    main = mod.StreamSpec(img_size=(IMG, IMG), patch_size=(8, 8), in_chans=7,
                          num_frames=1, encoder_embed_dim=48, encoder_depth=2,
                          encoder_num_heads=4, decoder_embed_dim=32,
                          decoder_depth=2, decoder_num_heads=4, mlp_ratio=2.0,
                          decoder_num_classes=448)
    _, ctx, pairs = conj_specs(mod, 'dummy')
    kw = {} if mod is jconj else {'device': 'cpu'}
    return mod.ConjoinedVMAE(main=main, context=ctx, **pairs, **kw)


@pytest.fixture(scope='module')
def nets():
    jm, params, tm, sd = conj_pair('padded')
    jf = _flow2imu(jconj)
    fparams = _init_conj(jf, jax.random.PRNGKey(2))
    tf = _flow2imu(tconj)
    fsd = weights.conjoined_state_dict_from_jax(tf, _np_tree(fparams))
    tf.load_state_dict(fsd, strict=True)
    jr = jraft.RAFT(iters=2)
    rp = _init_raft(jr, jax.random.PRNGKey(1), IMG)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(_np_tree(rp)),
                       strict=True)
    f2i_kw = dict(main_input='flowback_rgb01', context_input='imu')
    jw = jconj.ConjoinedPredictorWrapper(jm, params=params,
                                         main_input='rgb01',
                                         context_input='imu')
    jfw = jconj.ConjoinedPredictorWrapper(
        jf, params=fparams, main_input_kwargs={
            'unnormalize': True, 'iters': 2, 'flow_model': jr,
            'flow_params': rp}, **f2i_kw)
    tw = tconj.ConjoinedPredictorWrapper(tm, params=sd, main_input='rgb01',
                                         context_input='imu')
    tfw = tconj.ConjoinedPredictorWrapper(
        tf, params=fsd, main_input_kwargs={
            'unnormalize': True, 'iters': 2, 'flow_model': tr}, **f2i_kw)
    return (dict(predictor=jw, head_motion_predictor=jfw, flow_model=jr,
                 flow_params=rp),
            dict(predictor=tw, head_motion_predictor=tfw, flow_model=tr))


def _jax_stream_generator(g):
    """The JAX generator of a port stream mask generator's config."""
    if isinstance(g, tgen.MissingDataImuMaskGenerator):
        return jgen.MissingDataImuMaskGenerator(
            input_size=g.width, mask_ratio=g.mask_ratio,
            full_mask_prob=g.full_mask_prob, full_vis_prob=g.full_vis_prob,
            truncation_mode=g.mode)
    return jgen.MaskingGenerator(input_size=g.input_size,
                                 mask_ratio=g.mask_ratio,
                                 visible_frames=g.visible_frames,
                                 clumping_factor=g.clumping_factor)


class ImuDraws(JaxDraws):
    """JaxDraws plus the stream mask generators' masks, each from the next
    key of the generator's chain, as the JAX generators draw them."""

    def __init__(self, gen, seed=0):
        super().__init__(gen, seed)
        gen._draw_stream_mask = self.stream_mask

    def stream_mask(self, mask_generator, x):
        ref = _jax_stream_generator(mask_generator)(
            jnp.asarray(np.asarray(x)), key=self.next_key())
        return t(ref)


def make_pair(nets, engine='fast', seed=0, cls=None, **kw):
    """(JAX generator, the port's with the JAX draws)."""
    jkw, tkw = nets
    kw = dict(dict(raft_iters=2, imagenet_normalize_inputs=True, seed=seed,
                   engine=engine), **kw)
    jcls = cls[0] if cls else jimu.ImuConditionedFlowGenerator
    tcls = cls[1] if cls else timu.ImuConditionedFlowGenerator
    jg = jcls(**jkw, **kw)
    tg = tcls(**tkw, device='cpu', **kw)
    ImuDraws(tg, seed)
    return jg, tg


def scene(seed, b=1):
    """A smooth image and its 3-pixel shift: [B, 2, 3, H, W] in [0, 1]."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(b, 3, 8, 8).astype(np.float32)
    img = np.asarray(jax.image.resize(jnp.asarray(coarse), (b, 3, IMG, IMG),
                                      'bilinear'))
    return np.stack([img, np.roll(img, 3, axis=-1)], axis=1)


def prompts(rng, s, n_active=1, n_passive=0):
    active = np.ones((1, N, s), bool)
    passive = np.ones((1, N, s), bool)
    active[:, :N0] = False
    passive[:, :N0] = False
    for i in range(s):
        active[0, N0 + rng.choice(N0, n_active, replace=False), i] = False
        if n_passive:
            passive[0, N0 + rng.choice(N0, n_passive, replace=False),
                    i] = False
    return active, passive


def test_static_imu_and_imu_from_video_match_jax(nets):
    """flow2imu's forward through FramePairFlow (RAFT forward and backward,
    flows normalised, RGB appended): the static scene's IMU and a moving
    video's, and the token <-> stream layouts."""
    jg, tg = make_pair(nets)
    x = scene(1)
    jg.set_input(jnp.asarray(x))
    tg.set_input(x)
    js, ts = jg.get_static_imu(), tg.get_static_imu()
    assert tuple(ts.shape) == js.shape == (1, IMU_TOK, 48)
    assert_close(ts.numpy(), js, 1e-4)
    jv = jg.predict_imu_from_video(jnp.asarray(x))
    tv = tg.predict_imu_from_video(x)
    assert_close(tv.numpy(), jv, 1e-4)
    assert float(np.abs(np.asarray(jv) - np.asarray(js)).max()) > 1e-4
    np.testing.assert_array_equal(tg.reshape_output(t(jv)).numpy(),
                                  np.asarray(jg.reshape_output(jv)))
    np.testing.assert_array_equal(tg.get_zeros_imu().numpy(),
                                  np.asarray(jg.get_zeros_imu()))
    stream = tg.reshape_output(tv)
    hm = tg.head_motion_generator
    np.testing.assert_array_equal(hm.reshape_input(stream).numpy(),
                                  tv.numpy())


@pytest.mark.parametrize('engine', ['fast', 'exact'])
@pytest.mark.parametrize('head', ['static', 'given', 'masked'])
def test_counterfactuals_match_jax(nets, engine, head):
    """predict_counterfactual_videos_and_flows with drawn shifts, two
    chunks of two prompts (active and passive patches): the head motion
    predicted from the static scene, given, or given and fully masked
    (which takes the exact path on either engine)."""
    jg, tg = make_pair(nets, engine)
    rng = np.random.RandomState(3)
    x = scene(2)[:, 0]
    active, passive = prompts(rng, 4, n_active=1, n_passive=2)
    kw = dict(num_samples=4, sample_batch_size=2)
    if head != 'static':
        h = (rng.randn(1, IMU_TOK, 48) * 0.1).astype(np.float32)
        kw['head_motion'] = h
        kw['mask_head_motion'] = head == 'masked'
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jy, jf = jg.predict_counterfactual_videos_and_flows(
        jnp.asarray(x), jnp.asarray(active), jnp.asarray(passive), **jkw)
    ty, tf = tg.predict_counterfactual_videos_and_flows(x, active, passive,
                                                        **kw)
    assert tuple(ty.shape) == jy.shape == (4, 2, 3, IMG, IMG)
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)
    np.testing.assert_array_equal(np.stack(tg.shifts), np.stack(jg.shifts))
    assert_close(tg._x_context.numpy(), jg._x_context, 1e-4)
    if engine == 'fast' and head != 'masked':
        assert tg._conj_prefix_lru.misses == 1
        assert tg._conj_prefix_lru.hits == 1
    else:
        assert tg._conj_prefix_lru is None


def test_frame0_visible_prompt_through_the_wrapper(nets):
    """Prompts with frame 0 visible (n_vis > n0) through the fast step: the
    suffix width is the bucket of the frame-1 count (_imu_sfx_pad), not
    the raw n_vis, which would overflow pad_vis1_idx. The direct step and
    the per-click predict match JAX's and stay close to the exact path."""
    jkw, tkw = nets
    jw, tw = jkw['predictor'], tkw['predictor']
    rng = np.random.RandomState(4)
    x = scene(3)
    active, passive = prompts(rng, 3, n_active=2)
    n_vis = N0 + 2
    assert timu._imu_sfx_pad(tw, n_vis) == 4 < n_vis
    shifts = np.array([[[1, 0], [0, 1], [-1, 1]]], np.int64)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)[None]
    noise = jax_uniform_noise(keys[0], N - N0)[None]
    imu = (rng.randn(1, 6, IMU_LEN) * 0.1).astype(np.float32)
    mc = np.zeros((1, IMU_TOK), bool)
    tp = tfc.cast_params(tw.model, tw.params, torch.float32, 'cpu')
    ty, tf, tmask = timu._imu_counterfactual_step_fast(
        tw, tp, tkw['flow_model'], t(x), t(passive), t(active), t(shifts),
        t(noise), t(imu), t(mc), n_vis, True, 2)
    jy, jf, jmask = jimu._imu_counterfactual_step_fast(
        jw, jw.params, jkw['flow_model'], jkw['flow_params'],
        jnp.asarray(x), jnp.asarray(passive), jnp.asarray(active),
        jnp.asarray(shifts.astype(np.int32)), keys, jnp.asarray(imu),
        jnp.asarray(mc), n_vis, True, 2, False, False)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert ((~tmask).sum(-1) == n_vis).all()
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)
    # the per-click predict on the same prompt: fast == JAX, close to exact
    jg, tg = make_pair(nets, 'fast')
    _, te = make_pair(nets, 'exact')
    mask = tmask[0:1].numpy()
    h = tg.reshape_output(t((rng.randn(1, IMU_TOK, 48) * 0.1).astype(
        np.float32)))
    jp = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=None,
                    x_context=jnp.asarray(h.numpy()))
    tp_ = tg.predict(x, mask, frame=None, x_context=h)
    assert tg._conj_prefix_lru.misses == 1
    assert_close(tp_.numpy(), jp, 1e-4)
    tex = te.predict(x, mask, frame=None, x_context=h)
    assert te._conj_prefix_lru is None
    corr = np.corrcoef(tp_[:, 1].numpy().ravel(), tex[:, 1].numpy().ravel())
    assert corr[0, 1] > 0.99


def test_multi_scene_step_matches_jax(nets):
    """_imu_counterfactual_multi_step_fast over 3 (scene, IMU) pairs'
    stacked prefix caches == JAX's."""
    jkw, tkw = nets
    jw, tw = jkw['predictor'], tkw['predictor']
    rng = np.random.RandomState(6)
    xs = np.concatenate([scene(10 + i) for i in range(3)])
    imus = (rng.randn(3, 6, IMU_LEN) * 0.1).astype(np.float32)
    active, passive = prompts(rng, 3)
    active, passive = active[0].T.copy(), passive[0].T.copy()
    shifts = np.array([[1, 0], [0, 1], [1, 1]], np.int64)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    noise = jax_uniform_noise(keys, N - N0)
    mc = np.zeros((3, IMU_TOK), bool)
    tp = tfc.cast_params(tw.model, tw.params, torch.float32, 'cpu')
    tcache = tfc.stack_conjoined_prefix_caches([
        tfc.make_conjoined_prefix_cache(tw, tp, t(xs[i:i + 1]),
                                        t(imus[i:i + 1]), True)
        for i in range(3)])
    jcache = jfc.stack_conjoined_prefix_caches([
        jfc.make_conjoined_prefix_cache(jw, jw.params,
                                        jnp.asarray(xs[i:i + 1]),
                                        jnp.asarray(imus[i:i + 1]), True,
                                        False) for i in range(3)])
    ty, tf, tm = timu._imu_counterfactual_multi_step_fast(
        tw, tp, tkw['flow_model'], t(xs), t(passive), t(active), t(shifts),
        t(noise), t(imus), t(mc), N0 + 1, True, 2, tcache)
    jy, jf, jm = jimu._imu_counterfactual_multi_step_fast(
        jw, jw.params, jkw['flow_model'], jkw['flow_params'],
        jnp.asarray(xs), jnp.asarray(passive), jnp.asarray(active),
        jnp.asarray(shifts.astype(np.int32)), keys, jnp.asarray(imus),
        jnp.asarray(mc), N0 + 1, True, 2, False, False, jcache)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)
    with pytest.raises(ValueError, match='stacked'):
        timu._imu_counterfactual_multi_step_fast(
            tw, tp, tkw['flow_model'], t(xs), t(passive), t(active),
            t(shifts), t(noise), t(imus), t(mc), N0 + 1, True, 2, None)


def test_frame0_masked_prompt_takes_the_exact_path(nets):
    """Passive patches masking frame 0 break the prefix factorization: the
    call runs the exact path (bitwise the exact engine's), the LRU is never
    built, and a supported prompt then runs on the engine."""
    jg, tg = make_pair(nets, 'fast', seed=4)
    _, te = make_pair(nets, 'exact', seed=4)
    rng = np.random.RandomState(8)
    x = scene(4)[:, 0]
    active, passive = prompts(rng, 1)
    passive[0, rng.choice(N0, 2, replace=False)] = True
    active[0, :N0] = passive[0, :N0]
    kw = dict(shifts=[(0, 1)], num_samples=1, sample_batch_size=1)
    jy, jf = jg.predict_counterfactual_videos_and_flows(
        jnp.asarray(x), jnp.asarray(active), jnp.asarray(passive), **kw)
    ty, tf = tg.predict_counterfactual_videos_and_flows(x, active, passive,
                                                        **kw)
    ey, ef = te.predict_counterfactual_videos_and_flows(x, active, passive,
                                                        **kw)
    assert tg._conj_prefix_lru is None
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)
    np.testing.assert_array_equal(ty.numpy(), ey.numpy())
    active, passive = prompts(rng, 1)
    for _ in range(2):
        tg.predict_counterfactual_videos_and_flows(x, active, passive, **kw)
    assert tg._conj_prefix_lru.misses == 1 and tg._conj_prefix_lru.hits == 1


@pytest.mark.parametrize('exc', [RuntimeError, ValueError])
def test_engine_failures_reach_the_caller(nets, monkeypatch, exc):
    """No fallback: an exception inside the conjoined engine propagates,
    whatever its class, and the next supported call runs on the engine."""
    _, tg = make_pair(nets, 'fast', seed=5)
    x = scene(5)[:, 0]
    active, _ = prompts(np.random.RandomState(9), 1)
    kw = dict(shifts=[(0, 1)], num_samples=1, sample_batch_size=1)
    real = timu._imu_counterfactual_step_fast
    calls = []

    def broken(*a, **k):
        calls.append('broken')
        raise exc('kernel launch failed')

    def counted(*a, **k):
        calls.append('fast')
        return real(*a, **k)

    monkeypatch.setattr(timu, '_imu_counterfactual_step_fast', broken)
    with pytest.raises(exc, match='kernel launch failed'):
        tg.predict_counterfactual_videos_and_flows(x, active, **kw)
    monkeypatch.setattr(timu, '_imu_counterfactual_step_fast', counted)
    y, f = tg.predict_counterfactual_videos_and_flows(x, active, **kw)
    assert calls == ['broken', 'fast']
    assert tg._conj_prefix_lru.hits == 1 and torch.isfinite(f).all()
    assert not hasattr(tg, '_fast_disabled')
    # and inside the engine itself, under the per-click predict
    monkeypatch.setattr(tfc, 'predict_videos_conjoined_prefix', broken)
    mask = np.ones((1, N), bool)
    mask[0, :N0 + 3] = False
    with pytest.raises(exc, match='kernel launch failed'):
        tg.predict(scene(5), mask, x_context=tg._x_context)


def test_imu_has_no_blanket_exception_handler():
    for mod in (timu, tfc):
        tree = ast.parse(inspect.getsource(mod))
        handlers = [h for h in ast.walk(tree)
                    if isinstance(h, ast.ExceptHandler)]
        assert not handlers


def test_imu_generator_matches_jax(nets):
    """The flow2imu ImuGenerator: predict_imu (labels at visible tokens,
    predictions at masked ones), __call__ with missing data, get_imu_input;
    and on the IMU-conditioned predictor the factual predict (ragged rows
    rectangularized from the JAX key)."""
    jkw, tkw = nets
    kw = dict(raft_iters=2, imagenet_normalize_inputs=True, seed=0,
              flow_model=jkw['flow_model'], flow_params=jkw['flow_params'])
    jh = jimu.ImuGenerator(predictor=jkw['head_motion_predictor'],
                           head_mask_ratio=1, **kw)
    th = timu.ImuGenerator(predictor=tkw['head_motion_predictor'],
                           head_mask_ratio=1, raft_iters=2,
                           imagenet_normalize_inputs=True, seed=0,
                           flow_model=tkw['flow_model'], device='cpu')
    ImuDraws(th, 0)
    rng = np.random.RandomState(11)
    video = scene(6).swapaxes(1, 2)                     # [B, C, T, H, W]
    imu = (rng.randn(1, 6, IMU_LEN) * 0.1).astype(np.float32)
    missing = np.zeros((1, 6, IMU_LEN), bool)
    missing[..., :8] = True
    inp = {'video': video, 'imu': imu, 'imu_missing_data': missing}
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    for ratio in (1, 0.5):
        jp, jl = jh.predict_imu(jinp, imu_mask_ratio=ratio)
        tp, tl = th.predict_imu(inp, imu_mask_ratio=ratio)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert_close(tp.numpy(), jp, 1e-4)
    jo, jm = jh(jinp)
    to, tm = th(inp)
    assert_close(to.numpy(), jo, 1e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(th.any_imu.numpy(), np.asarray(jh.any_imu))
    np.testing.assert_array_equal(th.full_imu.numpy(),
                                  np.asarray(jh.full_imu))
    ex = {'video': scene(7)[0], 'imu': imu[0].T,
          'imu_missing_data': missing[0].T}
    jr = jh.get_imu_input({k: jnp.asarray(v) for k, v in ex.items()})
    tr = th.get_imu_input(ex)
    for a, b in zip(tr[:4], jr[:4]):
        assert_close(a.float().numpy(), np.asarray(b, np.float32), 1e-6)
    with pytest.raises(TypeError, match='in_chans'):
        th.predict(scene(6), np.zeros((1, N), bool))
    with pytest.raises(TypeError, match='ImuConditionedFlowGenerator'):
        th._counterfactual_chunk()
    with pytest.raises(ValueError, match='not a known mode'):
        th.set_mode('sideways')
    # the IMU-conditioned predictor through ImuGenerator.predict
    jg = jimu.ImuGenerator(predictor=jkw['predictor'], **kw)
    tg = timu.ImuGenerator(predictor=tkw['predictor'], raft_iters=2,
                           imagenet_normalize_inputs=True, seed=0,
                           flow_model=tkw['flow_model'], device='cpu')
    ImuDraws(tg, 0)
    x = scene(8, b=2)
    mask = np.ones((2, N), bool)
    mask[:, :N0] = False
    mask[0, N0 + rng.choice(N0, 2, replace=False)] = False
    mask[1, N0 + rng.choice(N0, 5, replace=False)] = False
    jy = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=None)
    ty = tg.predict(x, mask, frame=None)
    assert_close(ty.numpy(), jy, 1e-4)


def test_imu_movability_matches_jax(nets):
    """ImuConditionedMovabilityPredictor(...)(x) at num_iters=1, S = 2 per
    iteration, with the static-scene IMU predicted each motion map:
    every iteration's active and passive patches bitwise, flows and maps
    within 1e-3."""
    cls = (jmov.make_imu_conditioned_movability_predictor(),
           tmov.make_imu_conditioned_movability_predictor())
    kw = dict(initialize_from_keypoints=False, num_initial_samples=2,
              num_samples_per_iteration=2, sample_batch_size=2, num_iters=1)
    jg, tg = make_pair(nets, 'fast', seed=3, cls=cls, **kw)
    assert isinstance(tg, timu.ImuConditionedFlowGenerator)
    assert isinstance(tmov.ImuConditionedMovabilityPredictor(
        **nets[1], raft_iters=2, device='cpu', **kw),
        tmov.MovabilityPredictor)
    x = scene(9)
    jout = jg(jnp.asarray(x), do_filter=False)
    tout = tg(x, do_filter=False)
    assert tuple(tout.shape) == jout.shape == (1, 1, IMG, IMG)
    for it in range(2):
        np.testing.assert_array_equal(
            tg.active_patches_per_iter[it].numpy(),
            np.asarray(jg.active_patches_per_iter[it]))
        np.testing.assert_array_equal(
            tg.passive_patches_per_iter[it].numpy(),
            np.asarray(jg.passive_patches_per_iter[it]))
        assert_close(tg.flow_samples_per_iter[it].numpy(),
                     jg.flow_samples_per_iter[it], 1e-3)
        assert_close(tg.movability_maps[it].numpy(), jg.movability_maps[it],
                     1e-3)
    assert_close(tout.numpy(), jout, 1e-3)
    assert float(tg.movability_maps[0].max()) > 0.5
    assert tg._conj_prefix_lru.misses == 1 and tg._conj_prefix_lru.hits == 1


@pytest.mark.parametrize('engine', ['fast', 'exact'])
def test_predict_imu_video_and_flow_matches_jax(nets, engine):
    """predict_imu_video_and_flow: the head motion predicted from the
    moving video (static_head_motion=False, its default) or returned
    alone, then the IMU-conditioned factual video and its flow."""
    jg, tg = make_pair(nets, engine, seed=2)
    x = scene(12)
    mask = np.ones((1, N), bool)
    mask[0, :N0 + 4] = False
    jh = jg.predict_imu_video_and_flow(jnp.asarray(x), jnp.asarray(mask),
                                       return_head_motion=True)
    th = tg.predict_imu_video_and_flow(x, mask, return_head_motion=True)
    assert_close(th.numpy(), jh, 1e-4)
    jy, jf = jg.predict_imu_video_and_flow(jnp.asarray(x), jnp.asarray(mask))
    ty, tf = tg.predict_imu_video_and_flow(x, mask)
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)
    assert (tg._conj_prefix_lru is not None) == (engine == 'fast')
