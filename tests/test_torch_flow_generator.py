"""Port parity: FlowGenerator against the JAX package's, on the CPU.

The tiny configuration of tests/test_segmentation.py (32 px, 4x4 patches,
encoder depth 2, decoder depth 1) and RAFT with 2 iterations, with JAX
weights bridged by utils/weights.py. The JAX generator draws from its key;
the port's draw methods (shifts, rectangularizer noise, the patch
sampler's categorical indices) are replaced by ``JaxDraws``, which replays
the JAX key schedule, so both sides build the same prompts. Masks match
bitwise; videos within 1e-4 and flows within 1e-3 px (f32 sums in another
order, fed back through RAFT's lookup coordinates); compute_flow_corrs
within 1e-5.
"""
import ast
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import fast_vmae as jfv
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import segmentation as jseg
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.pipelines import segmentation as tseg
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (TINY, JaxDraws, assert_close,
                               jax_uniform_noise, t)

N, N0 = 128, 64


@pytest.fixture(scope='module')
def nets():
    jm = jvmae.PretrainVisionTransformer(**TINY)
    params = jvmae.init_params(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**TINY)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    jr = jraft.RAFT(iters=2)
    rparams = jraft.init_raft_params(jr, jax.random.PRNGKey(1), hw=32)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rparams)), strict=True)
    return (jm, params, jr, rparams), (tm, sd, tr)


def make_pair(nets, engine='fast', seed=0):
    """(JAX FlowGenerator, port FlowGenerator with the JAX draws)."""
    (jm, params, jr, rparams), (tm, sd, tr) = nets
    kw = dict(raft_iters=2, imagenet_normalize_inputs=True, seed=seed,
              engine=engine)
    jg = jseg.FlowGenerator(predictor=jm, params=params, flow_model=jr,
                            flow_params=rparams, **kw)
    tg = tseg.FlowGenerator(predictor=tm, params=sd, flow_model=tr,
                            device='cpu', **kw)
    JaxDraws(tg, seed)
    return jg, tg


def prompt_masks(rng, s=1, n_active=1, n_passive=0):
    """[1, N, s] active / passive masks: frame 0 visible in both, and
    n_active / n_passive visible frame-1 patches per sample."""
    active = np.ones((1, N, s), dtype=bool)
    passive = np.ones((1, N, s), dtype=bool)
    active[:, :N0] = False
    passive[:, :N0] = False
    for i in range(s):
        active[0, N0 + rng.choice(N0, n_active, replace=False), i] = False
        if n_passive:
            passive[0, N0 + rng.choice(N0, n_passive, replace=False),
                    i] = False
    return active, passive


def assert_videos_flows(ty, tf, jy, jf):
    assert tuple(ty.shape) == jy.shape and tuple(tf.shape) == jf.shape
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)


@pytest.mark.parametrize('engine', ['fast', 'exact'])
@pytest.mark.parametrize('backward', [False, True], ids=['fwd', 'backward'])
def test_predict_counterfactual_videos_and_flows_matches_jax(nets, engine,
                                                             backward):
    """Drawn shifts, two chunks of two prompts, active and passive
    patches."""
    jg, tg = make_pair(nets, engine)
    rng = np.random.RandomState(3)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    active, passive = prompt_masks(rng, s=4, n_active=1, n_passive=3)
    kw = dict(num_samples=4, sample_batch_size=2, backward=backward)
    jy, jf = jg.predict_counterfactual_videos_and_flows(
        jnp.asarray(x), jnp.asarray(active), jnp.asarray(passive), **kw)
    ty, tf = tg.predict_counterfactual_videos_and_flows(
        x, active, passive, **kw)
    assert_videos_flows(ty, tf, jy, jf)
    np.testing.assert_array_equal(np.stack([np.asarray(s) for s in tg.shifts]),
                                  np.stack([np.asarray(s) for s in jg.shifts]))
    if engine == 'fast':
        assert tg._prefix_lru.misses == 1 and tg._prefix_lru.hits == 1
    else:
        assert tg._prefix_lru is None


def test_sample_counterfactual_motion_map_matches_jax(nets):
    """Energy-sampled active patches (the sampler's categorical draws from
    the JAX keys), zero passive patches, the flow-sample filter."""
    jg, tg = make_pair(nets, 'fast', seed=1)
    rng = np.random.RandomState(4)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    energy = rng.rand(1, 1, 32, 32).astype(np.float32)
    kw = dict(num_active_patches=2, num_samples=3, sample_batch_size=3)
    jfl, ja, jp = jg.sample_counterfactual_motion_map(
        jnp.asarray(x), active_sampling_distribution=jnp.asarray(energy), **kw)
    tfl, ta, tp = tg.sample_counterfactual_motion_map(
        x, active_sampling_distribution=energy, **kw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tuple(tfl.shape) == jfl.shape == (1, 2, 32, 32, 3)
    assert_close(tfl.numpy(), jfl, 1e-3)
    # the unfiltered samples too (the filter zeroes rejected ones)
    jfl, _, _ = jg.sample_counterfactual_motion_map(
        jnp.asarray(x), do_filter=False, **kw)
    tfl, _, _ = tg.sample_counterfactual_motion_map(x, do_filter=False, **kw)
    assert_close(tfl.numpy(), jfl, 1e-3)
    assert float(np.abs(np.asarray(jfl)).max()) > 0
    assert tg._prefix_lru.misses == 1 and tg._prefix_lru.hits == 1


def test_per_click_predict_matches_jax_and_reuses_the_prefix(nets):
    jg, tg = make_pair(nets, 'fast')
    rng = np.random.RandomState(7)
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    mask = np.ones((1, N), dtype=bool)
    mask[0, :N0] = False
    mask[0, N0 + rng.choice(N0, 5, replace=False)] = False
    jy = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=None)
    ty = tg.predict(x, mask, frame=None)
    assert tg._prefix_lru.misses == 1
    assert_close(ty.numpy(), jy, 1e-4)
    jy1 = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=1)
    ty1 = tg.predict(x, mask, frame=1)
    assert tg._prefix_lru.hits == 1 and ty1.shape[1] == 1
    assert_close(ty1.numpy(), jy1, 1e-4)


def test_frame1_fully_masked_prompt_stays_on_the_fast_engine(nets):
    """A factual predict with frame 1 fully masked (zero suffix tokens)
    runs on the engine and matches JAX; the next counterfactual reuses its
    prefix."""
    jg, tg = make_pair(nets, 'fast', seed=2)
    rng = np.random.RandomState(8)
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    mask = np.ones((1, N), dtype=bool)
    mask[0, :N0] = False
    jy = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=None)
    ty = tg.predict(x, mask, frame=None)
    assert tg._prefix_lru.misses == 1
    assert_close(ty.numpy(), jy, 1e-4)
    active = np.ones((1, N), dtype=bool)
    active[0, N0 + rng.randint(N0)] = False
    kw = dict(shifts=[(0, 1)], num_samples=1, sample_batch_size=1)
    jy, jf = jg.predict_counterfactual_videos_and_flows(
        jnp.asarray(x[:, 0]), jnp.asarray(active), **kw)
    ty, tf = tg.predict_counterfactual_videos_and_flows(x[:, 0], active, **kw)
    assert tg._prefix_lru.hits == 1
    assert_videos_flows(ty, tf, jy, jf)


def test_unequal_visible_counts_are_rectangularized_like_jax(nets):
    """predict on two rows with different visible counts: the exact path,
    with the rectangularizer's draws from the JAX key."""
    jg, tg = make_pair(nets, 'fast', seed=3)
    rng = np.random.RandomState(9)
    x = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    mask = np.ones((2, N), dtype=bool)
    mask[:, :N0] = False
    mask[0, N0 + rng.choice(N0, 3, replace=False)] = False
    mask[1, N0 + rng.choice(N0, 6, replace=False)] = False
    jy = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=None)
    ty = tg.predict(x, mask, frame=None)
    assert tg._prefix_lru is None          # B = 2: the exact path
    assert_close(ty.numpy(), jy, 2e-4, 1e-4)


def test_multi_scene_dispatch_matches_per_scene_dispatches_and_jax(nets):
    """counterfactual_videos_and_flows_fast_multi over stacked per-scene
    caches == the per-scene fast dispatches, and == the JAX multi-scene
    dispatch."""
    (jm, params, jr, rparams), (tm, sd, tr) = nets
    jfp = jfv.stack_vmae_params(jm, params, dtype=jnp.float32)
    tfp = tfv.stack_vmae_params(tm, sd, dtype=torch.float32, device='cpu')
    rng = np.random.RandomState(7)
    n_vis = N0 + 1
    pad = tfv.sfx_bucket(n_vis - N0, N - N0)
    scenes, serial = [], []
    for i in range(3):
        x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
        active, passive = prompt_masks(rng)
        shifts = np.asarray([[[1, i - 1]]], np.int64)
        key = jax.random.PRNGKey(10 + i)
        noise = t(jax_uniform_noise(key[None], N - N0))
        cache = tfv.make_prefix_cache(tm, tfp, False, True, t(x[:, 0]))
        serial.append(tseg.counterfactual_videos_and_flows_fast(
            tm, tfp, tr, t(x), t(passive), t(active), t(shifts), noise, pad,
            True, 2, True, False, False, prefix_cache=cache, n_vis=n_vis))
        scenes.append((x, passive[..., 0], active[..., 0], shifts[0], key,
                       noise, cache))
    stacked = tfv.stack_prefix_caches([s[-1] for s in scenes])
    assert stacked.dec_kvs[0].shape[1] == 3
    cat = lambda i: np.concatenate([s[i] for s in scenes])  # noqa: E731
    ty, tf, tmask = tseg.counterfactual_videos_and_flows_fast_multi(
        tm, tfp, tr, cat(0), cat(1), cat(2), cat(3), pad, True, 2, True,
        False, False, torch.cat([s[5] for s in scenes]), stacked,
        n_vis=n_vis, device='cpu')
    np.testing.assert_array_equal(tmask.numpy(),
                                  torch.cat([m for _, _, m in serial]).numpy())
    assert_close(ty.numpy(), torch.cat([y for y, _, _ in serial]).numpy(),
                 1e-5)
    assert_close(tf.numpy(), torch.cat([f for _, f, _ in serial]).numpy(),
                 1e-3)

    jstacked = jfv.stack_prefix_caches([
        jfv.make_prefix_cache(jm, jfp, False, True, jnp.asarray(s[0][:, 0]))
        for s in scenes])
    jy, jf, jmask = jseg.counterfactual_videos_and_flows_fast_multi(
        jm, jfp, jr, rparams, jnp.asarray(cat(0)), jnp.asarray(cat(1)),
        jnp.asarray(cat(2)), jnp.asarray(cat(3)).astype(np.int32), pad, True,
        2, True, False, False, jnp.stack([s[4] for s in scenes]), jstacked,
        n_vis=n_vis)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert_videos_flows(ty, tf, jy, jf)
    with pytest.raises(ValueError, match='stacked'):
        tseg.counterfactual_videos_and_flows_fast_multi(
            tm, tfp, tr, cat(0), cat(1), cat(2), cat(3), pad, True, 2, True,
            False, False, torch.cat([s[5] for s in scenes]), None,
            n_vis=n_vis, device='cpu')


def test_frame0_masked_prompt_takes_the_exact_path(nets):
    """A prompt with a frame-0 token masked in both prompt sets breaks the
    prefix factorization: that call runs the exact path (as JAX's does),
    the LRU is never built, and the engine stays on."""
    jg, tg = make_pair(nets, 'fast', seed=4)
    _, exact = make_pair(nets, 'exact', seed=4)
    rng = np.random.RandomState(6)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    active, passive = prompt_masks(rng)
    passive[0, rng.choice(N0, 2, replace=False)] = True
    active[0, :N0] = passive[0, :N0]
    kw = dict(shifts=[(0, 1)], num_samples=1, sample_batch_size=1)
    jy, jf = jg.predict_counterfactual_videos_and_flows(
        jnp.asarray(x), jnp.asarray(active), jnp.asarray(passive), **kw)
    ty, tf = tg.predict_counterfactual_videos_and_flows(x, active, passive,
                                                        **kw)
    ey, ef = exact.predict_counterfactual_videos_and_flows(x, active, passive,
                                                           **kw)
    assert tg._prefix_lru is None
    assert_videos_flows(ty, tf, jy, jf)
    np.testing.assert_array_equal(ty.numpy(), ey.numpy())
    np.testing.assert_array_equal(tf.numpy(), ef.numpy())
    # predict with frame 0 masked: the exact path too
    mask = np.ones((1, N), dtype=bool)
    mask[0, :N0] = False
    mask[0, 5] = True
    mask[0, N0 + 3] = False
    y2 = np.concatenate([x[:, None]] * 2, 1)
    np.testing.assert_array_equal(tg.predict(y2, mask, frame=None).numpy(),
                                  exact.predict(y2, mask, frame=None).numpy())
    assert tg._prefix_lru is None
    # a supported prompt still runs on the engine, and a repeat hits the LRU
    active, passive = prompt_masks(rng)
    for _ in range(2):
        tg.predict_counterfactual_videos_and_flows(x, active, passive, **kw)
    assert tg._prefix_lru.misses == 1 and tg._prefix_lru.hits == 1


@pytest.mark.parametrize('exc', [RuntimeError, ValueError])
def test_engine_failures_reach_the_caller(nets, monkeypatch, exc):
    """No fallback: an exception inside the fast dispatch propagates,
    whatever its class, and the next supported call still runs on the
    engine."""
    _, tg = make_pair(nets, 'fast', seed=5)
    rng = np.random.RandomState(9)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    active, _ = prompt_masks(rng)
    kw = dict(shifts=[(0, 1)], num_samples=1, sample_batch_size=1)
    real = tseg.counterfactual_videos_and_flows_fast
    calls = []

    def broken(*a, **k):
        calls.append('broken')
        raise exc('kernel launch failed')

    def counted(*a, **k):
        calls.append('fast')
        return real(*a, **k)

    monkeypatch.setattr(tseg, 'counterfactual_videos_and_flows_fast', broken)
    with pytest.raises(exc, match='kernel launch failed'):
        tg.predict_counterfactual_videos_and_flows(x, active, **kw)
    monkeypatch.setattr(tseg, 'counterfactual_videos_and_flows_fast', counted)
    y, f = tg.predict_counterfactual_videos_and_flows(x, active, **kw)
    assert calls == ['broken', 'fast']
    assert tg._prefix_lru.hits == 1 and torch.isfinite(f).all()
    assert not hasattr(tg, '_fast_disabled')


def test_segmentation_has_no_blanket_exception_handler():
    tree = ast.parse(inspect.getsource(tseg))
    handlers = [h for h in ast.walk(tree) if isinstance(h, ast.ExceptHandler)]
    assert not any(h.type is None or (isinstance(h.type, ast.Name)
                                      and h.type.id in ('Exception',
                                                        'BaseException'))
                   for h in handlers)


def test_flow_methods_match_jax(nets):
    """predict_flow_per_sample, predict_video_and_flow_per_sample, the
    mean motion map and get_error_maps on the exact engine."""
    jg, tg = make_pair(nets, 'exact')
    rng = np.random.RandomState(21)
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    masks = np.ones((1, N, 2), dtype=bool)
    masks[:, :N0] = False
    for j in range(2):
        masks[0, N0 + rng.choice(N0, 4, replace=False), j] = False
    jfl = jg.predict_flow_per_sample(jnp.asarray(x), jnp.asarray(masks))
    tfl = tg.predict_flow_per_sample(x, t(masks))
    assert tuple(tfl.shape) == jfl.shape == (1, 1, 2, 32, 32, 2)
    assert_close(tfl.numpy(), jfl, 1e-3)
    jys, jfs = jg.predict_video_and_flow_per_sample(jnp.asarray(x),
                                                    jnp.asarray(masks))
    tys, tfs = tg.predict_video_and_flow_per_sample(x, t(masks))
    assert_videos_flows(tys, tfs, jys, jfs)
    jmm = jg.compute_mean_motion_map(jfl[:, 0])
    tmm = tg.compute_mean_motion_map(tfl[:, 0])
    assert_close(tmm.numpy(), jmm, 1e-4)
    jerr = jg.get_error_maps(jnp.asarray(x), jnp.asarray(masks[..., 0]))
    terr = tg.get_error_maps(x, masks[..., 0])
    for k in ('flow_true', 'flow_pred', 'flow_error'):
        assert_close(terr[k].numpy(), jerr[k], 1e-3)
    assert_close(terr['pred'].numpy(), jerr['pred'], 1e-4)


CORR_CASES = [dict(), dict(use_covariance=True), dict(do_spearman=True),
              dict(thresh=0.8), dict(thresh=0.8, binarize=True),
              dict(range_thresh=0.5), dict(normalize=True),
              dict(zscore=True, use_covariance=True), dict(take_top_k=3),
              dict(swap=True), dict(take_top_k=6, raises=True)]


@pytest.mark.parametrize('case', CORR_CASES,
                         ids=lambda c: '-'.join(c) or 'corr')
def test_compute_flow_corrs_matches_jax(case):
    """Every option against JAX. take_top_k above the S = 5 samples is an
    error on both sides: JAX's reshape to k samples raises (a TypeError or
    a ValueError, by JAX version), the port a ValueError."""
    rng = np.random.RandomState(1)
    flows = rng.randn(2, 2, 8, 8, 5).astype(np.float32)
    kw = dict(case)
    if kw.pop('raises', False):
        with pytest.raises((TypeError, ValueError), match='reshape'):
            jseg.compute_flow_corrs(jnp.asarray(flows), downsample=2, **kw)
        with pytest.raises(ValueError, match='take_top_k'):
            tseg.compute_flow_corrs(t(flows), downsample=2, **kw)
        return
    swap = None
    if kw.pop('swap', False):
        swap = rng.randn(2, 2, 8, 8, 5).astype(np.float32)
    jc = jseg.compute_flow_corrs(
        jnp.asarray(flows), None if swap is None else jnp.asarray(swap),
        downsample=2, **kw)
    tc = tseg.compute_flow_corrs(t(flows), None if swap is None else t(swap),
                                 downsample=2, **kw)
    assert tuple(tc.shape) == jc.shape == (2, 1, 4, 4, 4, 4)
    assert_close(tc.numpy(), jc, 1e-5)


def test_predictor_weights_load_from_a_reference_checkpoint(nets, tmp_path):
    """A reference .pth ({'model': ...} with DDP 'module.' prefixes) loads
    with strict=True and predicts as the in-memory weights do; a
    checkpoint with a missing key fails at once."""
    (_, _, _, _), (tm, sd, tr) = nets
    path = tmp_path / 'vmae.pth'
    torch.save({'model': {'module.' + k: v for k, v in sd.items()}}, path)
    kw = dict(flow_model=tr, raft_iters=2, device='cpu', engine='exact')
    g_path = tseg.FlowGenerator(predictor=tm, predictor_load_path=str(path),
                                **kw)
    g_mem = tseg.FlowGenerator(predictor=tm, params=sd, **kw)
    rng = np.random.RandomState(2)
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    mask = np.ones((1, N), dtype=bool)
    mask[0, :N0 + 4] = False
    np.testing.assert_array_equal(g_path.predict(x, mask).numpy(),
                                  g_mem.predict(x, mask).numpy())
    bad = dict(sd)
    bad.pop('mask_token')
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match='mask_token'):
        tseg.FlowGenerator(predictor=tm, predictor_load_path=str(path), **kw)
    # the flow model's checkpoint loads into a new RAFT the same way
    raft_path = tmp_path / 'raft.pth'
    torch.save({'model': {'module.' + k: v
                          for k, v in tr.state_dict().items()}}, raft_path)
    g_raft = tseg.FlowGenerator(predictor=tm, params=sd, raft_iters=2,
                                device='cpu', engine='exact',
                                flow_model_load_path=str(raft_path))
    assert g_raft.flow_model is not tr
    np.testing.assert_array_equal(g_raft.predict_flow(x).numpy(),
                                  g_mem.predict_flow(x).numpy())
