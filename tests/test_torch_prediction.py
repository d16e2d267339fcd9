"""Port parity: pipelines/prediction.py against the JAX package on the CPU.

SMALL_VMAE with JAX weights bridged by utils/weights.py. The scatter of
predictions into the video within 1e-6; the exact predictor's videos
(``predict_video``, ``PredictorBasedGenerator.predict`` and its per-sample
forms) within atol 2e-4 / rtol 1e-4, as tests/test_torch_vmae.py holds
``apply_vmae``; masks bitwise, with the rectangularizer's draws taken from
the JAX key."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.pipelines import prediction as jpred
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.pipelines import prediction as tpred
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (SMALL_VMAE, JaxDraws, assert_close,
                               jax_uniform_noise, t)

N, N0, PATCH = 128, 64, (1, 4, 4)


@pytest.fixture(scope='module')
def nets():
    jm = jvmae.PretrainVisionTransformer(**SMALL_VMAE)
    params = jvmae.init_params(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    return jm, params, tm, sd


def _masks(rng, b, counts):
    mask = np.ones((b, N), dtype=bool)
    mask[:, :N0] = False
    for i in range(b):
        mask[i, N0 + rng.choice(N0, counts[i], replace=False)] = False
    return mask


def make_pair(nets, seed=0, **kw):
    """(JAX generator, port generator whose mask noise is the JAX key's)."""
    jm, params, tm, sd = nets
    jg = jpred.PredictorBasedGenerator(predictor=jm, params=params, seed=seed,
                                       **kw)
    tg = tpred.PredictorBasedGenerator(predictor=tm, params=sd, seed=seed,
                                       device='cpu', **kw)
    keys = [jax.random.PRNGKey(seed)]

    def mask_noise(rows, n):
        keys[0], sub = jax.random.split(keys[0])
        return t(jax.random.uniform(sub, (rows, n), minval=0.0, maxval=0.999))

    tg._draw_mask_noise = mask_noise
    return jg, tg


def test_scatter_pred_patches_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(3, 2, 3, 32, 32).astype(np.float32)
    mask = _masks(rng, 3, (5, 5, 5))
    n_vis = N0 + 5
    y = rng.randn(3, N - n_vis, 48).astype(np.float32)
    ref = jpred.scatter_pred_patches(jnp.asarray(y), jnp.asarray(x),
                                     jnp.asarray(mask), n_vis, PATCH)
    out = tpred.scatter_pred_patches(t(y), t(x), t(mask), n_vis, PATCH)
    assert_close(out.numpy(), ref, 1e-6)


@pytest.mark.parametrize('normalize,frame', [(True, None), (False, -1),
                                             (True, 0)])
def test_predict_video_matches_jax(nets, normalize, frame):
    jm, params, tm, sd = nets
    module = tvmae.PretrainVisionTransformerModule(tm, device='cpu')
    module.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    mask = _masks(rng, 2, (6, 6))
    ref = jpred.predict_video(jm, params, jnp.asarray(x), jnp.asarray(mask),
                              N0 + 6, normalize, frame)
    out = tpred.predict_video(module, t(x), t(mask), N0 + 6, normalize, frame)
    assert tuple(out.shape) == ref.shape
    assert_close(out.numpy(), ref, 2e-4, 1e-4)


def test_predict_counterfactuals_matches_jax(nets):
    jm, params, tm, sd = nets
    module = tvmae.PretrainVisionTransformerModule(tm, device='cpu')
    module.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(2)
    b, s = 1, 3
    x = rng.rand(b, 2, 3, 32, 32).astype(np.float32)
    passive = np.ones((b, N, s), dtype=bool)
    passive[:, :N0] = False
    active = passive.copy()
    for i in range(s):
        passive[0, N0 + rng.choice(N0, 4, replace=False), i] = False
        active[0, N0 + rng.randint(N0), i] = False
    shifts = rng.randint(-2, 3, size=(b, s, 2)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), b * s).reshape(b, s, 2)
    n_vis = N0 + 5
    jy, jx, jmask = jpred.predict_counterfactuals(
        jm, params, jnp.asarray(x), jnp.asarray(passive), n_vis, True, None,
        jnp.asarray(active), jnp.asarray(shifts), s, keys=keys)
    noise = t(jax_uniform_noise(keys.reshape(-1, 2), N0)).reshape(b, s, N0)
    ty, tx, tmask = tpred.predict_counterfactuals(
        module, t(x), t(passive), n_vis, True, None, t(active), t(shifts), s,
        noise=noise)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert_close(ty.numpy(), jy, 2e-4, 1e-4)


def test_generator_predict_matches_jax(nets):
    """Equal visible counts, then unequal ones (rectangularized with the
    JAX key's draws), the default frame and the full video."""
    jg, tg = make_pair(nets, seed=1, imagenet_normalize_inputs=True)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    for counts, frame in (((5, 5), -1), ((3, 8), None), ((7, 2), 1)):
        mask = _masks(rng, 2, counts)
        ref = jg.predict(jnp.asarray(x), jnp.asarray(mask), frame=frame)
        out = tg.predict(x, mask, frame=frame)
        assert tuple(out.shape) == ref.shape
        assert_close(out.numpy(), ref, 2e-4, 1e-4)


def test_per_sample_predictions_match_jax(nets):
    jg, tg = make_pair(nets, seed=2)
    rng = np.random.RandomState(5)
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    masks = np.stack([_masks(rng, 1, (4,))[0] for _ in range(4)], -1)[None]
    ref = jg.predict_per_sample(jnp.asarray(x), jnp.asarray(masks))
    out = tg.predict_per_sample(x, t(masks))
    assert tuple(out.shape) == ref.shape == (1, 1, 3, 32, 32, 4)
    assert_close(out.numpy(), ref, 2e-4, 1e-4)
    ref = jg.batch_predict_per_sample(jnp.asarray(x), jnp.asarray(masks),
                                      frame=None, batch_size=2)
    out = tg.batch_predict_per_sample(t(x), t(masks), frame=None,
                                      batch_size=2)
    assert_close(out.numpy(), ref, 2e-4, 1e-4)
    flat = masks[0].T
    ref = jg.batch_predict_per_sample(jnp.repeat(jnp.asarray(x), 4, 0),
                                      jnp.asarray(flat), batch_size=3,
                                      sample_dim=0)
    out = tg.batch_predict_per_sample(t(x).repeat(4, 1, 1, 1, 1), t(flat),
                                      batch_size=3, sample_dim=0)
    assert_close(out.numpy(), ref, 2e-4, 1e-4)


def test_mask_utilities_match_jax(nets):
    jg, tg = make_pair(nets)
    rng = np.random.RandomState(6)
    x = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    jg.set_input(jnp.asarray(x))
    tg.set_input(x)
    assert tg.inp_mask_shape == jg.inp_mask_shape == (2, N)
    assert (tg.t_dim, tg.c_dim) == (jg.t_dim, jg.c_dim)
    for frame in (-1, 0, None):
        np.testing.assert_array_equal(
            tg.get_zeros_mask(frame=frame).numpy(),
            np.asarray(jg.get_zeros_mask(frame=frame)))
    np.testing.assert_array_equal(tg.get_fully_visible_mask().numpy(),
                                  np.asarray(jg.get_fully_visible_mask()))
    m1 = rng.rand(2, N) > 0.5
    m2 = rng.rand(2, N) > 0.5
    for frame in (-1, None):
        np.testing.assert_array_equal(
            tg.mask_complement(m1, m2, frame=frame).numpy(),
            np.asarray(jg.mask_complement(jnp.asarray(m1), jnp.asarray(m2),
                                          frame=frame)))
    np.testing.assert_array_equal(
        tg.invert_mask_frame(t(m1), (8, 8)).numpy(),
        np.asarray(jg.invert_mask_frame(jnp.asarray(m1), (8, 8))))
    np.testing.assert_array_equal(tg._invert_mask(t(m1), 0).numpy(),
                                  np.asarray(jg._invert_mask(jnp.asarray(m1),
                                                             0)))
    for upsample, invert in ((False, False), (True, True)):
        np.testing.assert_array_equal(
            tg.get_mask_image(m1, upsample=upsample, invert=invert).numpy(),
            np.asarray(jg.get_mask_image(jnp.asarray(m1), upsample=upsample,
                                         invert=invert)))
    for radius, upsample in ((1, False), (2, True)):
        assert_close(tg.get_nearby_patches(m1, radius, upsample).numpy(),
                     jg.get_nearby_patches(jnp.asarray(m1), radius, upsample),
                     1e-6)
    img = tg.get_mask_image(m1)
    assert tg.patch_idx_list_from_mask(img) == jg.patch_idx_list_from_mask(
        np.asarray(img))
    idx = [(3, 4), (1, 2, 7), (1, 0, 5, 6)]
    for rows in (idx[:1], [idx[1]], [idx[2]]):
        np.testing.assert_array_equal(
            tg.make_visible_from_patch_idx_list(img, rows, stride=1).numpy(),
            np.asarray(jg.make_visible_from_patch_idx_list(
                jnp.asarray(img.numpy()), rows, stride=1)))
    for radius in (0, 1, 2):
        np.testing.assert_array_equal(
            tg.generate_cutout_mask([(12, 20), (28, 4)], radius=radius)
            .numpy(),
            np.asarray(jg.generate_cutout_mask([(12, 20), (28, 4)],
                                               radius=radius)))
    np.testing.assert_array_equal(tg.make_static_movie(x, t=3).numpy(),
                                  np.asarray(jg.make_static_movie(
                                      jnp.asarray(x), t=3)))
    n_vis = N0 + 5
    mask = _masks(rng, 2, (5, 5))
    y = rng.randn(2, N - n_vis, 48).astype(np.float32)
    assert_close(tg.pred_patches_to_video(y, x, mask).numpy(),
                 jg.pred_patches_to_video(jnp.asarray(y), jnp.asarray(x),
                                          jnp.asarray(mask)), 1e-6)


def _check_keypoint_contract(tg):
    """The keypoint predictor is a callable x -> [B, 1, 1, H, W];
    keypoint_params and keypoint_predictor_load_path load with strict=True
    into the module it wraps, and raise when it wraps none."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.utils import weights
    kw = dict(predictor=tg.predictor, device='cpu')
    src = weights.init_raft(traft.RAFT(iters=1, output_dim=1, device='cpu'),
                            torch.Generator().manual_seed(3))
    sd = src.state_dict()
    for predictor in (None, lambda x: x[:, :1, :1]):
        with pytest.raises(ValueError, match='keypoint'):
            tpred.PredictorBasedGenerator(keypoint_predictor=predictor,
                                          keypoint_params=sd, **kw)
    kp = traft.RaftKeypointPredictor(traft.RAFT(iters=1, output_dim=1,
                                                device='cpu'))
    g = tpred.PredictorBasedGenerator(keypoint_predictor=kp,
                                      keypoint_params=sd,
                                      error_func=lambda p, t: abs(p - t), **kw)
    assert g.keypoint_module() is kp.module and g.keypoint_params is sd
    x = torch.rand(1, 2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    assert torch.equal(g.predict_keypoints_map(x),
                       traft.RaftKeypointPredictor(src)(x))
    assert g.predict_keypoints_map(x).shape == (1, 1, 1, 32, 32)
    assert torch.equal(g.error_func(torch.ones(2), torch.zeros(2)),
                       torch.ones(2))
    return src


def test_keypoint_checkpoint_loads_strict(nets, tmp_path):
    """keypoint_predictor_load_path: a reference .pth ({'model': ...} with
    DDP prefixes) loads with strict=True; a checkpoint with a missing key
    fails at once; without a module to load into it raises."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    _, tg = make_pair(nets)
    src = _check_keypoint_contract(tg)
    path = tmp_path / 'keypoints.pth'
    torch.save({'model': {'module.' + k: v
                          for k, v in src.state_dict().items()}}, path)
    kp = traft.RaftKeypointPredictor(traft.RAFT(iters=1, output_dim=1,
                                                device='cpu'))
    tpred.PredictorBasedGenerator(
        predictor=tg.predictor, keypoint_predictor=kp,
        keypoint_predictor_load_path=str(path), device='cpu')
    for k, v in src.state_dict().items():
        assert torch.equal(kp.module.state_dict()[k], v), k
    bad = dict(src.state_dict())
    bad.pop('output_block.2.bias')
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match='output_block.2.bias'):
        tpred.PredictorBasedGenerator(
            predictor=tg.predictor, keypoint_predictor=kp,
            keypoint_predictor_load_path=str(path), device='cpu')
    with pytest.raises(ValueError, match='keypoint'):
        tpred.PredictorBasedGenerator(
            predictor=tg.predictor, keypoint_predictor_load_path=str(path),
            device='cpu')


def test_generator_settings_and_unported_arguments(nets):
    _, tg = make_pair(nets)
    with pytest.raises(ValueError, match='temporal_dim'):
        tg.set_temporal_dim(3)
    tg.set_image_size(32)
    with pytest.raises(ValueError, match='built for image size'):
        tg.set_image_size(64, 64)
    _check_keypoint_contract(tg)
    with pytest.raises(ValueError, match='mask_generator'):
        tg.generate_mask(torch.zeros(1, 2, 3, 32, 32))
    # set_predictor with new weights rebuilds the exact model
    first = tg._exact_module()
    tg.set_predictor(tg.predictor, params=dict(tg.params))
    assert tg._exact_module() is not first


class _PredictionDraws(JaxDraws):
    """JaxDraws for PredictorBasedGenerator._shift, whose one shift the JAX
    package draws from next_key() itself (FlowGenerator splits it)."""

    def shifts(self, num_samples):
        from counterfactualworldmodels_tpu.pipelines import perturbation
        g = self.gen
        return t(perturbation.random_shift(
            self.next_key(), g.max_shift_fraction, g.x.shape[-2:],
            g.patch_size))[None].long()


def _draw_pair(nets, seed=0, **kw):
    jm, params, tm, sd = nets
    jg = jpred.PredictorBasedGenerator(predictor=jm, params=params, seed=seed,
                                       **kw)
    tg = tpred.PredictorBasedGenerator(predictor=tm, params=sd, seed=seed,
                                       device='cpu', **kw)
    _PredictionDraws(tg, seed)
    return jg, tg


@pytest.mark.parametrize('error_func', [None, 'abs'])
def test_error_apis_match_jax(nets, error_func):
    """predict_with_mask, error_with_mask (with its IndexError),
    predict_error and get_error_on_target_region, with the default squared
    error and a given one; errors within 1e-3 (sums of the predictions'
    2e-4 differences over channels)."""
    kw = dict(imagenet_normalize_inputs=True)
    if error_func == 'abs':
        kw['error_func'] = lambda p, q: abs(p - q)
    jg, tg = _draw_pair(nets, seed=3, **kw)
    rng = np.random.RandomState(10)
    x = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    mask = _masks(rng, 2, (6, 6))
    jg.set_input(jnp.asarray(x))
    tg.set_input(x)
    for invert in (False, True):
        assert_close(tg.predict_with_mask(mask, invert).numpy(),
                     jg.predict_with_mask(jnp.asarray(mask), invert),
                     2e-4, 1e-4)
    for frame in (-1, None):
        assert_close(tg.error_with_mask(mask, frame=frame).numpy(),
                     jg.error_with_mask(jnp.asarray(mask), frame=frame),
                     1e-3, 1e-4)
        assert_close(tg.predict_error(x, mask, frame=frame).numpy(),
                     jg.predict_error(jnp.asarray(x), jnp.asarray(mask),
                                      frame=frame), 1e-3, 1e-4)
    for g, m in ((jg, jnp.asarray(mask)), (tg, mask)):
        with pytest.raises(IndexError, match='out of range'):
            g.error_with_mask(m, frame=1)
    target = rng.rand(2, N) > 0.7
    for kwargs in (dict(), dict(average_error=False),
                   dict(aggregate_over_patches=False, frame=None),
                   dict(frame=None)):
        ref = jg.get_error_on_target_region(
            jnp.asarray(x), jnp.asarray(mask), jnp.asarray(target), **kwargs)
        out = tg.get_error_on_target_region(x, mask, target, **kwargs)
        assert tuple(out.shape) == ref.shape
        assert_close(out.numpy(), ref, 1e-3, 1e-4)
    with pytest.raises(NotImplementedError):
        tg.get_initial_mask(x)


def test_shift_patches_and_mask_matches_jax(nets):
    """Random patch-quantized shifts from the seeded numpy rng (two draws a
    call, as the reference), reflect padding of the frame and of its mask
    (cast to float and back): pixels and masks bitwise."""
    jg, tg = _draw_pair(nets, seed=4)
    rng = np.random.RandomState(11)
    x = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    mask = rng.rand(2, N) > 0.5
    for frac, frame, xin in ((0.3, -1, x), (0.3, 0, x), (0.2, -1, x[:, 1]),
                             (0.0, -1, x)):
        m_in = mask if xin.ndim == 5 else mask[:, N0:]
        jx, jm = jg.shift_patches_and_mask(jnp.asarray(xin), jnp.asarray(m_in),
                                           frac, frame)
        tx, tm = tg.shift_patches_and_mask(xin, m_in, frac, frame)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tg.rng.randint(1000) == jg.rng.randint(1000)


@pytest.mark.parametrize('fix_passive', [False, True])
def test_counterfactual_prediction_matches_jax(nets, fix_passive):
    """get_counterfactual_prediction on an image (made a static movie) with
    active frame-1 patches: a given shift, then one drawn from the JAX key
    (_draw_shifts), the rectangularizer's noise from it too
    (_draw_prompt_noise); the shifts kept, the videos within 2e-4 / 1e-4.
    Then __call__ and forward with a mask."""
    jg, tg = _draw_pair(nets, seed=5, imagenet_normalize_inputs=True)
    rng = np.random.RandomState(12)
    img = rng.rand(1, 3, 32, 32).astype(np.float32)
    active = np.ones((1, N), dtype=bool)
    active[0, N0 + rng.choice(N0, 3, replace=False)] = False
    passive = np.ones((1, N), dtype=bool)
    passive[0, :N0] = False
    passive[0, N0 + rng.choice(N0, 4, replace=False)] = False
    for shift in ([1, -1], None):
        ref = jg.get_counterfactual_prediction(
            jnp.asarray(img), jnp.asarray(passive), jnp.asarray(active),
            shift=shift, fix_passive=fix_passive)
        out = tg.get_counterfactual_prediction(
            img, passive, active, shift=shift, fix_passive=fix_passive)
        assert tuple(out.shape) == ref.shape == (1, 2, 3, 32, 32)
        assert_close(out.numpy(), ref, 2e-4, 1e-4)
        assert tg.shift == jg.shift
    np.testing.assert_array_equal(np.stack(tg.shifts), np.stack(jg.shifts))
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    mask = _masks(rng, 1, (5,))
    ref = jg(jnp.asarray(x), jnp.asarray(mask))
    assert_close(tg(x, mask).numpy(), ref, 2e-4, 1e-4)
    assert_close(tg.forward(x, mask, frame=-1).numpy(),
                 jg.forward(jnp.asarray(x), jnp.asarray(mask), frame=-1),
                 2e-4, 1e-4)


def test_visualization_helpers_match_jax(nets):
    """get_masked_pred_patches (invert, fill), unmask_one_patch,
    get_frame_pairs; maskshow draws under matplotlib's Agg backend."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    jg, tg = _draw_pair(nets)
    rng = np.random.RandomState(13)
    preds = rng.rand(2, 2, 3, 32, 32).astype(np.float32)
    mask = rng.rand(2, N) > 0.5
    for kw in (dict(), dict(invert=True), dict(fill_value=[1.0, 0.0, 0.5])):
        np.testing.assert_array_equal(
            tg.get_masked_pred_patches(preds, mask, **kw).numpy(),
            np.asarray(jg.get_masked_pred_patches(jnp.asarray(preds),
                                                  jnp.asarray(mask), **kw)))
    for idx, shape, frame in ((7, None, 0), ((3, 4), (2, 8, 8), 1),
                              ((1, 2, 6), (2, 8, 8), 0)):
        np.testing.assert_array_equal(
            tpred.PredictorBasedGenerator.unmask_one_patch(
                t(mask), idx, shape, frame).numpy(),
            np.asarray(jpred.PredictorBasedGenerator.unmask_one_patch(
                jnp.asarray(mask), idx, shape, frame)))
    video = rng.rand(1, 3, 3, 8, 8).astype(np.float32)
    for frame in (None, 0):
        jp = jg.get_frame_pairs(jnp.asarray(video), frame)
        tp = tg.get_frame_pairs(video, frame)
        assert len(tp) == len(jp) == 2
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (tg.target_frame, tg.num_frame_pairs) == (jg.target_frame,
                                                         jg.num_frame_pairs)
    ax = tg.maskshow(mask)
    assert len(ax.images) == 1
    plt.close('all')


def test_mae_wrapper_matches_jax():
    """MaeWrapper around a single-image MAE (here a fixed function of the
    image: its patches doubled): frame select, imagenet normalization of
    the input and unnormalization of the output, the returned mask. The
    port's predictor carries its weights; JAX's takes params."""
    from counterfactualworldmodels_tpu.ops import patches as jpatches
    from counterfactualworldmodels_tpu_torch.ops import patches as tpatches

    def jmae(params, x, mask_ratio=0.9, mask=None):
        return 0.0, params['scale'] * jpatches.patchify(x, 4), mask

    def tmae(x, mask_ratio=0.9, mask=None):
        return 0.0, 2.0 * tpatches.patchify(x, 4), mask

    rng = np.random.RandomState(14)
    x = rng.rand(2, 2, 3, 16, 16).astype(np.float32)
    mask = rng.rand(2, 16) > 0.5
    for normalize in (True, False):
        jw = jpred.MaeWrapper(
            predictor=jmae, params={'scale': 2.0},
            imagenet_normalize_inputs=normalize,
            unpatchify=lambda y: jpatches.unpatchify(y, 4, (2, 3, 16, 16)))
        tw = tpred.MaeWrapper(
            predictor=tmae, imagenet_normalize_inputs=normalize,
            unpatchify=lambda y: tpatches.unpatchify(y, 4, (2, 3, 16, 16)),
            device='cpu')
        for xin, frame in ((x, 0), (x, 1), (x[:, 0], 0)):
            ref = jw.predict(jnp.asarray(xin), jnp.asarray(mask), frame=frame)
            out = tw.predict(xin, t(mask), frame=frame)
            assert tuple(out.shape) == ref.shape
            assert_close(out.numpy(), ref, 1e-6)
            np.testing.assert_array_equal(tw.mask.numpy(), np.asarray(jw.mask))
        img = x[:, 0]
        assert_close(tw.imagenet_unnormalize(img).numpy(),
                     jw.imagenet_unnormalize(jnp.asarray(img)), 1e-6)
        assert_close(tw.imagenet_normalize(img).numpy(),
                     jw.imagenet_normalize(jnp.asarray(img)), 1e-6)
