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

from torch_port_common import SMALL_VMAE, assert_close, jax_uniform_noise, t

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


def test_generator_settings_and_unported_arguments(nets):
    _, tg = make_pair(nets)
    with pytest.raises(ValueError, match='temporal_dim'):
        tg.set_temporal_dim(3)
    tg.set_image_size(32)
    with pytest.raises(ValueError, match='built for image size'):
        tg.set_image_size(64, 64)
    with pytest.raises(NotImplementedError, match='keypoint'):
        tpred.PredictorBasedGenerator(predictor=tg.predictor,
                                      keypoint_predictor=object(),
                                      device='cpu')
    with pytest.raises(ValueError, match='mask_generator'):
        tg.generate_mask(torch.zeros(1, 2, 3, 32, 32))
    # set_predictor with new weights rebuilds the exact model
    first = tg._exact_module()
    tg.set_predictor(tg.predictor, params=dict(tg.params))
    assert tg._exact_module() is not first
