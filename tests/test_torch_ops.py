"""Port parity: base ops (patches, normalization, position table, mask ops,
token ordering) against the JAX package on the CPU. Integer and boolean
results match exactly; float results within 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.masking import mask_ops as jmask
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.ops import normalization as jnorm
from counterfactualworldmodels_tpu.ops import patches as jpatches
from counterfactualworldmodels_tpu.ops import pos_embed as jpos
from counterfactualworldmodels_tpu_torch.masking import mask_ops as tmask
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.ops import normalization as tnorm
from counterfactualworldmodels_tpu_torch.ops import patches as tpatches
from counterfactualworldmodels_tpu_torch.ops import pos_embed as tpos

from torch_port_common import t


@pytest.mark.parametrize('shape,patch,tdim', [
    ((2, 2, 3, 16, 24), (1, 4, 4), 1),
    ((2, 3, 4, 16, 8), (2, 4, 2), 2),
    ((2, 3, 16, 8), 4, 1),
])
def test_patchify_unpatchify_match_jax(shape, patch, tdim):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jp = np.asarray(jpatches.patchify(jnp.asarray(x), patch, tdim))
    tp = tpatches.patchify(t(x), patch, tdim)
    np.testing.assert_array_equal(tp.numpy(), jp)
    jp4 = np.asarray(jpatches.patchify(jnp.asarray(x), patch, tdim, False))
    np.testing.assert_array_equal(
        tpatches.patchify(t(x), patch, tdim, False).numpy(), jp4)
    back = tpatches.unpatchify(tp, patch, shape, tdim)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpatches.unpatchify(jnp.asarray(jp), patch,
                                                     shape, tdim)))
    assert (tpatches.canonical_patch_size(patch)
            == jpatches.canonical_patch_size(patch))


@pytest.mark.parametrize('shape,tdim', [((2, 2, 3, 4, 4), 1),
                                        ((2, 3, 2, 4, 4), 2),
                                        ((2, 3, 4, 4), 1)])
def test_imagenet_normalize_matches_jax(shape, tdim):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    ref = np.asarray(jnorm.imagenet_normalize(jnp.asarray(x), tdim))
    np.testing.assert_allclose(tnorm.imagenet_normalize(t(x), tdim).numpy(),
                               ref, atol=1e-6)


@pytest.mark.parametrize('positions,d', [(128, 64), (6272, 1024),
                                         ([0.5, 3.0, 7.25], 32)])
def test_sinusoid_table_matches_jax_bitwise(positions, d):
    ref = np.asarray(jpos.sinusoid_encoding_table(positions, d))
    out = tpos.sinusoid_encoding_table(positions, d).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('src,size', [((2, 2, 4, 4), (16, 16)),
                                      ((3, 8, 8), (4, 4)),
                                      ((2, 4, 4), (4, 4))])
def test_upsample_masks_matches_jax(src, size):
    m = np.random.RandomState(2).rand(*src) > 0.5
    ref = np.asarray(jmask.upsample_masks(jnp.asarray(m), size))
    np.testing.assert_array_equal(tmask.upsample_masks(t(m), size).numpy(),
                                  ref)


def test_mask_order_matches_jax():
    m = np.random.RandomState(3).rand(5, 37) > 0.7
    ref = np.asarray(jvmae.mask_order(jnp.asarray(m)))
    np.testing.assert_array_equal(tvmae.mask_order(t(m)).numpy(), ref)


def test_vmae_config_properties_match_jax():
    for factory in ('base_16x16patch_2frames_1tube',
                    'base_8x8patch_2frames_1tube',
                    'large_4x4patch_2frames_1tube'):
        jm = getattr(jvmae, factory)()
        tm = getattr(tvmae, factory)()
        for prop in ('full_patch_size', 'num_patches', 'num_patches_per_frame',
                     'mask_size', 'mask_shape', 'out_dim', 'encoder_depth',
                     'decoder_depth', 'encoder_num_heads',
                     'decoder_num_heads', 'encoder_embed_dim',
                     'decoder_embed_dim'):
            assert getattr(tm, prop) == getattr(jm, prop), (factory, prop)


@pytest.mark.parametrize('shape,tdim', [((2, 2, 3, 4, 4), 1),
                                        ((2, 3, 2, 4, 4), 2),
                                        ((2, 3, 4, 4), 1)])
def test_imagenet_unnormalize_matches_jax(shape, tdim):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    ref = np.asarray(jnorm.imagenet_unnormalize(jnp.asarray(x), tdim))
    out = tnorm.imagenet_unnormalize(t(x), tdim)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(
        tnorm.imagenet_normalize(out, tdim).numpy(), x, atol=1e-6)


@pytest.mark.parametrize('shape,patch', [((2, 2, 3, 16, 24), (1, 4, 4)),
                                         ((1, 4, 3, 16, 8), (2, 4, 2)),
                                         ((1, 2, 3, 32, 32), 8)])
def test_patch_counts_and_average_within_patches_match_jax(shape, patch):
    assert (tpatches.num_patches(shape, patch)
            == jpatches.num_patches(shape, patch))
    assert tpatches.mask_shape(shape, patch) == jpatches.mask_shape(shape,
                                                                    patch)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    z = np.asarray(jpatches.patchify(jnp.asarray(x), patch))
    for zz in (z, z.reshape(*z.shape[:2], -1, 3)):
        ref = np.asarray(jpatches.average_within_patches(jnp.asarray(zz), 3))
        out = tpatches.average_within_patches(t(zz), 3)
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize('b,seq,size,normalize', [(2, 3, (4, 6), True),
                                                  (1, 0, (5, 5), True),
                                                  (2, 2, (3, 7), False)])
def test_coordinate_ims_match_jax(b, seq, size, normalize):
    from counterfactualworldmodels_tpu.ops import coords as jcoords
    from counterfactualworldmodels_tpu_torch.ops import coords as tcoords
    ref = np.asarray(jcoords.coordinate_ims(b, seq, size, normalize))
    out = tcoords.coordinate_ims(b, seq, size, normalize)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize('conv', [dict(), dict(from_sampling_grid=False),
                                  dict(from_sampling_grid=False,
                                       from_image_coordinates=True)],
                         ids=['sampling_grid', 'xy', 'image_coordinates'])
def test_flow_to_rgb_matches_jax(conv):
    """Every angle, zero flow (atan2(0, 0) = 0 on both sides) and speeds
    past max_speed, in the three coordinate conventions."""
    from counterfactualworldmodels_tpu.ops import flow_viz as jviz
    from counterfactualworldmodels_tpu_torch.ops import flow_viz as tviz
    flow = (np.random.RandomState(6).randn(2, 3, 2, 9, 11) * 3).astype(
        np.float32)
    flow[0, 0, :, :3] = 0.0
    flow[0, 1, 0, :, :2] = 0.0                   # flow along one axis only
    ref = np.asarray(jviz.flow_to_rgb(jnp.asarray(flow), 4.0, **conv))
    out = tviz.flow_to_rgb(t(flow), 4.0, **conv)
    assert tuple(out.shape) == ref.shape == (2, 3, 3, 9, 11)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_array_equal(out[0, 0, :, :3].numpy(), 0.0)
    np.testing.assert_allclose(tviz.FlowToRgb(4.0, **conv)(t(flow)).numpy(),
                               ref, atol=1e-6)
    hsv = np.random.RandomState(7).rand(4, 3, 5, 5).astype(np.float32)
    hsv[:, 0] = (hsv[:, 0] - 0.5) * 20          # negative and large hues
    np.testing.assert_allclose(tviz.hsv_to_rgb(t(hsv)).numpy(),
                               np.asarray(jviz.hsv_to_rgb(jnp.asarray(hsv))),
                               atol=1e-6)


def test_to_numpy_image_matches_jax():
    from counterfactualworldmodels_tpu import vis_utils as jvis
    from counterfactualworldmodels_tpu_torch import vis_utils as tvis
    rng = np.random.RandomState(8)
    for shape in ((3, 4, 5), (2, 1, 4, 5), (2, 2, 3, 4, 5), (4, 5)):
        x = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(tvis.to_numpy_image(t(x)),
                                      jvis.to_numpy_image(x))


@pytest.mark.parametrize('to_image,to_grid', [(True, False), (False, False),
                                              (False, True)])
def test_rgb_flow_inversion_matches_jax(to_image, to_grid):
    """data/utils: rgb_to_hsv and the HSV flow wheel's inverse (grey and
    saturated pixels, each hue sector), with the flow_to_rgb re-exports."""
    from counterfactualworldmodels_tpu.data import utils as jdu
    from counterfactualworldmodels_tpu_torch.data import utils as tdu
    from counterfactualworldmodels_tpu_torch.ops import flow_viz
    rng = np.random.RandomState(5)
    rgb = rng.rand(2, 3, 6, 7).astype(np.float32)
    rgb[0, :, 0, 0] = 0.4                          # grey: no hue
    rgb[0, :, 0, 1] = 0.0                          # black
    rgb[1, :, 0, :3] = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]   # max per channel
    np.testing.assert_allclose(tdu.rgb_to_hsv(t(rgb)).numpy(),
                               np.asarray(jdu.rgb_to_hsv(jnp.asarray(rgb))),
                               atol=1e-5)
    kw = dict(to_image_coordinates=to_image, to_sampling_grid=to_grid,
              max_speed=3.0)
    np.testing.assert_allclose(
        tdu.rgb_to_xy_flows(t(rgb), **kw).numpy(),
        np.asarray(jdu.rgb_to_xy_flows(jnp.asarray(rgb), **kw)), atol=1e-5)
    np.testing.assert_allclose(
        tdu.RgbFlowToXY(**kw)(t(rgb)).numpy(),
        np.asarray(jdu.RgbFlowToXY(**kw)(jnp.asarray(rgb))), atol=1e-5)
    assert tdu.FlowToRgb is flow_viz.FlowToRgb
    assert tdu.flow_to_rgb is flow_viz.flow_to_rgb
    assert tdu.hsv_to_rgb is flow_viz.hsv_to_rgb
    # the round trip on the sampling grid: flow -> rgb -> flow
    flow = rng.uniform(-1, 1, (2, 2, 5, 5)).astype(np.float32) * 0.7
    back = tdu.rgb_to_xy_flows(tdu.flow_to_rgb(t(flow), max_speed=1.0),
                               to_image_coordinates=False,
                               to_sampling_grid=True)
    np.testing.assert_allclose(back.numpy(), flow, atol=1e-4)
