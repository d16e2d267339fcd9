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
