"""Port parity: energy sampling (ops/sampling.py), the energy mask family
and its class wrappers (masking/generators.py), the rest of
masking/mask_ops.py and the flow-sample filter (pipelines/filters.py),
against the JAX package on the CPU.

The JAX functions draw from a key; the port takes the same draws as
inputs (categorical indices, uniform noise), computed here from that key
as the JAX function computes them. Masks, indices and filter decisions
match bitwise; float maps within 1e-6, filtered flows within 1e-5."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from counterfactualworldmodels_tpu.masking import generators as jgen
from counterfactualworldmodels_tpu.masking import mask_ops as jmo
from counterfactualworldmodels_tpu.ops import sampling as jsamp
from counterfactualworldmodels_tpu.pipelines import filters as jfilt
from counterfactualworldmodels_tpu_torch.masking import generators as tgen
from counterfactualworldmodels_tpu_torch.masking import mask_ops as tmo
from counterfactualworldmodels_tpu_torch.ops import sampling as tsamp
from counterfactualworldmodels_tpu_torch.pipelines import filters as tfilt

from torch_port_common import assert_close, t


def _categorical(key, p, num_points):
    """The JAX package's categorical draws [B, P] from probabilities p."""
    logits = jnp.log(jnp.clip(jnp.asarray(p), min=1e-30))
    return np.asarray(jax.random.categorical(
        key, logits, axis=-1, shape=(num_points, p.shape[0])).T)


def _jax_probs(probs, eps=1e-9, normalize=False):
    b = probs.shape[0]
    p = jnp.asarray(probs).reshape(b, -1)
    if normalize:
        p = p - p.min(-1, keepdims=True)
    p = jax.nn.relu(p + eps)
    return p / jnp.clip(p.sum(-1, keepdims=True), min=eps)


def test_boltzmann_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 1, 8, 8).astype(np.float32)
    for beta in (None, 1.0, 3.5):
        assert_close(tsamp.boltzmann(t(x), beta).numpy(),
                     jsamp.boltzmann(jnp.asarray(x), beta), 1e-6)


@pytest.mark.parametrize('normalize', [False, True])
def test_sample_image_inds_from_probs_on_jax_draws(normalize):
    rng = np.random.RandomState(1)
    probs = rng.rand(3, 6, 5).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsamp.sample_image_inds_from_probs(
        key, jnp.asarray(probs), 7, normalize=normalize))
    idx = _categorical(key, _jax_probs(probs, normalize=normalize), 7)
    out = tsamp.sample_image_inds_from_probs(t(probs), 7, normalize=normalize,
                                             indices=t(idx))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    got = tsamp.sample_image_inds_from_probs(
        t(probs), 7, generator=torch.Generator().manual_seed(0))
    assert got.shape == (3, 7, 2) and (got[..., 0] < 6).all()


def test_index_into_images_matches_jax():
    rng = np.random.RandomState(2)
    images = rng.randn(2, 3, 6, 5).astype(np.float32)
    inds = np.stack([rng.randint(0, 6, (2, 4)), rng.randint(0, 5, (2, 4))],
                    -1).astype(np.int32)
    np.testing.assert_array_equal(
        tsamp.index_into_images(t(images), t(inds)).numpy(),
        np.asarray(jsamp.index_into_images(jnp.asarray(images),
                                           jnp.asarray(inds))))


@pytest.mark.parametrize('shape,binarize', [((2, 1, 6, 6), False),
                                            ((2, 2, 1, 4, 6), True)])
def test_sample_from_energy_on_jax_draws(shape, binarize):
    rng = np.random.RandomState(3)
    probs = rng.rand(*shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jsamp.sample_from_energy(
        key, jnp.asarray(probs), num_points=3, num_samples=2,
        binarize=binarize))
    b, h, w = shape[0], shape[-2], shape[-1]
    tt = shape[1] if len(shape) == 5 else 1
    flat = np.broadcast_to(probs.reshape(b, 1, tt, h, w),
                           (b, 2, tt, h, w)).reshape(-1, h, w)
    idx = _categorical(key, _jax_probs(flat), 3)
    out = tsamp.sample_from_energy(t(probs), num_points=3, num_samples=2,
                                   binarize=binarize, indices=t(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sample_per_pixel_on_jax_draws():
    rng = np.random.RandomState(4)
    probs = (rng.rand(2, 1, 5, 5) * 1.4 - 0.2).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jsamp.sample_per_pixel(key, jnp.asarray(probs)))
    noise = np.asarray(jax.random.uniform(key, probs.shape))
    np.testing.assert_array_equal(
        tsamp.sample_per_pixel(t(probs), noise=t(noise)).numpy(), ref)


ENERGY_CASES = [  # (frame h, w, num_visible, clump, temperature, pool, power)
    (8, 8, 3, 1, None, 'mean', 1),
    (8, 8, 2, 2, None, 'max', 1),
    (6, 6, 0, 1, None, 'mean', 1),
    (8, 8, 4, 1, 2.0, 'min', 2),
]


def _energy_indices(key, energy, h, w, nv, cf, temp, pool, power):
    """The categorical draws energy_frame_mask takes from key."""
    b = energy.shape[0]
    e = jgen._pool_energy(jnp.asarray(energy), (h // cf, w // cf), pool)
    if temp is not None:
        e = e - e.max((-2, -1), keepdims=True)
        e = jnp.exp(e * temp)
    e = jnp.power(e, power)
    p = e.reshape(b, -1)
    p = p - p.min(-1, keepdims=True)
    return _categorical(key, _jax_probs(p), max(nv, 1))


@pytest.mark.parametrize('case', ENERGY_CASES)
def test_energy_masks_on_jax_draws(case):
    h, w, nv, cf, temp, pool, power = case
    rng = np.random.RandomState(5)
    energy = rng.rand(3, 1, 2 * h, 2 * w).astype(np.float32)
    key = jax.random.PRNGKey(7)
    idx = t(_energy_indices(key, energy, h, w, *case[2:]))
    ref = np.asarray(jgen.energy_frame_mask(key, jnp.asarray(energy), h, w,
                                            nv, cf, temp, pool, power))
    out = tgen.energy_frame_mask(t(energy), h, w, nv, cf, temp, pool, power,
                                 indices=idx)
    np.testing.assert_array_equal(out.numpy(), ref)
    if nv == 0:
        assert out.all()
    ref = np.asarray(jgen.energy_mask(key, jnp.asarray(energy), (3, h, w), nv,
                                      1, cf, temp, pool, power))
    out = tgen.energy_mask(t(energy), (3, h, w), nv, 1, cf, temp, pool,
                           power, indices=idx)
    np.testing.assert_array_equal(out.numpy(), ref)
    ref = np.asarray(jgen.rotated_table_energy_mask(
        key, jnp.asarray(energy), (2, h, w), nv, cf, temp, pool, power))
    out = tgen.rotated_table_energy_mask(t(energy), (2, h, w), nv, cf, temp,
                                         pool, power, indices=idx)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_energy_sampler_classes_on_jax_draws():
    """RotatedTableEnergyMaskingGenerator: num_visible / mask_ratio
    accounting as the JAX class, masks from the JAX key's draws (a
    callable of the probabilities, as FlowGenerator passes them)."""
    kw = dict(input_size=(2, 8, 8), mask_ratio=0.0, seed=3, clumping_factor=2)
    jg = jgen.RotatedTableEnergyMaskingGenerator(**kw)
    tg = tgen.RotatedTableEnergyMaskingGenerator(device='cpu', **kw)
    for g in (jg, tg):
        g.num_visible = 2 * g.cf ** 2
    assert (tg.num_visible, tg.num_masks_per_frame, tg.mask_ratio) == \
        (jg.num_visible, jg.num_masks_per_frame, jg.mask_ratio)
    tg.mask_ratio = jg.mask_ratio = 0.75
    assert (tg.num_visible, tg.num_masks_per_frame) == \
        (jg.num_visible, jg.num_masks_per_frame)
    tg.num_visible = jg.num_visible = 8
    energy = np.random.RandomState(6).rand(2, 1, 16, 16).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jg(jnp.asarray(energy), key=key))
    out = tg(t(energy), indices=lambda p, n: t(_categorical(key, p.numpy(),
                                                            n)))
    np.testing.assert_array_equal(out.numpy(), ref)
    seeded = [tgen.RotatedTableEnergyMaskingGenerator(device='cpu', **kw)
              for _ in range(2)]
    for g in seeded:
        g.num_visible = 4
    assert torch.equal(seeded[0](t(energy)), seeded[1](t(energy)))
    assert repr(tg).startswith('RotatedTableEnergyMaskingGenerator')


def test_masking_generator_accounting_and_masks():
    kw = dict(input_size=(2, 6, 6), mask_ratio=0.5, visible_frames=1)
    jg = jgen.MaskingGenerator(**kw)
    tg = tgen.MaskingGenerator(device='cpu', **kw)
    assert (tg.num_visible, tg.num_masks_per_frame) == \
        (jg.num_visible, jg.num_masks_per_frame)
    tg.num_visible = jg.num_visible = 10
    assert tg.mask_ratio == jg.mask_ratio
    m = tg(torch.zeros(3, 1))
    assert m.shape == (3, 3 * 36) and not m[:, :36].any()
    assert ((~m[:, 36:]).reshape(3, 2, 36).sum(-1) == 10).all()


@pytest.mark.parametrize('mode,num_visible', [('min', None), ('max', None),
                                              ('mean', None), ('min', 9)])
def test_rectangularize_on_jax_draws(mode, num_visible):
    rng = np.random.RandomState(7)
    masks = rng.rand(4, 30) > 0.6
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jmo.rectangularize(key, jnp.asarray(masks), num_visible,
                                        mode))
    noise = np.asarray(jax.random.uniform(key, (4, 30), minval=0.0,
                                          maxval=0.999))
    out = tmo.rectangularize(t(masks), num_visible, mode, noise=t(noise))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(set((~out).sum(-1).tolist())) == 1


@pytest.mark.parametrize('leave_one_out', [False, True])
def test_partition_masks_on_jax_draws(leave_one_out):
    rng = np.random.RandomState(8)
    masks = rng.rand(3, 20) > 0.5
    key = jax.random.PRNGKey(2)
    ref = jmo.partition_masks(key, jnp.asarray(masks), 3, leave_one_out)
    keys = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.uniform(k, (20,))) for k in keys])
    out = tmo.partition_masks(t(masks), 3, leave_one_out, noise=t(noise))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_distance_transform_adjacency_and_invert_match_jax():
    rng = np.random.RandomState(9)
    masks = rng.rand(2, 2, 7, 6) > 0.8
    masks[0, 1] = True                       # a frame with nothing visible
    for self_mask in (True, False):
        assert_close(tmo.patch_distance_transform(t(masks), self_mask).numpy(),
                     jmo.patch_distance_transform(jnp.asarray(masks),
                                                  self_mask), 1e-6)
    for radius in (None, 0, 1, 2):
        out = tmo.patches_adjacent_to_visible(t(masks), radius)
        ref = jmo.patches_adjacent_to_visible(jnp.asarray(masks), radius)
        assert_close(out.numpy(), ref, 1e-6)
    flat = masks.reshape(2, -1)
    for frame in (-1, 0):
        np.testing.assert_array_equal(
            tmo.invert_mask_frame(t(flat), (7, 6), frame).numpy(),
            np.asarray(jmo.invert_mask_frame(jnp.asarray(flat), (7, 6),
                                             frame)))


def test_bilinear_downsample_matches_jax_image_resize():
    """The filter's downsample: F.interpolate(bilinear, align_corners=False,
    antialias=False) is jax.image.resize(bilinear, antialias=False)."""
    rng = np.random.RandomState(10)
    for (h, w), (gh, gw) in [((32, 32), (8, 8)), ((16, 24), (4, 6)),
                             ((30, 20), (6, 5)), ((8, 8), (8, 8))]:
        x = rng.rand(2, 3, h, w).astype(np.float32) * 10
        ref = jax.image.resize(jnp.asarray(x), (2, 3, gh, gw), 'bilinear',
                               antialias=False)
        out = F.interpolate(t(x), size=(gh, gw), mode='bilinear',
                            align_corners=False, antialias=False)
        assert_close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize('hw,methods', [
    ((16, 16), tfilt.ALL_FILTERS), ((16, 16), ('patch_magnitude',)),
    ((16, 16), ('flow_area', 'num_corners')), ((8, 16), tfilt.ALL_FILTERS)])
def test_flow_sample_filter_matches_jax(hw, methods):
    rng = np.random.RandomState(0)
    b, s = 2, 6
    h, w = hw
    npf = (h // 4) * (w // 4)
    flows = (rng.randn(b, 2, h, w, s) * 1.5).astype(np.float32)
    active = np.ones((b, 2 * npf, s), dtype=bool)
    for bi in range(b):
        for si in range(s):
            cell = rng.randint(npf)
            active[bi, npf + cell, si] = False
            if si % 2 == 0:                 # the selected patch moves
                i, j = divmod(cell, w // 4)
                flows[bi, :, 4 * i:4 * i + 4, 4 * j:4 * j + 4, si] += 6.0
    flows[0, :, :, :, 2] += 9.0             # a sample where all moves
    kw = dict(filter_methods=methods, flow_magnitude_threshold=2.0,
              flow_area_threshold=0.5, num_corners_threshold=2)
    jf, jr = jfilt.flow_sample_filter(jnp.asarray(flows), jnp.asarray(active),
                                      **kw)
    tf, tr = tfilt.FlowSampleFilter(**kw)(t(flows), t(active))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert_close(tf.numpy(), jf, 1e-5)
    assert 0 < int(tr.sum()) < b * s or methods != tfilt.ALL_FILTERS


def test_flow_sample_filter_rejects_a_grid_it_cannot_infer():
    flows = torch.zeros(1, 2, 16, 12, 2)
    active = torch.ones(1, 2 * 10, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match='cannot infer a patch grid'):
        tfilt.flow_sample_filter(flows, active)
    with pytest.raises(ValueError, match='cannot infer a patch grid'):
        jfilt.flow_sample_filter(jnp.asarray(flows.numpy()),
                                 jnp.asarray(active.numpy()))
