"""Port parity: the rest of masking/generators.py (tube, rotated-table and
forward-backward policies, the full-mask and IMU generators, the mixed
generators, the three-frame policy and their class wrappers). The JAX
package's draws for a key, split from it as the JAX functions split it,
are injected into the port, whose masks must then equal JAX's bitwise."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.masking import generators as jgen
from counterfactualworldmodels_tpu_torch.masking import generators as tgen

from test_torch_masking import _jax_draws
from torch_port_common import t


def _draws(key, b, frames, h, w, clump=1):
    scores, offsets = _jax_draws(key, b, frames, h, w, clump)
    return t(scores), t(offsets)


@pytest.mark.parametrize('size,ratio,clump', [((3, 8, 8), 0.75, 1),
                                              ((2, 7, 9), 0.5, 2)])
def test_tube_and_rotated_table_masks_match_jax(size, ratio, clump):
    key = jax.random.PRNGKey(3)
    b = 3
    _, h, w = size
    scores, offsets = _draws(key, b, 1, h, w, clump)
    ref = np.asarray(jgen.tube_mask(key, size, ratio, clump, b))
    out = tgen.tube_mask(size, ratio, clump, b, scores=scores[:, 0],
                         offsets=offsets[:, 0])
    np.testing.assert_array_equal(out.numpy(), ref)
    ref = np.asarray(jgen.rotated_table_mask(key, size, ratio, None, clump,
                                             b))
    out = tgen.rotated_table_mask(size, ratio, None, clump, b,
                                  scores=scores[:, 0], offsets=offsets[:, 0])
    np.testing.assert_array_equal(out.numpy(), ref)
    # the class wrappers pass the draws through
    for jcls, tcls in ((jgen.TubeMaskingGenerator, tgen.TubeMaskingGenerator),
                       (jgen.RotatedTableMaskingGenerator,
                        tgen.RotatedTableMaskingGenerator)):
        jg = jcls(input_size=size, mask_ratio=ratio, clumping_factor=clump)
        tg = tcls(input_size=size, mask_ratio=ratio, clumping_factor=clump,
                  device='cpu')
        x = np.zeros((b, 1))
        np.testing.assert_array_equal(
            tg(x, scores=scores[:, 0], offsets=offsets[:, 0]).numpy(),
            np.asarray(jg(x, key=key)))


@pytest.mark.parametrize('ctx_ratio', [None, 0.25])
def test_forward_backward_rotated_table_matches_jax(ctx_ratio):
    key = jax.random.PRNGKey(4)
    b, size = 4, (3, 6, 6)
    ref = np.asarray(jgen.forward_backward_rotated_table_mask(
        key, size, 0.75, ctx_ratio, 1, 0.5, b))
    key_m, key_v, key_f = jax.random.split(key, 3)
    sm, om = _draws(key_m, b, 2, 6, 6)
    sv, ov = _draws(key_v, b, 1, 6, 6)
    flips = t(jax.random.uniform(key_f, (b, 1)))
    draws = dict(scores=sm, offsets=om, context_scores=sv,
                 context_offsets=ov, flips=flips)
    out = tgen.forward_backward_rotated_table_mask(size, 0.75, ctx_ratio, 1,
                                                   0.5, b, **draws)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0 < int((flips < 0.5).sum()) < b     # both directions occur
    jg = jgen.ForwardBackwardRotatedTableMaskingGenerator(
        input_size=size, mask_ratio=0.75, context_mask_ratio=ctx_ratio)
    tg = tgen.ForwardBackwardRotatedTableMaskingGenerator(
        input_size=size, mask_ratio=0.75, context_mask_ratio=ctx_ratio,
        device='cpu')
    x = np.zeros((b, 1))
    np.testing.assert_array_equal(tg(x, **draws).numpy(),
                                  np.asarray(jg(x, key=key)))


@pytest.mark.parametrize('full_mask_prob', [0.0, 0.5])
def test_rotated_table_uniform_generator_matches_jax(full_mask_prob):
    key = jax.random.PRNGKey(5)
    b, size = 6, (2, 8, 8)
    jg = jgen.RotatedTableUniformMaskingGenerator(
        input_size=size, mask_ratio=0.9, full_mask_prob=full_mask_prob)
    tg = tgen.RotatedTableUniformMaskingGenerator(
        input_size=size, mask_ratio=0.9, full_mask_prob=full_mask_prob,
        device='cpu')
    key_m, key_f = jax.random.split(key)
    scores, offsets = _draws(key_m, b, 1, 8, 8)
    full = t(jax.random.uniform(key_f, (b, 1)))
    x = np.zeros((b, 1))
    out = tg(x, scores=scores, offsets=offsets, full_draws=full)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jg(x, key=key)))
    assert out[:, :64].logical_not().all()


@pytest.mark.parametrize('per_example', [False, True])
@pytest.mark.parametrize('probs', [(0.2, 0.0), (0.5, 0.5), (0.0, 0.0)])
def test_full_mask_generators_match_jax(per_example, probs):
    """FullMaskGenerator on a (T, H, W) grid and ImuFullMaskGenerator on an
    L-token stream, over several keys (so each branch of the full-mask
    draw occurs)."""
    fm, fv = probs
    for jcls, tcls, size in (
            (jgen.FullMaskGenerator, tgen.FullMaskGenerator, (2, 4, 4)),
            (jgen.ImuFullMaskGenerator, tgen.ImuFullMaskGenerator, 25)):
        kw = dict(full_mask_prob=fm, full_vis_prob=fv,
                  full_mask_per_example=per_example, input_size=size,
                  mask_ratio=0.5)
        jg = jcls(**kw)
        tg = tcls(device='cpu', **kw)
        b = 5
        x = np.zeros((b, 1))
        grid = (size[0], size[1], size[2]) if isinstance(size, tuple) \
            else (1, 1, size)
        for seed in range(6):
            key = jax.random.PRNGKey(seed)
            key_m, key_a, key_b = jax.random.split(key, 3)
            scores, offsets = _draws(key_m, b, *grid)
            if per_example:
                full = t(jax.random.uniform(key_a, (b, 1)))
            else:
                full = t(jnp.stack([jax.random.uniform(key_a, ()),
                                    jax.random.uniform(key_b, ())]))
            np.testing.assert_array_equal(
                tg(x, scores=scores, offsets=offsets,
                   full_draws=full).numpy(),
                np.asarray(jg(x, key=key)), err_msg=f'{size} {seed}')


@pytest.mark.parametrize('mode', ['none', 'max', 'min'])
def test_missing_data_imu_mask_generator_matches_jax(mode):
    """The masks united with the missing-data indicator, then
    rectangularized (its draws from the generator's own key chain)."""
    b, n = 4, 25
    rng = np.random.RandomState(1)
    missing = rng.rand(b, n) > 0.7
    key = jax.random.PRNGKey(9)
    jg = jgen.MissingDataImuMaskGenerator(
        truncation_mode=mode, input_size=n, mask_ratio=0.3,
        full_mask_prob=0.0, full_vis_prob=0.0, seed=2)
    tg = tgen.MissingDataImuMaskGenerator(
        truncation_mode=mode, input_size=n, mask_ratio=0.3,
        full_mask_prob=0.0, full_vis_prob=0.0, seed=2, device='cpu')
    ref = np.asarray(jg(jnp.asarray(missing), key=key))
    key_m, key_a, key_b = jax.random.split(key, 3)
    scores, offsets = _draws(key_m, b, 1, 1, n)
    full = t(jnp.stack([jax.random.uniform(key_a, ()),
                        jax.random.uniform(key_b, ())]))
    rect_key = jax.random.split(jax.random.PRNGKey(2))[1]
    noise = t(jax.random.uniform(rect_key, (b, n), minval=0.0,
                                 maxval=0.999))
    out = tg(t(missing), scores=scores, offsets=offsets, full_draws=full,
             rect_noise=noise)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy() >= missing).all() or mode != 'none'
    assert tg(None, scores=scores[:1], offsets=offsets[:1],
              full_draws=full).shape == (1, n)


def test_mixed_generators():
    """MixedMaskGenerator min-combines its generators (JAX's on one key);
    MixedClumpingMaskingGenerator picks a sub-generator per row from its
    choices; the rotated-table variant keeps frame 0 visible."""
    key = jax.random.PRNGKey(6)
    size, b = (2, 8, 8), 3
    jmix = jgen.MixedMaskGenerator(
        [jgen.MaskingGenerator(size, 0.5), jgen.MaskingGenerator(size, 0.5)],
        [0.5, 0.75])
    tmix = tgen.MixedMaskGenerator(
        [tgen.MaskingGenerator(size, 0.5, device='cpu'),
         tgen.MaskingGenerator(size, 0.5, device='cpu')], [0.5, 0.75])
    scores, offsets = _draws(key, b, 2, 8, 8)
    x = np.zeros((b, 1))
    out = tmix(x, scores=scores, offsets=offsets)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jmix(x, key=key)))
    assert out.dtype == torch.bool

    kw = dict(input_size=size, mask_ratio=0.5, clumping_factor=(1, 2),
              seed=4, device='cpu')
    gen = tgen.MixedClumpingMaskingGenerator(**kw)
    ref = tgen.MixedClumpingMaskingGenerator(**kw)
    choices = [1, 0, 1]
    out = gen(torch.zeros(3, 1), choices=choices)
    rows = [ref.generators[c](torch.zeros(1, 1)) for c in choices]
    np.testing.assert_array_equal(out.numpy(), torch.cat(rows).numpy())
    assert gen(None).shape == (1, 128)
    rt = tgen.RotatedTableMixedClumpingMaskingGenerator(**kw)
    m = rt(torch.zeros(4, 1))
    assert m.shape == (4, 128) and not m[:, :64].any()
    assert m[:, 64:].sum(-1).tolist() == [32] * 4


@pytest.mark.parametrize('independent,fully_visible', [
    (True, False), (False, False), (True, True)])
def test_three_frame_masks_match_jax(independent, fully_visible):
    key = jax.random.PRNGKey(8)
    b, size = 4, (3, 5, 6)
    ref = np.asarray(jgen.three_frame_forward_backward_mask(
        key, size, 0.6, independent, fully_visible, b))
    key_p, key_m = jax.random.split(key)
    q = jax.random.uniform(key_p, (b,) if independent else (1,))
    keys = jax.random.split(key_m, b * 3).reshape(b, 3, 2)
    scores = np.stack([[np.asarray(jax.random.uniform(keys[i, j], (30,)))
                        for j in range(3)] for i in range(b)])
    out = tgen.three_frame_forward_backward_mask(
        size, 0.6, independent, fully_visible, b, q=t(q), scores=t(scores))
    np.testing.assert_array_equal(out.numpy(), ref)
    jg = jgen.ThreeFrameForwardBackwardMasking((5, 6), 0.6, independent,
                                               fully_visible)
    tg = tgen.ThreeFrameForwardBackwardMasking((5, 6), 0.6, independent,
                                               fully_visible, device='cpu')
    x = np.zeros((b, 1))
    np.testing.assert_array_equal(tg(x, q=t(q), scores=t(scores)).numpy(),
                                  np.asarray(jg(x, key=key)))
    drawn = tg(x)
    assert drawn.shape == (b, 90)
    assert drawn.reshape(b, 3, 30)[:, 1].sum(-1).tolist() == [18] * b
    with pytest.raises(ValueError, match='T = 3'):
        tgen.three_frame_forward_backward_mask((2, 5, 6), 0.6)


def test_uniform_generator_alias_and_class_draws():
    """UniformMaskingGenerator is MaskingGenerator; every class wrapper
    draws from its own Generator when no draws are given, reproducibly
    after reset."""
    g = tgen.UniformMaskingGenerator((2, 4, 4), 0.5, seed=3, device='cpu')
    a = g(torch.zeros(2, 1))
    g.reset()
    np.testing.assert_array_equal(g(torch.zeros(2, 1)).numpy(), a.numpy())
    for cls in (tgen.TubeMaskingGenerator, tgen.RotatedTableMaskingGenerator,
                tgen.RotatedTableUniformMaskingGenerator,
                tgen.ForwardBackwardRotatedTableMaskingGenerator,
                tgen.FullMaskGenerator):
        m = cls(input_size=(2, 4, 4), mask_ratio=0.5, device='cpu')(
            torch.zeros(3, 1))
        assert m.shape == (3, 32) and m.dtype == torch.bool
