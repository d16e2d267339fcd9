"""Port parity: ops/misc.py against the JAX package's ops/misc.py on the
CPU, every function, on seeded numpy inputs; within 1e-5 (1e-4 for the
bilinear soft index, as the JAX package's own test allows), the one-hot
circular targets and the boolean outputs exactly."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.ops import misc as jm
from counterfactualworldmodels_tpu_torch.ops import misc as tm

from torch_port_common import assert_close, t


def both(fn_name, *arrays, atol=1e-5, **kw):
    """fn(*arrays, **kw) in both packages, compared."""
    j = getattr(jm, fn_name)(*[jnp.asarray(a) for a in arrays], **kw)
    p = getattr(tm, fn_name)(*[t(a) for a in arrays], **kw)
    assert tuple(p.shape) == tuple(np.shape(j)), fn_name
    assert_close(p.numpy(), np.asarray(j), atol)
    return p, j


def test_spatial_moments_from_local_dist():
    rng = np.random.RandomState(0)
    both('spatial_moments_from_local_dist',
         rng.rand(2, 9, 6, 5).astype(np.float32))
    both('spatial_moments_from_local_dist',
         rng.rand(2, 3, 16, 4, 4).astype(np.float32))
    both('spatial_moments_from_local_dist',
         rng.rand(2, 1, 25, 4, 4).astype(np.float32), squeeze=False)


@pytest.mark.parametrize('normalize', [True, False])
def test_get_distribution_centroid(normalize):
    rng = np.random.RandomState(1)
    both('get_distribution_centroid',
         rng.rand(2, 3, 1, 8, 7).astype(np.float32), normalize=normalize)


@pytest.mark.parametrize('scale', [True, False])
def test_soft_index(scale):
    rng = np.random.RandomState(2)
    ims = rng.rand(2, 3, 10, 12).astype(np.float32)
    if scale:
        inds = rng.uniform(-1.2, 1.2, (2, 5, 2)).astype(np.float32)
    else:
        inds = np.stack([rng.uniform(-1, 10, (2, 5)),
                         rng.uniform(0, 12, (2, 5))], -1).astype(np.float32)
    inds[0, 0] = [3.0, 4.0] if not scale else [0.0, 0.5]   # on the grid
    both('soft_index', ims, inds, scale_by_imsize=scale, atol=1e-4)


@pytest.mark.parametrize('name', ['channel_mse', 'channel_l1error',
                                  'channel_l2error', 'l1_loss', 'l2_loss',
                                  'charbonnier_loss'])
def test_elementwise_errors(name):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4, 4).astype(np.float32)
    y = rng.randn(2, 3, 4, 4).astype(np.float32)
    both(name, x, y)


@pytest.mark.parametrize('backward', [False, True])
def test_max_delta_error(backward):
    rng = np.random.RandomState(4)
    both('max_delta_error', rng.randn(2, 3, 4, 4).astype(np.float32),
         rng.randn(2, 3, 4, 4).astype(np.float32), backward=backward)


@pytest.mark.parametrize('loss', ['l1_loss', 'l2_loss', 'charbonnier_loss'])
def test_masked_per_pixel_loss(loss):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    y = rng.randn(2, 3, 6, 6).astype(np.float32)
    mask = (rng.rand(2, 1, 6, 6) > 0.4).astype(np.float32)
    j = jm.masked_per_pixel_loss(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(mask), getattr(jm, loss))
    p = tm.masked_per_pixel_loss(t(x), t(y), t(mask), getattr(tm, loss))
    assert_close(p.numpy(), np.asarray(j), 1e-5)
    j = jm.masked_per_pixel_loss(jnp.asarray(x), jnp.asarray(y), None)
    p = tm.masked_per_pixel_loss(t(x), t(y), None)
    assert_close(p.numpy(), np.asarray(j), 1e-5)


@pytest.mark.parametrize('with_logits', [False, True])
def test_masked_bce_loss(with_logits):
    rng = np.random.RandomState(6)
    logits = (rng.randn(2, 1, 5, 5) * 3 if with_logits
              else rng.rand(2, 1, 5, 5)).astype(np.float32)
    labels = (rng.rand(2, 1, 5, 5) > 0.5).astype(np.float32)
    mask = (rng.rand(2, 1, 5, 5) > 0.3).astype(np.float32)
    both('masked_bce_loss', logits, labels, mask, with_logits=with_logits)


def test_weighted_softmax_and_kl_div():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 6).astype(np.float32)
    m = (rng.rand(3, 6) > 0.3).astype(np.float32)
    both('weighted_softmax', x, m)
    logits = rng.randn(2, 4, 3, 5).astype(np.float32)
    labels = rng.rand(2, 4, 3, 5).astype(np.float32)
    labels[:, 1] = 0.0                               # 0 log 0 = 0
    mask = (rng.rand(2, 4, 3, 5) > 0.3).astype(np.float32)
    mask[1, :, 0, 0] = 0.0                           # a fully masked pixel
    both('masked_kl_div_loss', logits, labels, mask)


@pytest.mark.parametrize('seq', [1, 3], ids=['one', 'sequence'])
def test_masked_sequence_loss(seq):
    rng = np.random.RandomState(8)
    preds = [rng.randn(2, 2, 4, 4).astype(np.float32) for _ in range(seq)]
    labels = rng.randn(2, 2, 4, 4).astype(np.float32)
    mask = (rng.rand(2, 1, 4, 4) > 0.5).astype(np.float32)
    jp = [jnp.asarray(p) for p in preds]
    tp = [t(p) for p in preds]
    j = jm.masked_sequence_loss(jp if seq > 1 else jp[0],
                                jnp.asarray(labels), jnp.asarray(mask),
                                gamma=0.7)
    p = tm.masked_sequence_loss(tp if seq > 1 else tp[0], t(labels),
                                t(mask), gamma=0.7)
    assert_close(p.numpy(), np.asarray(j), 1e-5)
    j = jm.masked_sequence_loss(
        jp, jnp.asarray(labels), jnp.asarray(mask),
        loss_func=functools.partial(jm.masked_per_pixel_loss,
                                    loss_fn=jm.charbonnier_loss))
    p = tm.masked_sequence_loss(
        tp, t(labels), t(mask),
        loss_func=functools.partial(tm.masked_per_pixel_loss,
                                    loss_fn=tm.charbonnier_loss))
    assert_close(p.numpy(), np.asarray(j), 1e-5)


@pytest.mark.parametrize('value_thresh', [0.0, None])
def test_confidence_thresh_samples(value_thresh):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, 4).astype(np.float32)
    if value_thresh is None:
        x = (x > 0).astype(np.float32)
    j = jm.confidence_thresh_samples(jnp.asarray(x), value_thresh, 0.5)
    p = tm.confidence_thresh_samples(t(x), value_thresh, 0.5)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    xs = [x[..., i] for i in range(4)]
    j = jm.confidence_thresh_samples([jnp.asarray(v) for v in xs], 0.1)
    p = tm.confidence_thresh_samples([t(v) for v in xs], 0.1)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize('form', ['image', 'flat', 'channels'])
def test_get_local_neighbors(form):
    """Every window value, the padding value beyond the image included."""
    rng = np.random.RandomState(10)
    im = rng.randn(2, 3, 5, 6).astype(np.float32)
    if form == 'flat':
        im, kw = im[:, 0].reshape(2, 30), dict(size=(5, 6))
    elif form == 'channels':
        im, kw = im.reshape(2, 3, 30), dict(size=(5, 6))
    else:
        kw = {}
    for radius, invalid, to_image in ((1, -1.0, True), (2, 0.0, False),
                                      (3, -1.0, False)):
        both('get_local_neighbors', im, radius=radius, invalid=invalid,
             to_image=to_image, **kw)


@pytest.mark.parametrize('radius', [0, 1, 2])
def test_get_patches(radius):
    rng = np.random.RandomState(11)
    both('get_patches', rng.randn(2, 3, 5, 4).astype(np.float32),
         radius=radius)
    both('get_patches', rng.randn(2, 2, 3, 4, 4).astype(np.float32),
         radius=radius)


@pytest.mark.parametrize('beta', [10.0, None], ids=['soft', 'one-hot'])
def test_circular_targets(beta):
    rng = np.random.RandomState(12)
    moments = rng.randn(2, 2, 4, 5).astype(np.float32)
    moments[0, :, 0, 0] = 0.0                        # no direction: a tie
    moments[1, :, 1, 1] = [1.0, 1.0]                 # on a diagonal
    both('spatial_moments_to_circular_target', moments, beta=beta)
    target = rng.rand(2, 8, 3, 3).astype(np.float32)
    both('circular_target_to_spatial_moment', target)
    with pytest.raises(ValueError):
        tm.circular_target_to_spatial_moment(t(target[:, :5]))


@pytest.mark.parametrize('to_circle', [False, True])
def test_estimate_boundary_orientations(to_circle):
    rng = np.random.RandomState(13)
    boundaries = (rng.rand(2, 1, 8, 8) > 0.7).astype(np.float32)
    energy = rng.rand(2, 1, 8, 8).astype(np.float32)
    both('estimate_boundary_orientations', boundaries, energy, radius=2,
         to_circle=to_circle)


def test_compute_local_effects_and_local_average():
    rng = np.random.RandomState(14)
    source = rng.randn(2, 3, 6, 5).astype(np.float32)
    adj = rng.rand(2, 9, 6, 5).astype(np.float32)
    both('compute_local_effects', source, adj)
    values = rng.randn(2, 1, 6, 5).astype(np.float32)
    excluded = (rng.rand(2, 1, 6, 5) > 0.6).astype(np.float32)
    both('local_average', values, excluded, radius=1)
    both('local_average', values, excluded, radius=2)
    with pytest.raises(ValueError):
        tm.compute_local_effects(t(source), t(adj[:, :8]))


def test_get_mask_boundaries():
    rng = np.random.RandomState(15)
    masks = np.zeros((2, 3, 8, 8), np.float32)
    masks[:, 0, 2:6, 2:6] = 1.0
    masks[:, 1] = rng.rand(2, 8, 8) > 0.5
    masks[:, 2, :3] = 0.7
    p, _ = both('get_mask_boundaries', masks)
    assert float(p.sum()) > 0


def test_every_function_is_ported():
    names = {n for n, v in vars(jm).items()
             if callable(v) and getattr(v, '__module__', '') == jm.__name__}
    assert names <= set(vars(tm)), names - set(vars(tm))
    assert len(names) >= 25
    assert all(not isinstance(v, torch.nn.Module) for v in vars(tm).values())
