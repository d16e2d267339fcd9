"""Port parity: counterfactual prompt construction against the JAX package.

The JAX function builds one sample and is vmapped over the samples; the
port takes the sample axis explicitly and its rectangularizer noise as a
tensor, here the JAX draws themselves. Masks match bitwise and videos
exactly (the edits are selections and 0/1 blends)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.pipelines import perturbation as jpert
from counterfactualworldmodels_tpu_torch.pipelines import perturbation as tpert

from torch_port_common import jax_uniform_noise, t


def _prompts(rng, s, hw, patch, n_passive=6):
    gh = hw // patch
    npf = gh * gh
    n = 2 * npf
    p = np.ones((s, n), dtype=bool)
    p[:, :npf] = False
    a = np.ones((s, n), dtype=bool)
    a[:, :npf] = False
    for i in range(s):
        p[i, npf + rng.choice(npf, n_passive, replace=False)] = False
        a[i, npf + rng.choice(npf, 2, replace=False)] = False
    shifts = rng.randint(-3, 4, size=(s, 2)).astype(np.int32)
    return p, a, shifts, npf


@pytest.mark.parametrize('fix_passive,n_vis_extra', [(True, 7), (False, 4),
                                                     (True, None)])
def test_make_motion_counterfactual_matches_jax(fix_passive, n_vis_extra):
    rng = np.random.RandomState(0)
    s, hw, patch = 5, 32, 4
    x = rng.rand(2, 3, hw, hw).astype(np.float32)
    p, a, shifts, npf = _prompts(rng, s, hw, patch)
    keys = jax.random.split(jax.random.PRNGKey(3), s)
    n_vis = None if n_vis_extra is None else npf + n_vis_extra

    def one(pp, aa, sh, k):
        return jpert.make_motion_counterfactual(
            jnp.asarray(x), pp, aa, sh, k, (1, patch, patch),
            n_vis_target=n_vis, fix_passive=fix_passive)

    jx, jm = jax.vmap(one)(jnp.asarray(p), jnp.asarray(a),
                           jnp.asarray(shifts), keys)
    noise = t(jax_uniform_noise(keys, npf))
    tx, tm = tpert.make_motion_counterfactual(
        t(x), t(p), t(a), t(shifts), noise, (1, patch, patch),
        n_vis_target=n_vis, fix_passive=fix_passive)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if n_vis is not None:
        assert ((~tm).sum(-1) == n_vis).all()


def test_translate2d_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randn(4, 3, 9, 7).astype(np.float32)
    shifts = np.array([[0, 0], [2, -3], [-8, 6], [5, 1]], np.int32)
    out = tpert.translate2d(t(img), t(shifts), 0.5).numpy()
    for i in range(4):
        ref = np.asarray(jpert.translate2d(jnp.asarray(img[i]),
                                           jnp.asarray(shifts[i]), 0.5))
        np.testing.assert_array_equal(out[i], ref)
    m = rng.rand(4, 9, 7) > 0.5
    out_m = tpert.translate2d(t(m), t(shifts), True).numpy()
    for i in range(4):
        ref = np.asarray(jpert.translate2d(jnp.asarray(m[i]),
                                           jnp.asarray(shifts[i]), True))
        np.testing.assert_array_equal(out_m[i], ref)


def test_rectangularize_row_matches_jax():
    rng = np.random.RandomState(2)
    s, n = 6, 40
    rows = rng.rand(s, n) > 0.3
    keys = jax.random.split(jax.random.PRNGKey(4), s)
    quota = rng.randint(3, 20, size=s)
    ref = np.stack([np.asarray(jpert.rectangularize_row(
        keys[i], jnp.asarray(rows[i]), int(quota[i]))) for i in range(s)])
    out = tpert.rectangularize_row(t(jax_uniform_noise(keys, n)), t(rows),
                                   t(quota))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ((~out).sum(-1).numpy() == quota).all()


def test_make_static_movie_and_make_static_match_jax():
    rng = np.random.RandomState(5)
    x = rng.rand(2, 2, 3, 16, 16).astype(np.float32)
    for t_frames, frame in ((2, 0), (3, -1)):
        np.testing.assert_array_equal(
            tpert.make_static_movie(t(x), t_frames, frame).numpy(),
            np.asarray(jpert.make_static_movie(jnp.asarray(x), t_frames,
                                               frame)))
    np.testing.assert_array_equal(
        tpert.make_static_movie(t(x[:, 0]), 2).numpy(),
        np.asarray(jpert.make_static_movie(jnp.asarray(x[:, 0]), 2)))
    for n in (2 * 16, 16):                  # both frames, the last frame
        mask = rng.rand(2, n) > 0.5
        ref = jpert.make_static(jnp.asarray(x), jnp.asarray(mask), 4)
        out = tpert.make_static(t(x), t(mask), 4)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize('with_points', [False, True])
def test_multi_shift_patches_and_mask_matches_jax(with_points):
    rng = np.random.RandomState(6)
    b, s, hw, patch = 2, 3, 16, 4
    npf = (hw // patch) ** 2
    x = rng.rand(b, 2, 3, hw, hw).astype(np.float32)
    masks = rng.rand(b, 2 * npf, s) > 0.4
    points = (rng.rand(b, 2 * npf, s) > 0.8) if with_points else None
    shifts_px = np.array([[4, -8], [3, 5], [-6, 0]], np.int32)
    jx, jm = jpert.multi_shift_patches_and_mask(
        jnp.asarray(x), jnp.asarray(masks),
        None if points is None else jnp.asarray(points),
        jnp.asarray(shifts_px), patch)
    tx, tm = tpert.multi_shift_patches_and_mask(
        t(x), t(masks), None if points is None else t(points), t(shifts_px),
        patch)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)


@pytest.mark.parametrize('fractional', [False, True])
def test_random_shift_rules_match_jax(fractional):
    """The port's shift from the JAX randint draws of a key equals the JAX
    shift for that key: patch units by floor division, a zero shift bumped
    to dx = +1."""
    frac, size, patch = 0.15, (32, 48), (1, 4, 4)
    lo = jnp.asarray([-int(frac * size[0]), -int(frac * size[1])])
    hi = jnp.asarray([int(frac * size[0]) + 1, int(frac * size[1]) + 1])
    keys = jax.random.split(jax.random.PRNGKey(7), 200)
    ref = np.stack([np.asarray(jpert.random_shift(k, frac, size, patch,
                                                  fractional))
                    for k in keys])
    draws = np.stack([np.asarray(jax.random.randint(k, (2,), lo, hi))
                      for k in keys])
    out = tpert.random_shift(frac, size, patch, fractional, draws=t(draws))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not (out == 0).all(-1).any()
    assert (draws == 0).all(-1).any() or not fractional
    got = tpert.random_shift(frac, size, patch, num=50,
                             generator=torch.Generator().manual_seed(0))
    assert got.shape == (50, 2) and not (got == 0).all(-1).any()
    assert int(got[:, 0].abs().max()) <= int(frac * size[0]) // 4 + 1
