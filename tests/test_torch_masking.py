"""Port parity: the training mask policy (masking/generators.py). The JAX
package's draws for a key (per-(row, frame) uniform scores and clump pad
offsets, split from the key exactly as the JAX functions split it) are
injected into the port, whose masks must then equal JAX's bitwise."""
import numpy as np
import jax
import pytest
import torch

from counterfactualworldmodels_tpu.masking import generators as jgen
from counterfactualworldmodels_tpu_torch.masking import generators as tgen

from torch_port_common import t


def _jax_draws(key, b, t_frames, h, w, clump):
    """The scores [B, T, gh*gw] and offsets [B, T, 2] that
    jgen.uniform_mask(key, (T, h, w), ..., batch_size=B) draws."""
    ch, cw = (clump, clump)
    n = (h // ch) * (w // cw)
    pad_h, pad_w = h - (h // ch) * ch, w - (w // cw) * cw
    keys = jax.random.split(key, b * t_frames).reshape(b, t_frames, 2)
    scores = np.zeros((b, t_frames, n), np.float32)
    offsets = np.zeros((b, t_frames, 2), np.int64)
    for i in range(b):
        for j in range(t_frames):
            key_sample, key_pad = jax.random.split(keys[i, j])
            scores[i, j] = np.asarray(jax.random.uniform(key_sample, (n,)))
            key_h, key_w = jax.random.split(key_pad)
            if max(ch, cw) > 1 and pad_h:
                offsets[i, j, 0] = int(jax.random.randint(key_h, (), 0,
                                                          pad_h + 1))
            if max(ch, cw) > 1 and pad_w:
                offsets[i, j, 1] = int(jax.random.randint(key_w, (), 0,
                                                          pad_w + 1))
    return scores, offsets


CASES = [((2, 8, 8), 0.9, 1), ((2, 7, 9), 0.75, 2), ((3, 6, 6), 0.5, 2),
         ((2, 5, 5), 0.6, 2)]


@pytest.mark.parametrize('size,ratio,clump', CASES)
def test_uniform_mask_matches_jax_on_its_draws(size, ratio, clump):
    key = jax.random.PRNGKey(11)
    b = 3
    ref = np.asarray(jgen.uniform_mask(key, size, ratio, clump, b))
    scores, offsets = _jax_draws(key, b, *size, clump)
    out = tgen.uniform_mask(size, ratio, clump, b, scores=t(scores),
                            offsets=t(offsets))
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match='scores'):
        tgen.uniform_mask(size, ratio, clump, b + 1, scores=t(scores),
                          offsets=t(offsets))


@pytest.mark.parametrize('size,ratio,clump', CASES)
def test_rotated_table_uniform_mask_matches_jax_on_its_draws(size, ratio,
                                                             clump):
    key = jax.random.PRNGKey(5)
    b = 2
    ref = np.asarray(jgen.rotated_table_uniform_mask(
        key, size, ratio, clumping_factor=clump, batch_size=b))
    _, h, w = size
    # the leading T - 1 frames stay visible: one masked frame is drawn
    scores, offsets = _jax_draws(key, b, 1, h, w, clump)
    out = tgen.rotated_table_uniform_mask(size, ratio, clumping_factor=clump,
                                          batch_size=b, scores=t(scores),
                                          offsets=t(offsets))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_uniform_frame_mask_matches_jax_on_its_draws():
    key = jax.random.PRNGKey(2)
    ref = np.asarray(jgen.uniform_frame_mask(key, 9, 7, 5, 2))
    key_sample, key_pad = jax.random.split(key)
    scores = np.asarray(jax.random.uniform(key_sample, (4 * 3,)))
    key_h, key_w = jax.random.split(key_pad)
    offsets = np.array([int(jax.random.randint(key_h, (), 0, 2)),
                        int(jax.random.randint(key_w, (), 0, 2))])
    out = tgen.uniform_frame_mask(9, 7, 5, 2, scores=t(scores),
                                  offsets=t(offsets))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generator_draws_are_seeded_with_exact_popcounts():
    size, ratio = (2, 7, 9), 0.75

    def draw(seed):
        return tgen.rotated_table_uniform_mask(
            size, ratio, clumping_factor=2, batch_size=4,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    t_frames, h, w = size
    assert not a[:, :h * w].any()
    # each masked frame: the clumped cells plus the uncovered pad border
    cells = int(ratio * (h // 2) * (w // 2)) * 4
    border = h * w - (h // 2) * 2 * (w // 2) * 2
    assert (a[:, h * w:].sum(-1) == cells + border).all()
