"""Port parity: the shared-prefix VMAE engine against the JAX engine.

Same weights (JAX init -> weight bridge) and same inputs on both sides, in
f32 on the CPU; the JAX engine runs with use_flash=False. The port runs
both its dense route and its kernel route (use_flash=True, whose wrappers
take the plain versions on CPU tensors). atol 1e-4: f32 sums over three
encoder and two decoder layers in another order."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import fast_vmae as jfv
from counterfactualworldmodels_tpu.ops.normalization import imagenet_normalize
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv

from torch_port_common import RUNGS, assert_close, t, vmae_pair, workload

ATOL = 1e-4


@pytest.fixture(scope='module')
def pair():
    jm, params, tm, tfp = vmae_pair()
    jfp = jfv.stack_vmae_params(jm, params, dtype=jnp.float32)
    return jm, jfp, tm, tfp


def _inputs(jm, counts=(5, 5, 5), seed=0):
    n0 = jm.num_patches_per_frame
    x, mask = workload(jm.num_patches, n0, jm.img_size[0], s=len(counts),
                       counts=counts, seed=seed)
    return x, mask, n0 + max(counts)


def test_encode_prefix_and_frame1_match_jax(pair):
    jm, jfp, tm, tfp = pair
    x, mask, n_vis = _inputs(jm)
    xn = np.asarray(imagenet_normalize(jnp.asarray(x), temporal_dim=1))
    jc = jfv.encode_prefix(jm, jfp, False, jnp.asarray(xn[0:1, 0]))
    n0 = jm.num_patches_per_frame
    n1 = jm.num_patches - n0
    vis = jfv.pad_vis1_idx(jnp.asarray(mask[:, n0:]),
                           jfv.sfx_bucket(n_vis - n0, n1))
    jy = jfv.predict_frame1_from_prefix(jm, jfp, False, jc,
                                        jnp.asarray(xn[:, 1]), vis)
    for use_flash in (False, True):
        tc = tfv.encode_prefix(tm, tfp, use_flash, t(xn[0:1, 0]))
        for jt, tt in zip(jax.tree_util.tree_leaves(tuple(jc)),
                          [tc.enc_kvs[0], tc.enc_kvs[1], tc.dec_kvs[0],
                           tc.dec_kvs[1]]):
            assert tuple(tt.shape) == jt.shape
            assert_close(tt.numpy(), jt, ATOL)
        np.testing.assert_array_equal(
            tfv.pad_vis1_idx(t(mask[:, n0:]),
                             tfv.sfx_bucket(n_vis - n0, n1)).numpy(),
            np.asarray(vis))
        ty = tfv.predict_frame1_from_prefix(tm, tfp, use_flash, tc,
                                            t(xn[:, 1]), t(vis).long(),
                                            two_source=use_flash)
        assert_close(ty.numpy(), jy, ATOL)


@pytest.mark.parametrize('rung', RUNGS, ids=['exact', 'pool2', 'pool4'])
def test_predict_videos_matches_jax_at_rung(pair, rung):
    jm, jfp, tm, tfp = pair
    pp, sp, gelu = rung
    x, mask, n_vis = _inputs(jm, seed=1)
    ref = np.asarray(jfv.predict_videos_shared_prefix(
        jm, jfp, False, n_vis, True, jnp.asarray(x), jnp.asarray(mask),
        prefix_pool=pp, suffix_pool=sp, gelu=gelu))
    for use_flash in (False, True):
        out = tfv.predict_videos_shared_prefix(
            tm, tfp, use_flash, n_vis, True, t(x), t(mask),
            two_source=use_flash, prefix_pool=pp, suffix_pool=sp, gelu=gelu)
        assert_close(out.numpy(), ref, ATOL)


def test_ragged_bucketed_rows_match_jax(pair):
    """Rows with 2, 3 and 5 visible frame-1 tokens share one bucket of 8:
    pad keys stay neutral and pad rows are dropped at the scatter."""
    jm, jfp, tm, tfp = pair
    x, mask, n_vis = _inputs(jm, counts=(2, 3, 5), seed=7)
    n0 = jm.num_patches_per_frame
    assert tfv.sfx_bucket(n_vis - n0, jm.num_patches - n0) == 8
    ref = np.asarray(jfv.predict_videos_shared_prefix(
        jm, jfp, False, n_vis, True, jnp.asarray(x), jnp.asarray(mask)))
    out = tfv.predict_videos_shared_prefix(tm, tfp, True, n_vis, True, t(x),
                                           t(mask), two_source=True)
    assert_close(out.numpy(), ref, ATOL)


def test_zero_suffix_prompt_matches_jax(pair):
    """Frame 1 fully masked: no suffix tokens, mask-token decoder rows."""
    jm, jfp, tm, tfp = pair
    x, mask, _ = _inputs(jm, counts=(0, 0))
    n0 = jm.num_patches_per_frame
    ref = np.asarray(jfv.predict_videos_shared_prefix(
        jm, jfp, False, n0, True, jnp.asarray(x), jnp.asarray(mask)))
    out = tfv.predict_videos_shared_prefix(tm, tfp, True, n0, True, t(x),
                                           t(mask), two_source=True)
    assert_close(out.numpy(), ref, ATOL)
    assert_close(out[0].numpy(), out[1].numpy(), 1e-6)


def test_rejects_frame0_masks_and_model_knobs(pair):
    jm, jfp, tm, tfp = pair
    x, mask, n_vis = _inputs(jm, counts=(4, 4))
    n0 = jm.num_patches_per_frame
    mask[:, 0] = True
    mask[:, n0 + np.where(mask[0, n0:])[0][0]] = False
    with pytest.raises(ValueError, match='frame 0'):
        tfv.predict_videos_shared_prefix(tm, tfp, False, n_vis, True, t(x),
                                         t(mask))
    import dataclasses
    for knob in (dict(qk_scale=0.5), dict(use_learnable_pos_emb=True)):
        with pytest.raises(ValueError):
            tfv.stack_vmae_params(dataclasses.replace(tm, **knob), {},
                                  device='cpu')


def test_dense_attention_prefix_zero_width_own_panel():
    rng = np.random.RandomState(0)
    q = t(rng.randn(2, 2, 3, 4).astype(np.float32))
    k0 = t(rng.randn(1, 2, 5, 4).astype(np.float32))
    v0 = t(rng.randn(1, 2, 5, 4).astype(np.float32))
    z = torch.zeros(2, 2, 0, 4)
    out = tfv._dense_attention_prefix(q, k0, v0, z, z)
    ref = jfv._dense_attention_prefix(*(jnp.asarray(a.numpy()) for a in
                                        (q, k0, v0, z, z)))
    assert_close(out.numpy(), ref, 1e-5)


def test_resolvers_match_jax():
    for grid in (8, 16, 28, 56):
        for args in (('auto', 'auto', 'auto'), (2, 1, 'erf'), (4, 4, None)):
            assert (tfv.resolve_pools(grid, grid, *args)
                    == jfv.resolve_pools(grid, grid, *args))
    for n in (0, 1, 4, 5, 17, 33, 100, 3136):
        assert tfv.sfx_bucket(n, 3136) == jfv.sfx_bucket(n, 3136)
        assert tfv.sfx_bucket(n, 20) == jfv.sfx_bucket(n, 20)
    for uf in (False, True):
        for ts in (None, False, True):
            assert (tfv.resolve_two_source(uf, ts)
                    == jfv.resolve_two_source(uf, ts))
