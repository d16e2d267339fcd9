"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; weights
are initialised in JAX and carried to the port through the port's weight
bridge (utils/weights.py), so both sides run the same numbers on the CPU.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from counterfactualworldmodels_tpu.models import conjoined as jconj
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import perturbation as jperturb
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.utils import weights

# the tiny configuration of tests/test_fast_vmae.py:_model
SMALL_VMAE = dict(img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
                  encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
                  decoder_depth=2, decoder_num_heads=2, num_frames=2,
                  qkv_bias=True)

# tests/test_segmentation.py's tiny predictor
TINY = dict(img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
            encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
            decoder_depth=1, decoder_num_heads=2, num_frames=2, qkv_bias=True)

# (prefix_pool, suffix_pool, gelu): the exact rung and the pooled rungs
RUNGS = [(1, 1, 'erf'), (2, 2, 'tanh'), (4, 4, 'tanh')]


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def vmae_pair(**kw):
    """(jax model, jax params, port model, port FastParams on the CPU)."""
    cfg = dict(SMALL_VMAE, **kw)
    jm = jvmae.PretrainVisionTransformer(**cfg)
    params = jvmae.init_params(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**cfg)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    fp = tfv.stack_vmae_params(tm, sd, dtype=torch.float32, device='cpu')
    return jm, params, tm, fp


def workload(n_patches, n0, hw, s=3, counts=(5, 5, 5), seed=0):
    """Counterfactual-shaped inputs: x_mocos [S,2,3,H,W] sharing frame 0,
    masks [S,N] with frame 0 visible and counts[i] visible frame-1 tokens."""
    rng = np.random.RandomState(seed)
    n1 = n_patches - n0
    x0 = rng.rand(1, 3, hw, hw).astype(np.float32)
    x1 = x0 + 0.1 * rng.randn(s, 3, hw, hw).astype(np.float32)
    x = np.concatenate([np.repeat(x0[:, None], s, 0), x1[:, None]], axis=1)
    mask = np.ones((s, n_patches), dtype=bool)
    mask[:, :n0] = False
    for i in range(s):
        mask[i, n0 + rng.choice(n1, counts[i], replace=False)] = False
    return x, mask


def jax_uniform_noise(keys, n):
    """The rectangularizer's draws of the JAX package for these keys."""
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (n,), minval=0.0, maxval=0.999))(
            keys))


def assert_close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=rtol)



class JaxDraws:
    """Put the JAX generator's draws in place of the port generator's: one
    key chain from PRNGKey(seed), split at the points where the JAX
    FlowGenerator calls next_key()."""

    def __init__(self, gen, seed=0):
        self.gen = gen
        self.key = jax.random.PRNGKey(seed)
        gen._draw_shifts = self.shifts
        gen._draw_prompt_noise = self.prompt_noise
        gen._draw_mask_noise = self.mask_noise
        gen._draw_patch_indices = self.patch_indices

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def shifts(self, num_samples):
        g = self.gen
        keys = jax.random.split(self.next_key(), num_samples)
        d = jax.vmap(lambda k: jperturb.random_shift(
            k, g.max_shift_fraction, g.x.shape[-2:], g.patch_size))(keys)
        return t(d).long()

    def prompt_noise(self, rows, n):
        return t(jax_uniform_noise(jax.random.split(self.next_key(), rows), n))

    def mask_noise(self, rows, n):
        return t(jax.random.uniform(self.next_key(), (rows, n), minval=0.0,
                                    maxval=0.999))

    def patch_indices(self, p, num_points):
        logits = jnp.log(jnp.clip(jnp.asarray(p.numpy()), min=1e-30))
        idx = jax.random.categorical(self.next_key(), logits, axis=-1,
                                     shape=(num_points, p.shape[0])).T
        return t(idx).long()


# the tiny conjoined model of tests/test_fast_conjoined.py:_tiny
IMG, GRID = 64, 8
N = 2 * GRID * GRID
N0 = N // 2
IMU_LEN, IMU_TOK = 48, 6

_init_conj = jax.jit(jconj.init_conjoined_params, static_argnums=0)


def conj_specs(mod, flavour, enc_cross=((0, 0), (-1, -1)),
               dec_cross=((0, 0), (1, 1))):
    """(main, context, layer pairs) of the tiny conjoined model, with the
    StreamSpec of module ``mod`` (the JAX or the port's conjoined module).
    flavour 'padded': both streams padded, no dummy token; 'dummy': no
    padding, a dummy IMU token."""
    dummy = flavour == 'dummy'
    ctx = mod.StreamSpec(is_imu=True, in_chans=6, sequence_length=IMU_LEN,
                         imu_tubelet=8, encoder_embed_dim=32, encoder_depth=2,
                         encoder_num_heads=4, decoder_embed_dim=24,
                         decoder_depth=2, decoder_num_heads=4,
                         decoder_num_classes=48, mlp_ratio=2.0,
                         concat_dummy_token=dummy, padded=not dummy,
                         max_padding_tokens=0 if dummy else IMU_TOK)
    main = mod.StreamSpec(img_size=(IMG, IMG), patch_size=(8, 8), in_chans=3,
                          num_frames=2, encoder_embed_dim=48, encoder_depth=2,
                          encoder_num_heads=4, decoder_embed_dim=32,
                          decoder_depth=2, decoder_num_heads=4, mlp_ratio=2.0,
                          padded=not dummy,
                          max_padding_tokens=0 if dummy else 8)
    return main, ctx, dict(conjoin_encoder_layers=enc_cross,
                           conjoin_decoder_layers=dec_cross)


@functools.lru_cache(maxsize=None)
def conj_pair(flavour, seed=0, **kw):
    """(JAX model, its params, the port's model on the CPU with them
    loaded, the bridged state dict). Cached: callers do not change them."""
    jm_main, jm_ctx, pairs = conj_specs(jconj, flavour, **kw)
    jm = jconj.ConjoinedVMAE(main=jm_main, context=jm_ctx, **pairs)
    params = _init_conj(jm, jax.random.PRNGKey(seed))
    tm_main, tm_ctx, pairs = conj_specs(tconj, flavour, **kw)
    tm = tconj.ConjoinedVMAE(main=tm_main, context=tm_ctx, device='cpu',
                             **pairs)
    sd = weights.conjoined_state_dict_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, params))
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm, sd


def flow2imu_model(mod):
    """The tiny flow2imu of module ``mod`` (the JAX or the port's conjoined
    module): a 7-channel one-frame main stream (forward + backward flow and
    RGB) and the non-padded IMU context with a dummy token."""
    main = mod.StreamSpec(img_size=(IMG, IMG), patch_size=(8, 8), in_chans=7,
                          num_frames=1, encoder_embed_dim=48, encoder_depth=2,
                          encoder_num_heads=4, decoder_embed_dim=32,
                          decoder_depth=2, decoder_num_heads=4, mlp_ratio=2.0,
                          decoder_num_classes=448)
    _, ctx, pairs = conj_specs(mod, 'dummy')
    kw = {} if mod is jconj else {'device': 'cpu'}
    return mod.ConjoinedVMAE(main=main, context=ctx, **pairs, **kw)


_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


@functools.lru_cache(maxsize=None)
def imu_wrappers(raft_iters):
    """The IMU-conditioned predictor and flow2imu wrappers with their RAFT,
    JAX-initialised and bridged: ((JAX wrapper, JAX flow2imu wrapper, JAX
    RAFT, its params), (the port's three, on the CPU)). Cached."""
    jm, params, tm, sd = conj_pair('padded')
    jf = flow2imu_model(jconj)
    fparams = _init_conj(jf, jax.random.PRNGKey(2))
    tf = flow2imu_model(tconj)
    fsd = weights.conjoined_state_dict_from_jax(
        tf, jax.tree_util.tree_map(np.asarray, fparams))
    jr = jraft.RAFT(iters=raft_iters)
    rp = _init_raft(jr, jax.random.PRNGKey(1), IMG)
    tr = traft.RAFT(iters=raft_iters, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rp)), strict=True)
    f2i = dict(main_input='flowback_rgb01', context_input='imu')
    jw = jconj.ConjoinedPredictorWrapper(jm, params=params,
                                         main_input='rgb01',
                                         context_input='imu')
    jfw = jconj.ConjoinedPredictorWrapper(
        jf, params=fparams, main_input_kwargs={
            'unnormalize': True, 'iters': raft_iters, 'flow_model': jr,
            'flow_params': rp}, **f2i)
    tw = tconj.ConjoinedPredictorWrapper(tm, params=sd, main_input='rgb01',
                                         context_input='imu')
    tfw = tconj.ConjoinedPredictorWrapper(
        tf, params=fsd, main_input_kwargs={
            'unnormalize': True, 'iters': raft_iters, 'flow_model': tr},
        **f2i)
    return (jw, jfw, jr, rp), (tw, tfw, tr)
