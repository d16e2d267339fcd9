"""Port parity: the ChannelMAE and conjoined train steps
(training/train.make_cmae_train_step, make_conjoined_train_step) against
the JAX package's, from the same JAX-initialised weights (bridged by
utils/weights) on the same inputs and masks: the port with remat off,
True and 'dots' and with accum_steps=2 against JAX's step (remat changes
no value; each JAX step is compiled once, which is most of this file's
time), and Adam's first moment in bf16 against optax's.

Tolerances (tests/test_torch_train.py's): the loss and the gradient norm
at every step rtol 1e-4; the parameters after three steps atol 1e-4."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from counterfactualworldmodels_tpu.models import cmae as jcmae
from counterfactualworldmodels_tpu.models import conjoined as jconj
from counterfactualworldmodels_tpu.training import train as JT
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models import cmae as tcmae
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.training import train as TT
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import IMU_LEN, IMG, _init_conj, t

OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
PART, PATCH = (1, 2), 8
CMAE = dict(image_size=(32, 32), patch_size=(PATCH, PATCH), in_channels=3,
            channel_partition=PART, encoder_embed_dim=48, encoder_depth=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_depth=1,
            decoder_num_heads=4, mlp_ratio=2.0, qkv_bias=True)


def _close_dicts(got, ref, atol):
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   ref[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def _mu(mu):
    return (jnp.bfloat16, torch.bfloat16) if mu else (None, None)


@pytest.fixture(scope='module')
def cmae_setup():
    jm = jcmae.ChannelMae(**CMAE)
    rng = np.random.RandomState(0)
    xs = [rng.rand(4, 3, 32, 32).astype(np.float32) for _ in range(3)]
    masks = []
    for i in range(3):
        m, counts = jcmae.group_uniform_mask(jax.random.PRNGKey(10 + i),
                                             jm.mask_size, 0.75, 4)
        masks.append(np.asarray(m))
    n_vis = masks[0].shape[1] - sum(counts)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(xs[0]), masks[0], n_vis,
                                     counts, method=jm.forward_groups))
    params = init(jax.random.PRNGKey(0))['params']
    return jm, params, xs, masks, n_vis, counts


def _cmae_sd(params):
    return weights.channel_mae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), PART, (PATCH, PATCH))


@pytest.fixture(scope='module')
def cmae_reference(cmae_setup):
    """JAX's three steps (remat off, one microbatch; remat changes no
    value) with an f32 and with a bf16 first moment: per mu dtype the
    per-step metrics and the final parameters."""
    jm, params, xs, masks, n_vis, counts = cmae_setup
    out = {}
    for mu in (False, True):
        jopt = JT.make_optimizer(**OPT, mu_dtype=_mu(mu)[0])
        jstate = JT.TrainState(jnp.zeros((), jnp.int32), params,
                               jopt.init(params))
        jstep = jax.jit(JT.make_cmae_train_step(jm, jopt, n_vis, counts,
                                                remat=False))
        metrics = []
        for x, m in zip(xs, masks):
            jstate, met = jstep(jstate, jnp.asarray(x), jnp.asarray(m))
            metrics.append(met)
        out[mu] = (metrics, jstate.params)
    return out


@pytest.mark.parametrize('remat,accum,mu', [
    (False, 1, False), (True, 1, False), ('dots', 1, False), (True, 2, False),
    ('dots', 1, True)])
def test_cmae_three_train_steps_match_jax(cmae_setup, cmae_reference, remat,
                                          accum, mu):
    jm, params, xs, masks, n_vis, counts = cmae_setup
    ref_metrics, ref_params = cmae_reference[mu]
    model = tcmae.ChannelMae(**CMAE, attn_impl='flash', device='cpu')
    model.load_state_dict(_cmae_sd(params), strict=True)
    opt = TT.make_optimizer(**OPT, mu_dtype=_mu(mu)[1])
    state = TT.TrainState(0, model, opt.init(model.parameters()))
    step = TT.make_cmae_train_step(model, opt, n_vis, counts, remat=remat,
                                   accum_steps=accum)
    before = dict(kernels.LAUNCHES)
    for x, m, jmet in zip(xs, masks, ref_metrics):
        state, met = step(state, t(x), t(m))
        for key in ('loss', 'grad_norm'):
            assert math.isclose(float(met[key]), float(jmet[key]),
                                rel_tol=1e-4), (key, state.step)
    assert state.step == 3
    assert kernels.LAUNCHES == before        # the CPU runs the plain versions
    _close_dicts(dict(model.state_dict()), _cmae_sd(ref_params), atol=1e-4)
    if mu:
        moments = [s['exp_avg'] for s in state.opt_state.state.values()]
        assert moments and all(m.dtype == torch.bfloat16 for m in moments)


def test_keyed_cmae_step_draws_masks_from_a_generator(cmae_setup):
    jm, params, xs, masks, n_vis, counts = cmae_setup
    model = tcmae.ChannelMae(**CMAE, attn_impl='dense', device='cpu')
    opt = TT.make_optimizer(**OPT)
    state = TT.init_cmae_train_state(model, opt, seed=1)
    step = TT.make_cmae_train_step(
        model, opt, n_vis, counts, remat=False,
        mask_fn=lambda g, b: tcmae.group_uniform_mask(
            g, model.mask_size, 0.75, b)[0])
    state, met = step(state, t(xs[0]), torch.Generator().manual_seed(0))
    assert state.step == 1 and torch.isfinite(met['loss'])
    assert float(met['grad_norm']) > 0


def test_adamw_bf16_first_moment_matches_optax():
    """AdamWMixed against optax.adamw(mu_dtype=bfloat16) over 6 updates of
    one parameter vector, the stored bf16 moment bitwise."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(300).astype(np.float32)
    grads = [rng.randn(300).astype(np.float32) for _ in range(6)]
    tx = optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.05,
                     mu_dtype=jnp.bfloat16)
    p, s = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    update = jax.jit(tx.update)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TT.AdamWMixed([tp], betas=(0.9, 0.95), weight_decay=0.05,
                        mu_dtype=torch.bfloat16)
    for g in grads:
        u, s = update(jnp.asarray(g), s, p)
        p = optax.apply_updates(p, u)
        tp.grad = torch.from_numpy(g)
        opt.param_groups[0]['lr'] = 1e-2
        opt.step()
        mu = opt.state[tp]['exp_avg']
        assert mu.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mu.float().numpy(), np.asarray(s[0].mu.astype(jnp.float32)))
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p),
                                   atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match='mu_dtype'):
        TT.AdamWMixed([tp], mu_dtype=torch.int32)


def _conj_model(mod, **kw):
    """A one-layer-per-stack conjoined model (the tiny one of
    torch_port_common with depth 1 and one cross pair each side: both
    streams padded, the IMU context without a dummy token)."""
    ctx = mod.StreamSpec(is_imu=True, in_chans=6, sequence_length=IMU_LEN,
                         imu_tubelet=8, encoder_embed_dim=32, encoder_depth=1,
                         encoder_num_heads=4, decoder_embed_dim=24,
                         decoder_depth=1, decoder_num_heads=4,
                         decoder_num_classes=48, mlp_ratio=2.0,
                         concat_dummy_token=False, padded=True,
                         max_padding_tokens=6)
    main = mod.StreamSpec(img_size=(IMG, IMG), patch_size=(8, 8), in_chans=3,
                          num_frames=2, encoder_embed_dim=48, encoder_depth=1,
                          encoder_num_heads=4, decoder_embed_dim=32,
                          decoder_depth=1, decoder_num_heads=4, mlp_ratio=2.0,
                          padded=True, max_padding_tokens=8)
    return mod.ConjoinedVMAE(main=main, context=ctx,
                             conjoin_encoder_layers=((0, 0),),
                             conjoin_decoder_layers=((0, 0),), **kw)


@pytest.fixture(scope='module')
def conj_setup():
    """The models, JAX's initial weights, three batches and JAX's three
    steps (remat off) with the losses without normalisation beside them."""
    jm = _conj_model(jconj)
    params = _init_conj(jm, jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    n = jm.main.num_patches
    n_vis, n_vis_c = n // 4, jm.context.num_patches
    batches = []
    for _ in range(3):
        x = rng.rand(2, 3, 2, IMG, IMG).astype(np.float32)
        xc = (rng.randn(2, 6, IMU_LEN, 1, 1) * 0.1).astype(np.float32)
        mask = np.ones((2, n), bool)
        for r in range(2):
            mask[r, rng.choice(n, n_vis, replace=False)] = False
        mc = np.zeros((2, n_vis_c), bool)
        batches.append((x, mask, xc, mc))
    jopt = JT.make_optimizer(**OPT)
    jstate = JT.TrainState(jnp.zeros((), jnp.int32), params,
                           jopt.init(params))
    jstep = jax.jit(JT.make_conjoined_train_step(jm, jopt, n_vis, n_vis_c,
                                                 remat=False))
    metrics = []
    for b in batches:
        jstate, met = jstep(jstate, *(jnp.asarray(a) for a in b))
        metrics.append(met)
    raw_loss = jax.jit(lambda p, *b: JT.conjoined_prediction_loss(
        jm, p, *b, n_vis, n_vis_c, normalize_inputs=False,
        normalize_targets=False))
    raw = float(raw_loss(params, *(jnp.asarray(a) for a in batches[0])))
    return params, batches, n_vis, n_vis_c, metrics, jstate.params, raw


@pytest.mark.parametrize('remat,accum', [(False, 1), (True, 2), ('dots', 1)])
def test_conjoined_three_train_steps_match_jax(conj_setup, remat, accum):
    params, batches, n_vis, n_vis_c, ref_metrics, ref_params, _ = conj_setup
    model = _conj_model(tconj, attn_impl='flash', device='cpu')
    model.load_state_dict(weights.conjoined_state_dict_from_jax(
        model, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    opt = TT.make_optimizer(**OPT)
    state = TT.TrainState(0, model, opt.init(model.parameters()))
    step = TT.make_conjoined_train_step(model, opt, n_vis, n_vis_c,
                                        remat=remat, accum_steps=accum)
    for b, jmet in zip(batches, ref_metrics):
        state, met = step(state, *(t(a) for a in b))
        for key in ('loss', 'grad_norm'):
            assert math.isclose(float(met[key]), float(jmet[key]),
                                rel_tol=1e-4), (key, state.step)
    ref = weights.conjoined_state_dict_from_jax(
        model, jax.tree_util.tree_map(np.asarray, ref_params))
    _close_dicts(dict(model.state_dict()), ref, atol=1e-4)


def test_conjoined_prediction_loss_without_normalisation(conj_setup):
    params, batches, n_vis, n_vis_c, _, _, raw = conj_setup
    model = _conj_model(tconj, attn_impl='dense', device='cpu')
    model.load_state_dict(weights.conjoined_state_dict_from_jax(
        model, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = float(TT.conjoined_prediction_loss(
            model, *(t(a) for a in batches[0]), n_vis, n_vis_c,
            normalize_inputs=False, normalize_targets=False))
    assert math.isclose(got, raw, rel_tol=1e-5), (got, raw)
