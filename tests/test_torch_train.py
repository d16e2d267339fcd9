"""Port parity: VMAE training (training/train.py) against the JAX package's
make_train_step, from the same initial weights (JAX-initialised, bridged by
utils/weights.vmae_state_dict_from_jax) on the same clips and masks.

Tolerances: the loss and the gradient norm at every step rtol 1e-4; the
step-1 gradients atol 2e-4 / rtol 1e-4 (tests/test_vmae.py's bound); the
parameters after three steps atol 1e-4. The loss alone rtol 1e-5."""
import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.training import train as JT
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.data.shards import u8_to_chw_01
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.training import flops
from counterfactualworldmodels_tpu_torch.training import train as TT
from counterfactualworldmodels_tpu_torch.training import train_vmae
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import SMALL_VMAE, t

RATIO = 0.9
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _state_dict(tree, cfg):
    return weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), 3, cfg.full_patch_size)


def _setup(batch=4, steps=3):
    """JAX model and params, the port's configuration and a module holding
    the same weights, and per-step (clips, masks) with n_vis."""
    jm = jvmae.PretrainVisionTransformer(**SMALL_VMAE)
    params = jvmae.init_params(jm, jax.random.PRNGKey(0))
    cfg = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    module = tvmae.PretrainVisionTransformerModule(cfg, device='cpu')
    module.load_state_dict(_state_dict(params, cfg), strict=True)
    rng = np.random.RandomState(0)
    h, w = cfg.img_size
    data = []
    for i in range(steps):
        x = rng.rand(batch, 2, 3, h, w).astype(np.float32)
        mask, n_vis = JT.make_batch_masks(jax.random.PRNGKey(10 + i), jm,
                                          batch, RATIO)
        data.append((x, np.asarray(mask)))
    return jm, params, cfg, module, data, n_vis


def _close_dicts(got, ref, atol, rtol):
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   ref[name].numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize('u8', [False, True])
def test_masked_prediction_loss_matches_jax(u8):
    jm, params, cfg, module, data, n_vis = _setup(batch=2, steps=1)
    x, mask = data[0]
    if u8:
        x = (x * 255).astype(np.uint8).transpose(0, 1, 3, 4, 2)  # [B,T,H,W,C]
    ref = float(JT.masked_prediction_loss(jm, params, jnp.asarray(x),
                                          jnp.asarray(mask), n_vis))
    with torch.no_grad():
        got = float(TT.masked_prediction_loss(module, t(x), t(mask), n_vis))
    assert math.isclose(got, ref, rel_tol=1e-5), (got, ref)


def test_u8_to_chw_01():
    x = np.random.RandomState(1).randint(0, 256, (2, 2, 5, 6, 3), np.uint8)
    got = u8_to_chw_01(t(x))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 3, 5, 6)
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.float32).transpose(0, 1, 4, 2, 3) / 255.0)


def test_step1_gradients_match_jax():
    jm, params, cfg, module, data, n_vis = _setup(steps=1)
    x, mask = data[0]
    ref = jax.grad(lambda p: JT.masked_prediction_loss(
        jm, p, jnp.asarray(x), jnp.asarray(mask), n_vis))(params)
    loss = TT.masked_prediction_loss(module, t(x), t(mask), n_vis)
    loss.backward()
    got = {n: p.grad for n, p in module.named_parameters()}
    _close_dicts(got, _state_dict(ref, cfg), atol=2e-4, rtol=1e-4)


def test_schedule_matches_optax():
    for warm, total in ((1, 10), (3, 8), (0, 5)):
        opt = TT.make_optimizer(learning_rate=2e-3, warmup_steps=warm,
                                total_steps=total)
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 2e-3, warm, max(total, warm + 1))
        for count in range(total + 3):
            assert math.isclose(opt.schedule(count), float(sched(count)),
                                rel_tol=1e-6, abs_tol=1e-12), (warm, count)
    assert TT.make_optimizer(**OPT).schedule(0) == 0.0


@pytest.mark.parametrize('remat,accum', [(True, 1), (False, 1), (True, 2)])
def test_three_train_steps_match_jax(remat, accum):
    jm, params, cfg, module, data, n_vis = _setup()
    jopt = JT.make_optimizer(**OPT)
    jstep = jax.jit(JT.make_train_step(jm, jopt, n_vis, remat=remat,
                                       accum_steps=accum))
    jstate = JT.TrainState(jnp.zeros((), jnp.int32), params,
                           jopt.init(params))
    opt = TT.make_optimizer(**OPT)
    state = TT.TrainState(0, module, opt.init(module.parameters()))
    step = TT.make_train_step(cfg, opt, n_vis, remat=remat,
                              accum_steps=accum, device='cpu')
    for x, mask in data:
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(mask))
        state, met = step(state, t(x), t(mask))
        for key in ('loss', 'grad_norm'):
            assert math.isclose(float(met[key]), float(jmet[key]),
                                rel_tol=1e-4), (key, state.step)
    assert state.step == int(jstate.step) == 3
    # every entry, those with a near-zero step-1 gradient included
    _close_dicts(dict(module.state_dict()),
                 _state_dict(jstate.params, cfg), atol=1e-4, rtol=0)


def test_keyed_step_draws_masks_from_a_generator():
    cfg = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    opt = TT.make_optimizer(**OPT)
    state = TT.init_train_state(cfg, opt, seed=1, device='cpu')
    _, n_vis = TT.make_batch_masks(None, cfg, 2, RATIO)
    step = TT.make_train_step(
        cfg, opt, n_vis, remat=False, device='cpu',
        mask_fn=lambda g, b: TT.make_batch_masks(g, cfg, b, RATIO)[0])
    x = torch.rand(2, 2, 3, 32, 32)
    before = dict(kernels.LAUNCHES)
    state, met = step(state, x, torch.Generator().manual_seed(0))
    assert kernels.LAUNCHES == before and state.step == 1
    assert torch.isfinite(met['loss']) and float(met['grad_norm']) > 0


def test_unported_options_raise():
    """Every option of the JAX recipe is ported: remat='dots' and a bf16
    first moment run (tests/test_torch_train_families.py holds them against
    JAX); what the JAX package has no counterpart for raises."""
    assert callable(TT.apply_remat(lambda *a: 0, 'dots'))
    opt = TT.make_optimizer(mu_dtype=torch.bfloat16)
    assert isinstance(opt.init([torch.nn.Parameter(torch.zeros(2))]),
                      TT.AdamWMixed)
    with pytest.raises(ValueError, match='remat'):
        TT.apply_remat(lambda *a: 0, 'everything')
    with pytest.raises(ValueError, match='mu_dtype'):
        TT.make_optimizer(mu_dtype=torch.int8).init(
            [torch.nn.Parameter(torch.zeros(2))])


def test_vmae_train_flops_matches_the_bench_definition():
    """The port's copy counts what scripts/bench_train.py counts."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'scripts', 'bench_train.py')
    spec = importlib.util.spec_from_file_location('bench_train', path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for name in ('large_4x4patch_2frames_1tube', 'base_8x8patch_2frames_1tube'):
        cfg = getattr(tvmae, name)()
        n_vis = cfg.num_patches // 2 + 300
        assert (flops.vmae_train_flops(cfg, 4, n_vis)
                == bench.vmae_train_flops(getattr(jvmae, name)(), 4, n_vis))


def test_train_vmae_synthetic_on_the_cpu(capsys):
    train_vmae.main(['--synthetic', '--model', 'tiny', '--device', 'cpu',
                     '--steps', '2', '--img-size', '32', '--batch-size', '2'])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert [r['step'] for r in lines] == [1, 2]
    assert all(math.isfinite(r['loss']) and r['grad_norm'] > 0
               for r in lines)
