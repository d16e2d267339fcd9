"""Port parity: RAFT training (training/raft.py) against the JAX package's
training/raft.py, and the RAFT pieces it needs: ``with_sequence``, the
gather lookup's gradients and the refusal of the lookup kernel under
autograd. The weights are seeded in the port (utils/weights.init_raft, the
JAX initialisers' laws) and carried to JAX by the JAX package's converter
(utils/torch_convert.convert_raft), so no JAX initialiser compiles; the
large model's frozen batch norms start from perturbed statistics, so that
training them (as JAX does) shows.

Tolerances (tests/test_torch_train.py's): the loss, the EPE and the
gradient norm at every step rtol 1e-4; the step-1 gradients atol 2e-4 /
rtol 1e-4; the parameters after three steps atol 1e-4, the batch-norm
statistics included (the keypoint steps' feature encoder within 4 lr: see
the test); the gather lookup's gradients atol 1e-5; the
synthetic batches within 1e-4."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models.raft import corr as jcorr
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.training import raft as JR
from counterfactualworldmodels_tpu.training import train as JT
from counterfactualworldmodels_tpu.utils import torch_convert as jconvert
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models.raft import corr as tcorr
from counterfactualworldmodels_tpu_torch.models.raft.layers import \
    FrozenBatchNorm
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.training import raft as TR
from counterfactualworldmodels_tpu_torch.training import train as TT
from counterfactualworldmodels_tpu_torch.utils import weights

from test_torch_multihost import two_threads  # noqa: F401 (autouse)
from torch_port_common import assert_close, t

HW = 64
# tests/test_raft_train.py's rate. Adam moves an entry by ~lr whatever its
# gradient's size, so an entry whose gradient is f32 noise (the feature
# encoder's, which instance norms make scale-invariant) can differ by
# ~2 lr between two f32 implementations: 1e-3 would exceed atol 1e-4.
OPT = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)


def _sd(params):
    return weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _perturb_norms(model, seed):
    """Random batch-norm statistics (the initialisers give identity)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.shape
                m.weight.copy_(t(1 + 0.2 * rng.rand(*n)))
                m.bias.copy_(t(0.1 * rng.randn(*n)))
                m.running_mean.copy_(t(0.1 * rng.randn(*n)))
                m.running_var.copy_(t(1 + 0.2 * rng.rand(*n)))
    return model


def _jax_params(sd, small=False):
    """Port weights as a JAX param tree (the JAX package's converter)."""
    return jax.tree_util.tree_map(jnp.asarray,
                                  jconvert.convert_raft(sd, small))


def _seeded(seed, **kw):
    return weights.init_raft(traft.RAFT(iters=2, device='cpu', **kw),
                             torch.Generator().manual_seed(seed))


def _images(b, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 3, HW, HW) * 255).astype(np.float32)


@pytest.fixture(scope='module')
def large():
    """The large RAFT (context encoder with 'batch' norms, perturbed
    statistics): JAX model, its params, and the keypoint model's params
    (the same trunk and a seeded output head). The weights are seeded in
    the port and carried to JAX by utils/torch_convert.convert_raft."""
    sd = _perturb_norms(_seeded(0), 1).state_dict()
    kp = dict(_seeded(2, output_dim=1).state_dict(), **sd)
    return jraft.RAFT(iters=2), _jax_params(sd), _jax_params(kp)


def _port(params, **kw):
    m = traft.RAFT(iters=2, device='cpu', **kw)
    m.load_state_dict(_sd(params), strict=True)
    return m


# ---------------------------------------------------------------------------
# losses and synthetic batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['plain', 'valid', 'max_flow'])
def test_sequence_loss_and_epe_match_jax(case):
    rng = np.random.RandomState(3)
    seq = rng.randn(3, 2, 2, 8, 8).astype(np.float32) * 4
    gt = rng.randn(2, 2, 8, 8).astype(np.float32) * 4
    valid = rng.rand(2, 8, 8) > 0.3 if case == 'valid' else None
    max_flow = 5.0 if case == 'max_flow' else 400.0
    ref = JR.raft_sequence_loss(jnp.asarray(seq), jnp.asarray(gt),
                                None if valid is None else jnp.asarray(valid),
                                gamma=0.7, max_flow=max_flow)
    got = TR.raft_sequence_loss(t(seq), t(gt),
                                None if valid is None else t(valid),
                                gamma=0.7, max_flow=max_flow)
    assert math.isclose(float(got), float(ref), rel_tol=1e-6), (got, ref)
    ref = JR.end_point_error(jnp.asarray(seq[-1]), jnp.asarray(gt),
                             None if valid is None else jnp.asarray(valid))
    got = TR.end_point_error(t(seq[-1]), t(gt),
                             None if valid is None else t(valid))
    assert math.isclose(float(got), float(ref), rel_tol=1e-6), (got, ref)


def test_sequence_loss_weighting():
    """Two iterations with constant errors 2 and 1 weigh gamma*2 + 1."""
    gt = torch.zeros(1, 2, 4, 4)
    seq = torch.stack([torch.full((1, 2, 4, 4), 2.0),
                       torch.full((1, 2, 4, 4), 1.0)])
    for gamma in (0.8, 0.5):
        assert math.isclose(float(TR.raft_sequence_loss(seq, gt, gamma=gamma)),
                            gamma * 2 + 1, rel_tol=1e-6)


@pytest.mark.parametrize('translation', [True, False])
def test_synthetic_flow_batch_matches_jax(translation):
    """On JAX's own uniform draws, injected: the field, the warp (bilinear
    with edges replicated) and the valid mask."""
    img = _images(2, 4)
    key = jax.random.PRNGKey(5)
    shape = (2, 2, 1, 1) if translation else (2, 2, 4, 4)
    draws = np.asarray(jax.random.uniform(key, shape, minval=-6.0,
                                          maxval=6.0))
    ref = jax.jit(JR.synthetic_flow_batch, static_argnames=(
        'cells', 'translation_only'))(key, jnp.asarray(img), max_mag=6.0,
                                      translation_only=translation)
    got = TR.synthetic_flow_batch(t(img), max_mag=6.0,
                                  translation_only=translation, draws=t(draws))
    for a, b in zip(got[:3], ref[:3]):
        assert tuple(a.shape) == b.shape
        assert_close(a.numpy(), b, atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    # from a generator: the same law, on the images' device
    g = TR.synthetic_flow_batch(t(img), max_mag=6.0,
                                generator=torch.Generator().manual_seed(0))
    assert float(g[2].abs().max()) <= 6.0 and g[3].dtype == torch.bool


# ---------------------------------------------------------------------------
# the model: with_sequence, the gather lookup, the kernel's refusal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('small', [True, False])
def test_with_sequence_matches_jax(small, large):
    if small:
        jm = jraft.RAFT(small=True, iters=2)
        params = _jax_params(_seeded(3, small=True).state_dict(), small=True)
    else:
        jm, params, _ = large
    im1, im2 = _images(2, 6), _images(2, 7)
    ref = jax.jit(lambda p, a, b: jm.apply({'params': p}, a, b, 2, True))(
        params, jnp.asarray(im1), jnp.asarray(im2))
    m = _port(params, small=small, corr_lookup='gather')
    with torch.no_grad():
        lr, up, seq = m(t(im1), t(im2), 2, with_sequence=True)
        _, up_plain = m(t(im1), t(im2), 2)
    assert tuple(seq.shape) == (2, 2, 2, HW, HW) == ref[2].shape
    for a, b in zip((lr, up, seq), ref):
        assert_close(a.numpy(), b, atol=1e-3)
    torch.testing.assert_close(seq[-1], up, rtol=0, atol=0)
    torch.testing.assert_close(up_plain, up, rtol=0, atol=0)


def test_gather_lookup_gradients_match_jax():
    """Gradients of the gather lookup with respect to the pyramid and the
    coordinates against jax.grad of lookup_pyramid(impl='gather')."""
    rng = np.random.RandomState(8)
    b, h, w, r = 2, 6, 5, 4
    corr = rng.randn(b, h, w, h, w).astype(np.float32)
    coords = (rng.rand(b, h, w, 2) * np.array([w + 4, h + 4]) - 2
              ).astype(np.float32)
    levels = 3
    cot = rng.randn(b, h, w, levels * (2 * r + 1) ** 2).astype(np.float32)

    def jloss(pyr, c):
        out = jcorr.lookup_pyramid(pyr, c, r, impl='gather')
        return (out * jnp.asarray(cot)).sum()
    jpyr = jcorr.build_pyramid(jnp.asarray(corr), levels)
    gp, gc = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jpyr, jnp.asarray(coords))

    pyr = [lv.clone().requires_grad_()
           for lv in tcorr.build_pyramid(t(corr), levels)]
    c = t(coords).requires_grad_()
    out = tcorr.lookup_pyramid(pyr, c, r, impl='gather')
    (out * t(cot)).sum().backward()
    for a, ref in zip(pyr, gp):
        assert_close(a.grad.numpy(), ref, atol=1e-5)
    assert_close(c.grad.numpy(), gc, atol=1e-5)


def test_kernel_lookup_refuses_autograd():
    """impl='kernel' raises where autograd records its inputs, on any
    device; without recording it runs (the plain version on the CPU)."""
    rng = np.random.RandomState(9)
    pyr = tcorr.build_pyramid(t(rng.randn(1, 4, 4, 4, 4).astype(np.float32)),
                              2)
    coords = t(rng.rand(1, 4, 4, 2).astype(np.float32) * 4)
    with pytest.raises(RuntimeError, match="impl='gather'"):
        tcorr.lookup_pyramid(pyr, coords.clone().requires_grad_(), 4,
                             impl='kernel')
    with pytest.raises(RuntimeError, match='no backward'):
        tcorr.lookup_pyramid([p.clone().requires_grad_() for p in pyr],
                             coords, 4, impl='kernel')
    with torch.no_grad():
        out = tcorr.lookup_pyramid(pyr, coords.clone().requires_grad_(), 4,
                                   impl='kernel')
    torch.testing.assert_close(out, tcorr.lookup_pyramid(pyr, coords, 4),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match='impl'):
        tcorr.lookup_pyramid(pyr, coords, 4, impl='lanes')
    with pytest.raises(ValueError, match='corr_lookup'):
        traft.RAFT(iters=1, small=True, device='cpu', corr_lookup='window')
    # a RAFT that forces the kernel cannot train
    m = traft.RAFT(iters=1, small=True, device='cpu', corr_lookup='kernel')
    im = t(_images(1, 10))
    with pytest.raises(RuntimeError, match="corr_lookup='gather'"):
        m(im, im)
    with torch.no_grad():
        m(im, im)


def test_norm_stats_become_parameters_under_their_names(large):
    _, params, _ = large
    m = _port(params)
    keys = list(m.state_dict())
    n_params = len(list(m.parameters()))
    m.train_norm_stats()
    m.train_norm_stats()                      # idempotent
    assert list(m.state_dict()) == keys
    names = {n for n, _ in m.named_parameters()}
    assert 'cnet.norm1.running_var' in names and 'cnet.norm1.weight' in names
    # norm3 and downsample.1 share one module: its four stats count once
    assert len(list(m.parameters())) > n_params
    m.load_state_dict(_sd(params), strict=True)
    assert not any(n.startswith('fnet') and 'running' in n for n in names)


def test_train_step_needs_trainable_stats(large):
    _, params, _ = large
    m = _port(params)
    opt = TT.make_optimizer(**OPT)
    state = TT.TrainState(0, m, opt.init(m.parameters()))
    step = TR.make_raft_train_step(m, opt, iters=2, remat=False)
    assert m.corr_lookup == 'gather'
    im = t(_images(1, 11))
    with pytest.raises(ValueError, match='train_norm_stats'):
        step(state, im, im, torch.zeros(1, 2, HW, HW), None)


# ---------------------------------------------------------------------------
# train steps against JAX's
# ---------------------------------------------------------------------------

def _flow_batches(n=3, b=2):
    out = []
    for i in range(n):
        im = jnp.asarray(_images(b, 20 + i))
        out.append(tuple(np.asarray(v) for v in jax.jit(
            JR.synthetic_flow_batch)(jax.random.PRNGKey(30 + i), im,
                                     max_mag=3.0)))
    return out


@pytest.fixture(scope='module')
def flow_reference(large):
    """JAX's three flow steps (remat off, one microbatch) from the
    perturbed weights: per-step metrics and the final params."""
    jm, params, _ = large
    batches = _flow_batches()
    jopt = JT.make_optimizer(**OPT)
    jstate = JT.TrainState(jnp.zeros((), jnp.int32), params,
                           jopt.init(params))
    jstep = jax.jit(JR.make_raft_train_step(jm, jopt, iters=2, remat=False))
    metrics = []
    for batch in batches:
        jstate, met = jstep(jstate, *map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in met.items()})
    return batches, metrics, jstate.params


@pytest.mark.parametrize('remat,accum', [(False, 1), (True, 1), (False, 2)])
def test_raft_flow_steps_match_jax(large, flow_reference, remat, accum):
    _, params, _ = large
    batches, ref_metrics, ref_params = flow_reference
    m = _port(params).train_norm_stats()
    opt = TT.make_optimizer(**OPT)
    state = TT.TrainState(0, m, opt.init(m.parameters()))
    step = TR.make_raft_train_step(m, opt, iters=2, remat=remat,
                                   accum_steps=accum)
    before = dict(kernels.LAUNCHES)
    for batch, ref in zip(batches, ref_metrics):
        state, met = step(state, *map(t, batch))
        for key in ('loss', 'epe', 'grad_norm'):
            assert math.isclose(float(met[key]), ref[key], rel_tol=1e-4), \
                (key, state.step, float(met[key]), ref[key])
    assert state.step == 3 and kernels.LAUNCHES == before
    got, want = m.state_dict(), _sd(ref_params)
    assert set(got) == set(want)
    for name in want:
        assert_close(got[name].detach().numpy(), want[name].numpy(),
                     atol=1e-4)
    # the statistics moved, as JAX's did
    init = _sd(params)
    assert not torch.equal(got['cnet.norm1.running_var'],
                           init['cnet.norm1.running_var'])


def test_raft_step1_gradients_match_jax(large, flow_reference):
    jm, params, _ = large
    batch = flow_reference[0][0]
    ref = jax.jit(jax.grad(lambda p, *b: JR.raft_flow_loss(
        jm.clone(corr_lookup='gather'), p, *b, iters=2)[0]))(
            params, *map(jnp.asarray, batch))
    m = _port(params, corr_lookup='gather').train_norm_stats()
    loss, _ = TR.raft_flow_loss(m, *map(t, batch), iters=2)
    loss.backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    want = _sd(ref)
    assert set(got) <= set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


def test_keypoint_distill_steps_match_jax(large):
    _, params, kp = large
    jm = jraft.RAFT(iters=2, output_dim=1)
    img = [_images(2, 40 + i) for i in range(3)]
    yy = np.arange(HW)[:, None] + np.zeros((1, HW))
    target = np.broadcast_to((yy > HW // 2).astype(np.float32),
                             (2, 1, HW, HW)).copy()
    jopt = JT.make_optimizer(**OPT)
    jstate = JT.TrainState(jnp.zeros((), jnp.int32), kp, jopt.init(kp))
    jstep = jax.jit(JR.make_keypoint_distill_step(jm, jopt, iters=2,
                                                  remat=False))
    m = _port(kp, output_dim=1).train_norm_stats()
    opt = TT.make_optimizer(**OPT)
    state = TT.TrainState(0, m, opt.init(m.parameters()))
    step = TR.make_keypoint_distill_step(m, opt, iters=2, remat=True)
    for x in img:
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(target))
        state, met = step(state, t(x), t(target))
        for key in ('loss', 'grad_norm'):
            assert math.isclose(float(met[key]), float(jmet[key]),
                                rel_tol=1e-4), (key, state.step)
    got, want = m.state_dict(), _sd(jstate.params)
    for name in want:
        # the feature encoder's instance norms make its gradient
        # scale-invariant: entries whose gradient is f32 noise take Adam
        # steps of ~lr of either sign, in either implementation (OPT's
        # note); two updates of at most 2 lr apart bound them by 4 lr
        tol = 4 * OPT['learning_rate'] if name.startswith('fnet.') else 1e-4
        assert_close(got[name].detach().numpy(), want[name].numpy(),
                     atol=tol)
    with pytest.raises(ValueError, match='output_dim'):
        TR.make_keypoint_distill_step(_port(params), opt)


def test_init_raft_train_state_is_seeded():
    opt = TT.make_optimizer(**OPT)
    a = TR.init_raft_train_state(traft.RAFT(iters=2, small=True,
                                            device='cpu'), opt, seed=3)
    b = TR.init_raft_train_state(traft.RAFT(iters=2, small=True,
                                            device='cpu'), opt, seed=3)
    assert a.step == 0
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), n
    im1, im2, gt, valid = TR.synthetic_flow_batch(
        t(_images(2, 50)), max_mag=3.0, translation_only=True,
        generator=torch.Generator().manual_seed(1))
    step = TR.make_raft_train_step(a.model, opt, iters=2, remat=False)
    state, met = step(a, im1, im2, gt, valid)
    assert state.step == 1 and all(math.isfinite(float(v))
                                   for v in met.values())
