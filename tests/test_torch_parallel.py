"""Port parity: data- and sample-parallel work over torch.distributed
(parallel/, training/train.make_sharded_*, training/raft.
make_sharded_raft_train_step) on two gloo ranks on the CPU.

One spawn of two processes per module (test_torch_multihost.spawn_ranks:
rendezvous through a FileStore under tmp_path, no TCP port to collide with
other test workers, joined with a timeout). The ranks run every multi-process check of this module and
save their results; the parent computes the references meanwhile:
- the dp train step of all four families (VMAE, ChannelMAE, conjoined,
  RAFT) over the global batch split in two, against the single-process step
  on the global batch (loss, aux and gradient norm rtol 1e-4 per step,
  parameters atol 1e-4 after three steps), every rank's parameters bitwise
  equal; the VMAE one also against JAX's make_sharded_train_step on two
  host devices;
- the five sample-sharded counterfactual wrappers against the port's
  single-process cores (videos atol 1e-5, flows atol 1e-4, masks equal:
  parallel/inference's JAX tests' bounds), every rank returning all S
  samples; the default engine's wrapper also against JAX's
  sharded_counterfactuals_fast on two host devices (videos 1e-4, flows
  1e-3 px: the parity tests' bounds). The other cores are held to JAX by
  test_torch_flow_generator.py and test_torch_imu.py;
- sharded_flow_corrs against compute_flow_corrs and JAX's (atol 1e-4).
"""
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu import parallel as jpar
from counterfactualworldmodels_tpu.models import fast_vmae as jfv
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.training import train as JT
from counterfactualworldmodels_tpu.utils import torch_convert as jconvert
from counterfactualworldmodels_tpu_torch import parallel
from counterfactualworldmodels_tpu_torch.models import cmae as tcmae
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import fast_conjoined as tfc
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.pipelines import imu as timu
from counterfactualworldmodels_tpu_torch.pipelines import segmentation as tseg
from counterfactualworldmodels_tpu_torch.training import raft as TR
from counterfactualworldmodels_tpu_torch.training import train as TT
from counterfactualworldmodels_tpu_torch.training import train_conjoined
from counterfactualworldmodels_tpu_torch.utils import weights

from test_torch_multihost import (WORLD, rank_session, spawn_ranks,  # noqa: F401
                                  two_threads)
from torch_port_common import (IMG, IMU_LEN, IMU_TOK, SMALL_VMAE, TINY,
                               assert_close, conj_specs, jax_uniform_noise, t)

OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
RAFT_OPT = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
S = 4
CMAE = dict(image_size=(32, 32), patch_size=(8, 8), in_channels=3,
            channel_partition=(1, 2), encoder_embed_dim=48, encoder_depth=2,
            encoder_num_heads=4, decoder_embed_dim=32, decoder_depth=1,
            decoder_num_heads=4, mlp_ratio=2.0, qkv_bias=True)


# ---------------------------------------------------------------------------
# the models and inputs, built alike in the parent and the ranks
# ---------------------------------------------------------------------------

def _vmae_module(sd, config=SMALL_VMAE):
    cfg = tvmae.PretrainVisionTransformer(**config)
    m = tvmae.PretrainVisionTransformerModule(cfg, device='cpu')
    m.load_state_dict(sd, strict=True)
    return cfg, m


def _cmae_model(seed):
    model = tcmae.ChannelMae(**CMAE, attn_impl='dense', device='cpu')
    opt = TT.make_optimizer(**OPT)
    return TT.init_cmae_train_state(model, opt, seed=seed), opt


def _conj_model(sd):
    main, ctx, pairs = conj_specs(tconj, 'padded')
    m = tconj.ConjoinedVMAE(main=main, context=ctx, device='cpu', **pairs)
    m.load_state_dict(sd, strict=True)
    return m


def _raft(sd, **kw):
    m = traft.RAFT(iters=1, device='cpu', **kw)
    m.load_state_dict(sd, strict=True)
    return m


def _gen(i):
    return torch.Generator().manual_seed(100 + i)


def _train_inputs():
    """Three global batches of each family (the masks come from the steps'
    generators)."""
    rng = np.random.RandomState(0)
    h = SMALL_VMAE['img_size'][0]
    vmae_x = [rng.rand(4, 2, 3, h, h).astype(np.float32) for _ in range(3)]
    cmae_x = [rng.rand(4, 3, 32, 32).astype(np.float32) for _ in range(3)]
    conj_x = [(rng.rand(4, 3, 2, IMG, IMG).astype(np.float32),
               (rng.randn(4, 6, IMU_LEN, 1, 1) * 0.1).astype(np.float32))
              for _ in range(3)]
    raft_x = [tuple(v.numpy() for v in TR.synthetic_flow_batch(
        torch.from_numpy((rng.rand(4, 3, 32, 32) * 255).astype(np.float32)),
        max_mag=3.0, generator=_gen(i))) for i in range(3)]
    return dict(vmae=vmae_x, cmae=cmae_x, conj=conj_x, raft=raft_x)


def _vmae_masks(cfg, b):
    return [TT.make_batch_masks(_gen(i), cfg, b, 0.9)[0] for i in range(3)]


def _run_family(name, inputs, mesh=None):
    """Three steps of family ``name`` from the same initial weights: the
    dp step on this rank's rows when ``mesh`` is given, else the
    single-process step on the global batch. Returns (per-step metrics,
    final state dict)."""
    data = inputs['data'][name]
    if name == 'vmae':
        cfg, m = _vmae_module(inputs['vmae_sd'])
        opt = TT.make_optimizer(**OPT)
        state = TT.TrainState(0, m, opt.init(m.parameters()))
        _, n_vis = TT.make_batch_masks(None, cfg, 4, 0.9)
        mask_fn = (lambda g, b: TT.make_batch_masks(g, cfg, b, 0.9)[0])
        kw = dict(remat=False, mask_fn=mask_fn, device='cpu')
        if mesh is None:
            step = TT.make_train_step(cfg, opt, n_vis, **kw)
        else:
            step, shard, dp = TT.make_sharded_train_step(cfg, opt, mesh,
                                                         n_vis, **kw)
            state = shard(state)
        batches = [(x, _gen(i)) for i, x in enumerate(data)]
    elif name == 'cmae':
        state, opt = _cmae_model(1)
        m = state.model
        _, counts = tcmae.group_uniform_mask(_gen(0), m.mask_size, 0.75, 1)
        n_vis = m.num_patches - sum(counts)
        mask_fn = (lambda g, b: tcmae.group_uniform_mask(
            g, m.mask_size, 0.75, b)[0])
        kw = dict(remat=True, mask_fn=mask_fn)
        if mesh is None:
            step = TT.make_cmae_train_step(m, opt, n_vis, counts, **kw)
        else:
            step, shard, dp = TT.make_sharded_cmae_train_step(
                m, opt, mesh, n_vis, counts, **kw)
            state = shard(state)
        batches = [(x, _gen(i)) for i, x in enumerate(data)]
    elif name == 'conj':
        m = _conj_model(inputs['conj_sd'])
        opt = TT.make_optimizer(**OPT)
        state = TT.TrainState(0, m, opt.init(m.parameters()))
        n_vis = m.main.num_patches // 4
        n_vis_c = m.context.num_patches
        # the dp step accumulates over two microbatches of one row
        kw = dict(remat=False, mask_fn=train_conjoined.mask_sampler(m, n_vis),
                  accum_steps=1 if mesh is None else 2)
        if mesh is None:
            step = TT.make_conjoined_train_step(m, opt, n_vis, n_vis_c, **kw)
        else:
            step, shard, dp = TT.make_sharded_conjoined_train_step(
                m, opt, mesh, n_vis, n_vis_c, **kw)
            state = shard(state)
        batches = [(x, xc, _gen(i)) for i, (x, xc) in enumerate(data)]
    else:
        m = traft.RAFT(iters=2, device='cpu')
        opt = TT.make_optimizer(**RAFT_OPT)
        state = TR.init_raft_train_state(m, opt, seed=3)
        kw = dict(iters=2, remat=False)
        if mesh is None:
            step = TR.make_raft_train_step(m, opt, **kw)
        else:
            step, shard, dp = TR.make_sharded_raft_train_step(m, opt, mesh,
                                                              **kw)
            state = shard(state)
        batches = list(data)
    metrics = []
    for batch in batches:
        arrays = [torch.from_numpy(np.ascontiguousarray(b))
                  if isinstance(b, np.ndarray) else b for b in batch]
        if mesh is not None:
            arrays = [dp.local(a) if isinstance(a, torch.Tensor) else a
                      for a in arrays]
        state, met = step(state, *arrays)
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}


def _prompts(n, n0, s, seed, b=1):
    rng = np.random.RandomState(seed)
    passive = np.ones((b, n, s), dtype=bool)
    passive[:, :n0] = False
    active = passive.copy()
    for i in range(s):
        active[0, n0 + rng.randint(n - n0), i] = False
    shifts = rng.randint(-1, 2, size=(b, s, 2)).astype(np.int64)
    return passive, active, shifts


def _wrapper_inputs():
    """Scenes and prompts of the five wrappers (S = 4), JAX keys for the
    default engine's comparison and the rectangularizer draws made from
    them."""
    rng = np.random.RandomState(5)
    h = TINY['img_size'][0]
    n = (h // 4) ** 2 * 2
    x = rng.rand(1, 2, 3, h, h).astype(np.float32)
    passive, active, shifts = _prompts(n, n // 2, S, 6)
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    scenes = rng.rand(S, 2, 3, h, h).astype(np.float32)
    multi = [np.stack([p[0, :, i] for i in range(S)]) for p in
             (passive, active)]
    ximu = rng.rand(1, 2, 3, IMG, IMG).astype(np.float32)
    n_imu = 2 * (IMG // 8) ** 2
    pi, ai, si = _prompts(n_imu, n_imu // 2, S, 8)
    return dict(
        x=x, passive=passive, active=active, shifts=shifts,
        keys=np.asarray(keys), noise=jax_uniform_noise(keys, n // 2),
        scenes=scenes, mpassive=multi[0], mactive=multi[1],
        mshifts=shifts[0], ximu=ximu, pimu=pi, aimu=ai, simu=si,
        imu=(rng.randn(1, 6, IMU_LEN) * 0.1).astype(np.float32),
        noise_imu=rng.rand(S, n_imu // 2).astype(np.float32) * 0.999,
        noise_exact=rng.rand(1, S, n // 2).astype(np.float32) * 0.999,
        noise_imu_exact=rng.rand(1, S, n_imu // 2).astype(np.float32)
        * 0.999, flows=rng.randn(2, 2, 8, 8, 5).astype(np.float32))


def _run_wrappers(inputs, mesh=None):
    """The five wrappers with the samples split over ``mesh``, or their
    single-process cores without one; and the flow correlation both ways.
    Returns {name: tuple of numpy outputs}."""
    w = inputs['wrappers']
    n_vis_cf = inputs['n_vis']
    cfg, module = _vmae_module(inputs['tiny_sd'], TINY)
    fp = tfv.stack_vmae_params(cfg, inputs['tiny_sd'], dtype=torch.float32,
                               device='cpu')
    raft = _raft(inputs['raft_sd'], small=True)
    x, shifts = t(w['x']), t(w['shifts'])
    passive, active = t(w['passive']), t(w['active'])
    n0 = cfg.num_patches_per_frame
    n_sfx = tfv.sfx_bucket(n_vis_cf - n0, cfg.num_patches - n0)
    out = {}
    if mesh is None:
        out['fast'] = tseg.counterfactual_videos_and_flows_fast(
            cfg, fp, raft, x, passive, active, shifts, t(w['noise']), n_sfx,
            True, 1, True, n_vis=n_vis_cf)
        out['exact'] = tseg.counterfactual_videos_and_flows(
            module, raft, x, passive, active, shifts, t(w['noise_exact']),
            n_vis_cf, True, 1, True, device='cpu')
    else:
        out['fast'] = parallel.sharded_counterfactuals_fast(
            mesh, cfg, fp, raft, x, passive, active, shifts, t(w['noise']),
            n_vis_cf, True, 1)
        out['exact'] = parallel.sharded_counterfactuals(
            mesh, module, raft, x, passive, active, shifts,
            t(w['noise_exact']), n_vis_cf, True, 1, device='cpu')
        # a Generator draws the same noise on every rank
        out['fast_generator'] = parallel.sharded_counterfactuals_fast(
            mesh, cfg, fp, raft, x, passive, active, shifts,
            torch.Generator().manual_seed(11), n_vis_cf, True, 1)
        out['block'] = parallel.shard_counterfactual_batch(
            mesh, t(w['scenes']), t(w['mshifts']))
    scenes = t(w['scenes'])
    cache = tfv.stack_prefix_caches(
        [tfv.make_prefix_cache(cfg, fp, True, scenes[i:i + 1, 0])
         for i in range(S)])
    margs = (scenes, t(w['mpassive']), t(w['mactive']), t(w['mshifts']))
    if mesh is None:
        out['multi'] = tseg.counterfactual_videos_and_flows_fast_multi(
            cfg, fp, raft, *margs, n_sfx, True, 1, True, t(w['noise']),
            cache, n_vis=n_vis_cf, device='cpu')
    else:
        out['multi'] = parallel.sharded_counterfactuals_fast_multi(
            mesh, cfg, fp, raft, *margs, t(w['noise']), n_vis_cf, True, 1,
            prefix_cache=cache, device='cpu')
    cm = _conj_model(inputs['conj_sd'])
    wrap = tconj.ConjoinedPredictorWrapper(cm, params=inputs['conj_sd'],
                                           main_input='rgb01',
                                           context_input='imu')
    cp = tfc.cast_params(cm, inputs['conj_sd'], torch.float32, 'cpu')
    xi, imu = t(w['ximu']), t(w['imu'])
    mc = torch.zeros((1, IMU_TOK), dtype=torch.bool)
    n_imu = cm.main.num_patches
    n_vis_i = n_imu // 2 + 1
    iargs = (xi, t(w['pimu']), t(w['aimu']), t(w['simu']))
    n_vis_c = wrap.context_n_vis(mc)
    tiled = (imu.repeat(S, 1, 1), mc.repeat(S, 1))
    if mesh is None:
        out['imu_fast'] = timu._imu_counterfactual_step_fast(
            wrap, cp, raft, *iargs, t(w['noise_imu']), imu, mc, n_vis_i,
            True, 1)
        out['imu_exact'] = timu._imu_counterfactual_step(
            wrap, raft, *iargs, t(w['noise_imu_exact']), *tiled, n_vis_i,
            n_vis_c, True, 1, True)
    else:
        out['imu_fast'] = parallel.sharded_imu_counterfactuals_fast(
            mesh, wrap, cp, raft, *iargs, t(w['noise_imu']), imu, mc,
            n_vis_i, True, 1)
        out['imu_exact'] = parallel.sharded_imu_counterfactuals(
            mesh, wrap, raft, *iargs, t(w['noise_imu_exact']), *tiled,
            n_vis_i, n_vis_c, True, 1)
    flows = t(w['flows'])
    for cov in (False, True):
        key = f'corrs_cov{int(cov)}'
        if mesh is None:
            out[key] = (tseg.compute_flow_corrs(flows, downsample=2,
                                                use_covariance=cov),)
        else:
            out[key] = (parallel.sharded_flow_corrs(
                parallel.make_mesh({'rows': WORLD}), flows, downsample=2,
                use_covariance=cov),)
    return {k: tuple(np.asarray(v) for v in vals) for k, vals in out.items()}


def _checks(rank, tmp):
    """Every multi-process check of this module, on one rank."""
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'), weights_only=False)
    mesh = parallel.make_mesh({'dp': WORLD})
    res = {name: _run_family(name, inputs, mesh)
           for name in ('vmae', 'cmae', 'conj', 'raft')}
    res['wrappers'] = _run_wrappers(inputs, parallel.sample_parallel_mesh())
    return res


def _rank_main(rank, tmp):
    rank_session(rank, tmp, _checks)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The ranks' results, the single-process references and JAX's. The
    weights are the port's seeded ones, carried to JAX by the JAX
    package's own converters (utils/torch_convert): no JAX initialiser
    compiles here."""
    tmp = str(tmp_path_factory.mktemp('ranks'))
    gen = torch.Generator().manual_seed
    cfg = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    vmae_sd = weights.init_vmae_state_dict(cfg, gen(0))
    tiny_cfg = tvmae.PretrainVisionTransformer(**TINY)
    tiny_sd = weights.init_vmae_state_dict(tiny_cfg, gen(1))
    raft_sd = weights.init_raft(traft.RAFT(iters=1, small=True, device='cpu'),
                                gen(2)).state_dict()
    main, ctx, pairs = conj_specs(tconj, 'padded')
    conj_sd = weights.init_conjoined_state_dict(
        tconj.ConjoinedVMAE(main=main, context=ctx, device='cpu', **pairs),
        gen(3))
    inputs = dict(vmae_sd=vmae_sd, tiny_sd=tiny_sd, raft_sd=raft_sd,
                  conj_sd=conj_sd, data=_train_inputs(),
                  wrappers=_wrapper_inputs(),
                  n_vis=tiny_cfg.num_patches // 2 + 1)
    torch.save(inputs, os.path.join(tmp, 'inputs.pt'))
    join = spawn_ranks(tmp, _rank_main)
    try:
        ref = {name: _run_family(name, inputs)
               for name in ('vmae', 'cmae', 'conj', 'raft')}
        ref['wrappers'] = _run_wrappers(inputs)
        jax_out = _jax_references(
            jvmae.PretrainVisionTransformer(**SMALL_VMAE),
            _to_jax(jconvert.convert_vmae(vmae_sd)),
            jvmae.PretrainVisionTransformer(**TINY),
            _to_jax(jconvert.convert_vmae(tiny_sd)),
            jraft.RAFT(small=True, iters=1),
            _to_jax(jconvert.convert_raft(raft_sd, small=True)), inputs)
    finally:
        ranks = join()
    return ranks, ref, jax_out


def _jax_references(jm, vparams, tiny, tparams, jr, rparams, inputs):
    """JAX's dp VMAE step and sample-sharded default engine on two host
    devices, and its sharded flow correlation."""
    out = {}
    mesh = jpar.make_mesh({'dp': WORLD})
    jopt = JT.make_optimizer(**OPT)
    cfg = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    _, n_vis = TT.make_batch_masks(None, cfg, 4, 0.9)
    step, shard_state, sh = JT.make_sharded_train_step(jm, jopt, mesh, n_vis,
                                                       remat=False)
    state = shard_state(JT.TrainState(jnp.zeros((), jnp.int32), vparams,
                                      jopt.init(vparams)))
    metrics = []
    for x, m in zip(inputs['data']['vmae'], _vmae_masks(cfg, 4)):
        state, met = step(state, jax.device_put(x, sh),
                          jax.device_put(m.numpy(), sh))
        metrics.append({k: float(v) for k, v in met.items()})
    out['vmae'] = (metrics, weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), 3,
        cfg.full_patch_size))
    w = inputs['wrappers']
    fp = jfv.stack_vmae_params(tiny, tparams, dtype=jnp.float32)
    smesh = jpar.sample_parallel_mesh(WORLD)
    out['fast'] = tuple(np.asarray(v) for v in
                        jpar.sharded_counterfactuals_fast(
        smesh, tiny, fp, jr, rparams, jnp.asarray(w['x']),
        jnp.asarray(w['passive']), jnp.asarray(w['active']),
        jnp.asarray(w['shifts'].astype(np.int32)),
        jnp.asarray(w['keys']).reshape(1, S, 2), inputs['n_vis'], True, 1,
        False))
    for cov in (False, True):
        out[f'corrs_cov{int(cov)}'] = np.asarray(jpar.sharded_flow_corrs(
            jpar.make_mesh({'rows': WORLD}), jnp.asarray(w['flows']),
            downsample=2, use_covariance=cov))
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _same_steps(got, ref, rtol=1e-4):
    (gm, gp), (rm, rp) = got, ref
    assert len(gm) == len(rm) == 3
    for a, b in zip(gm, rm):
        assert set(a) == set(b)
        for k in b:
            assert math.isclose(a[k], b[k], rel_tol=rtol), (k, a[k], b[k])
    assert set(gp) == set(rp)
    for k in rp:
        assert_close(gp[k].float().numpy(), rp[k].float().numpy(),
                     atol=1e-4)


@pytest.mark.parametrize('family', ['vmae', 'cmae', 'conj', 'raft'])
def test_dp_step_equals_the_global_batch_step(run, family):
    ranks, ref, _ = run
    _same_steps(ranks[0][family], ref[family])
    # every rank took the same step, bit for bit
    assert ranks[0][family][0] == ranks[1][family][0]
    for k, v in ranks[0][family][1].items():
        assert torch.equal(v, ranks[1][family][1][k]), k


def test_dp_vmae_step_matches_jax_sharded_step(run):
    ranks, _, jax_out = run
    _same_steps(ranks[0]['vmae'],
                (jax_out['vmae'][0], {k: v for k, v in
                                      jax_out['vmae'][1].items()}))


@pytest.mark.parametrize('name', ['fast', 'exact', 'multi', 'imu_fast',
                                  'imu_exact'])
def test_sample_sharded_wrappers_equal_their_cores(run, name):
    ranks, ref, _ = run
    for r in range(WORLD):
        y, f, m = ranks[r]['wrappers'][name]
        ry, rf, rm = ref['wrappers'][name]
        assert y.shape == ry.shape and y.shape[0] == S
        assert_close(y, ry, atol=1e-5)
        assert_close(f, rf, atol=1e-4)
        np.testing.assert_array_equal(m, rm)


def test_sharded_fast_engine_matches_jax(run):
    ranks, _, jax_out = run
    y, f, m = ranks[0]['wrappers']['fast']
    jy, jf, jm = jax_out['fast']
    np.testing.assert_array_equal(m, jm)
    assert_close(y, jy, atol=1e-4)
    assert_close(f, jf, atol=1e-3)


def test_generator_noise_and_blocks_are_rank_consistent(run):
    ranks, _, _ = run
    a, b = (r['wrappers']['fast_generator'] for r in ranks)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    # shard_counterfactual_batch: rank r holds the contiguous block r
    blocks = [r['wrappers']['block'] for r in ranks]
    for scenes, shifts in blocks:
        assert scenes.shape[0] == S // WORLD
        assert shifts.shape == (S // WORLD, 2)
    w = _wrapper_inputs()
    np.testing.assert_array_equal(np.concatenate([b[0] for b in blocks]),
                                  w['scenes'])
    np.testing.assert_array_equal(np.concatenate([b[1] for b in blocks]),
                                  w['mshifts'])


@pytest.mark.parametrize('cov', [0, 1])
def test_sharded_flow_corrs_match(run, cov):
    ranks, ref, jax_out = run
    key = f'corrs_cov{cov}'
    for r in range(WORLD):
        got = ranks[r]['wrappers'][key][0]
        assert_close(got, ref['wrappers'][key][0], atol=1e-4)
        assert_close(got, jax_out[key], atol=1e-4)


def test_sharded_wrappers_refuse_what_jax_refuses():
    """S not divisible by the axis, and the multi-scene engine without its
    stacked cache, raise before any collective (one process suffices)."""
    class _Mesh:
        mesh_dim_names = ('samples',)

        def size(self, dim):
            return 3

        def get_coordinate(self):
            return [0]
    with pytest.raises(ValueError, match='do not split'):
        parallel.inference._samples(_Mesh(), 4)
    with pytest.raises(ValueError, match='requires the stacked'):
        parallel.sharded_counterfactuals_fast_multi(
            _Mesh(), None, None, None, None, None, None, None, None, 1,
            True, 1)
