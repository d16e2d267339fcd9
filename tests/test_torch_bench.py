"""Port parity: the measurement entry points (``scripts/bench.py`` and its
siblings) against the JAX scripts' own functions, and each port script's
``main`` on the CPU at a tiny size.

- The demo prompt policy: the same passive and active masks and shifts,
  bitwise, from the same RandomState, at the tiny and the ViT-L grids.
- The FLOP models: ``vit_flops`` / ``raft_flops`` equal to the JAX bench's
  for the tiny, base and large models at every rung of the ladder; the VMAE
  train count equal to the JAX bench_train's; the ChannelMAE, conjoined and
  RAFT counts (the JAX package has none), counted on the meta device, equal
  to torch.utils.flop_counter's count of the real forward on the CPU.
- The bench's dispatch on the tests' tiny VMAE at 32 px (bridged weights,
  JAX's rectangularizer draws): masks bitwise, flows within 1e-3 px of the
  JAX package's counterfactual_videos_and_flows_fast (the tolerance of
  test_torch_segmentation.py).
- latency_bench's cold prediction against JAX's predict_video at the
  exact-VMAE parity tolerance (atol 2e-4 / rtol 1e-4).
- Each script's ``main(['--device', 'cpu', ...])`` prints one JSON line
  with every key of the JAX script's record (renamed where the port
  deviates: ``mfu_executed`` for ``mfu_executed_vs_v5e_peak``, ``sdpa`` for
  the TPU-only attention candidates).
"""
import argparse
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import fast_vmae as jfv
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import prediction as jpred
from counterfactualworldmodels_tpu.pipelines import segmentation as jseg
from counterfactualworldmodels_tpu_torch.models import cmae as tcmae
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.scripts import (
    _bench_common, bench, bench_attention, bench_conjoined, bench_loader,
    bench_sweep, bench_train, latency_bench)
from counterfactualworldmodels_tpu_torch.training import flops
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (SMALL_VMAE, _init_raft, assert_close,
                               jax_uniform_noise, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load('jax_root_bench', 'bench.py')
jcommon = _load('jax_bench_common', 'scripts/_bench_common.py')
jtrain = _load('jax_bench_train', 'scripts/bench_train.py')

JAX_TINY = dict(img_size=(64, 64), patch_size=(8, 8), encoder_embed_dim=64,
                encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=48,
                decoder_depth=1, decoder_num_heads=4, num_frames=2,
                qkv_bias=True)
LADDER = [(1, 1, 'erf'), (2, 2, 'tanh'), (4, 4, 'erf'), (4, 4, 'tanh')]


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread for the port's CPU runs here: tier-1 shares the
    cores among six workers, where parallel ops stall (the bench's RAFT at
    224 px took minutes with every core's threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(name):
    if name == 'tiny':
        return jvmae.PretrainVisionTransformer(**JAX_TINY)
    if name == 'base':
        return jvmae.base_8x8patch_2frames_1tube()
    return jvmae.large_4x4patch_2frames_1tube()


@pytest.mark.parametrize('n', [128, 6272], ids=['tiny', 'vit_l'])
def test_demo_prompts_bitwise(n):
    for s, b in ((3, 1), (16, 1), (2, 2)):
        jp, ja, jsh, _, jn = jcommon.demo_prompts(np.random.RandomState(7),
                                                  n, s, b=b)
        p, a, sh, n_vis = _bench_common.demo_prompts(
            np.random.RandomState(7), n, s, b=b)
        np.testing.assert_array_equal(p, np.asarray(jp))
        np.testing.assert_array_equal(a, np.asarray(ja))
        np.testing.assert_array_equal(sh, np.asarray(jsh))
        assert n_vis == jn == n // 2 + 33


@pytest.mark.parametrize('name', ['tiny', 'base', 'large'])
def test_flop_models_equal_jax(name):
    jm = _jax_config(name)
    tm = bench.bench_config(name, torch.float32)
    for s in (1, 16, 256):
        for pp, sp, _ in LADDER:
            assert bench.vit_flops(tm, s, 33, pp, sp) == jbench.vit_flops(
                jm, s, 33, pp, sp)
        assert bench.raft_flops(s) == jbench.raft_flops(s)
    for batch, n_vis in ((1, 40), (4, 3450)):
        assert flops.vmae_train_flops(tm, batch, n_vis) == (
            jtrain.vmae_train_flops(jm, batch, n_vis))


def _real_flops(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as c, torch.no_grad():
        fn()
    return c.get_total_flops()


def test_counted_train_flops_match_the_real_forward():
    """The meta-device counts of the ChannelMAE, conjoined and RAFT steps
    (3 x one forward) equal the flop counter on the real forward."""
    cpu = torch.device('cpu')
    args = argparse.Namespace(model='tiny', img_size=32, patch_size=8)
    from counterfactualworldmodels_tpu_torch.training.train_cmae import (
        build_model)
    m = build_model(args, (3,), cpu)
    mask, counts = tcmae.group_uniform_mask(torch.Generator(), m.mask_size,
                                            0.75, 2)
    n_vis = m.num_patches - sum(counts)
    x = torch.rand(2, 3, 32, 32)
    assert flops.cmae_train_flops(lambda d: build_model(args, (3,), d), 2,
                                  n_vis, counts) == 3 * _real_flops(
        lambda: m(x, mask, n_vis, counts))

    c = bench_train.conjoined_model(cpu, small=True)
    n = c.main.num_patches
    cmask = torch.ones(2, n, dtype=torch.bool)
    cmask[:, :n // 2 + 2] = False
    nc = c.context.num_patches
    assert flops.conjoined_train_flops(
        lambda d: bench_train.conjoined_model(d, small=True), 2, n // 2 + 2,
        nc) == 3 * _real_flops(lambda: c(
            torch.rand(2, 3, 2, 32, 32), cmask, torch.rand(2, 6, 32, 1, 1),
            torch.zeros(2, nc, dtype=torch.bool), n // 2 + 2, nc))

    def raft(d):
        return traft.RAFT(small=True, iters=2, device=d, corr_lookup='gather')
    r = raft(cpu)
    im = torch.rand(1, 3, 64, 64) * 255
    assert flops.raft_train_flops(raft, 1, 64, 2) == 3 * _real_flops(
        lambda: r(im, im, 2, True))


@pytest.fixture(scope='module')
def small_pair():
    """The tests' small VMAE in both packages (bridged weights) and a
    2-iteration RAFT of each."""
    jm = jvmae.PretrainVisionTransformer(**SMALL_VMAE)
    params = jvmae.init_params(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    jr = jraft.RAFT(iters=2)
    rparams = _init_raft(jr, jax.random.PRNGKey(1), 32)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rparams)), strict=True)
    return (jm, params, jr, rparams), (tm, sd, tr)


def test_bench_dispatch_matches_jax(small_pair):
    """The bench's prompts and dispatch (the library-default rung of the
    grid) against the JAX bench's wiring of the same call."""
    from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
    (jm, params, jr, rparams), (tm, sd, tr) = small_pair
    n, npf = jm.num_patches, jm.num_patches_per_frame
    s = 3
    x = np.random.RandomState(0).rand(1, 2, 3, 32, 32).astype(np.float32)
    jp, ja, jsh, keys, n_vis = jcommon.demo_prompts(
        np.random.RandomState(1), n, s)
    rung = tfv.resolve_pools(8, 8)
    jy, jf, jmask = jseg.counterfactual_videos_and_flows_fast(
        jm, jfv.stack_vmae_params(jm, params, dtype=jnp.float32), jr,
        rparams, jnp.asarray(x), jp, ja, jsh, keys,
        jfv.sfx_bucket(n_vis - npf, n - npf), True, 2, True, False, False,
        None, *rung, n_vis=n_vis)
    p, a, sh, nv = _bench_common.demo_prompts(np.random.RandomState(1), n, s)
    noise = jax_uniform_noise(keys[0], n - npf)
    prompts = bench.on_device(torch.device('cpu'), p, a, sh, nv, noise)
    fp = tfv.stack_vmae_params(tm, sd, torch.float32, 'cpu')
    ty, tf, tmask = bench.dispatch(tm, fp, tr, t(x), prompts, rung, 2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)


def test_latency_cold_prediction_matches_jax(small_pair):
    (jm, params, _, _), (tm, sd, _) = small_pair
    module = tvmae.PretrainVisionTransformerModule(tm, device='cpu')
    module.load_state_dict(sd, strict=True)
    mask = latency_bench.cold_mask(tm)
    n_vis = int((~mask).sum())
    x = np.random.RandomState(2).rand(1, 2, 3, 32, 32).astype(np.float32)
    ref = jpred.predict_video(jm, params, jnp.asarray(x), jnp.asarray(mask),
                              n_vis, True, 1)
    out = latency_bench.cold_prediction(module, t(x), t(mask), n_vis)
    assert tuple(out.shape) == ref.shape
    assert_close(out.numpy(), ref, 2e-4, 1e-4)


def _one_json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


# the JAX bench's record (bench.py:402-434), MFU renamed
BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'config', 'stages',
              's_scaling', 'rungs', 'tflops_per_dispatch', 'mfu_executed',
              'exact_equivalent_tflops_per_s'}
BENCH_CONFIG = {'b', 's', 'hw', 'n_vis_f1', 'engine', 'raft_iters', 'model',
                'prefix_pool', 'suffix_pool', 'gelu', 'library_default',
                'backend', 'mesh'}


def test_bench_main_on_cpu(monkeypatch, capsys):
    for k, v in dict(CWM_BENCH_MODEL='tiny', CWM_BENCH_RAFT_ITERS='1',
                     CWM_BENCH_SBIG='3').items():
        monkeypatch.setenv(k, v)
    rec = bench.main(['--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    assert BENCH_KEYS <= set(rec) and BENCH_CONFIG <= set(rec['config'])
    assert rec['value'] > 0 and rec['config']['s'] in (2, 3)
    assert set(rec['s_scaling']) == {'s2', 's3'}
    assert set(rec['stages']) == {'prefix_ms', 'suffix_ms', 'raft_ms'}
    assert all(v > 0 for v in rec['stages'].values())
    # grid 8 at the tiny model: the default is the exact rung (pooling
    # starts at grid 24), the ladder adds the three pooled rungs
    assert rec['config']['engine'] == 'shared-prefix/default:exact-numerics'
    assert set(rec['rungs']) == {
        's', 'fidelity_ref', 'exact-numerics', 'pooled2+suffix2+tanh',
        'pooled4+suffix4', 'pooled4+suffix4+tanh'}
    assert rec['config']['hw'] == 64
    tf = rec['tflops_per_dispatch']
    assert tf['exact_equivalent'] == tf['executed'] > 0
    assert rec['mfu_executed'] is None        # no card: no device metric
    assert len(rec['window_ms']) == 3
    assert set(rec['launches_per_dispatch']) == {
        'flash_attention', 'flash_attention_prefix',
        'flash_attention_prefix_packed', 'flash_attention_lse',
        'flash_attention_bwd', 'window_lookup', 'add_layer_norm',
        'qkv_heads'}


def test_bench_sweep_one_size(monkeypatch, capsys):
    for k, v in dict(CWM_BENCH_MODEL='tiny', CWM_BENCH_RAFT_ITERS='1',
                     CWM_BENCH_RUNGS='0', OMP_NUM_THREADS='1').items():
        monkeypatch.setenv(k, v)
    report = bench_sweep.main(['--sizes', '2', '--device', 'cpu'])
    assert _one_json_line(capsys) == report
    (row,) = report['rows']
    assert row['s'] == 2 and row['sims_per_sec'] > 0
    assert set(row) == {'s', 'sims_per_sec', 'mfu_executed', 'stages',
                        'config'}
    assert row['config']['s'] == 2 and row['config']['backend'] == 'cpu'


def test_latency_bench_main_on_cpu(capsys):
    rec = latency_bench.main(['--model', 'tiny', '--iters', '3', '--imu',
                              '--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    pct = {'p50_ms', 'p90_ms', 'p99_ms', 'lats_ms'}
    assert {'metric', 'iters', 'unit'} | pct <= set(rec)
    for sec in ('warm_prefix', 'warm_prefix_imu'):
        assert pct | {'note'} <= set(rec[sec])
        assert len(rec[sec]['lats_ms']) == 3 and rec[sec]['p50_ms'] > 0
    assert rec['p50_ms'] <= rec['p90_ms'] <= rec['p99_ms']


def test_bench_conjoined_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv('CWM_BENCH_RAFT_ITERS', '1')
    rec = bench_conjoined.main(['--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    assert {'metric', 'unit', 'config', 'value', 'exact_sims_per_sec',
            'speedup_vs_exact', 'stages'} <= set(rec)
    assert {'model', 's', 'hw', 'raft_iters', 'backend', 'mesh',
            'engine'} <= set(rec['config'])
    assert rec['value'] > 0 and rec['exact_sims_per_sec'] > 0
    assert rec['config']['model'] == 'small' and rec['config']['hw'] == 112
    assert set(rec['stages']) == {'prefix_ms', 'suffix_ms', 'raft_ms'}


def test_bench_attention_main_on_cpu(capsys):
    rec = bench_attention.main(['--s', '2', '--heads', '2', '--queries',
                                '40', '--prefix', '24', '--head-dim', '16',
                                '--iters', '1', '--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    assert {'workload', 'backend', 'flops_per_call_tf', 'rows'} <= set(rec)
    assert set(rec['rows']) == {'ours', 'ours-two-source', 'sdpa', 'plain'}
    for name, row in rec['rows'].items():
        assert row['ms'] > 0 and row['tflops_per_s'] >= 0
        # f32 on the CPU: every candidate is the same attention
        assert row['max_abs_err_vs_plain_f32'] < 1e-5, name


def test_bench_train_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv('CWM_TRAIN_BENCH_FAMILIES',
                       'vmae,loader,cmae,conjoined,raft')
    monkeypatch.setenv('CWM_TRAIN_BENCH_MODEL', 'tiny')
    monkeypatch.setenv('CWM_TRAIN_BENCH_STEPS', '1')
    out, head = bench_train.main(['--device', 'cpu'])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert lines == json.loads(json.dumps(out['results'] + [head]))
    fams = [r['family'] for r in out['results']]
    assert fams == ['vmae_tiny', 'vmae_base_loader_in_loop', 'cmae_tiny',
                    'conjoined_imu', 'raft']
    for r in out['results']:
        assert r['sec_per_step'] > 0 and r['total_sec'] >= 0
        if 'train_flops_per_step' in r:
            assert r['train_flops_per_step'] > 0 and r['mfu'] is None
    assert {'batch', 'accum_steps', 'remat', 'flash_bwd',
            'clips_per_sec'} <= set(out['results'][0])
    assert {'sec_per_step_synthetic', 'input_share'} <= set(out['results'][1])
    assert out['results'][4]['pairs_per_sec'] > 0
    assert head['metric'] == 'train_clips_per_sec' and head['value'] > 0
    with pytest.raises(ValueError, match='unknown family'):
        bench_train.run_family('vmae_xl', torch.device('cpu'), 1, 'tiny')


def test_bench_loader_main_on_cpu(capsys):
    rec = bench_loader.main(['--clips', '8', '--hw', '32', '--crop', '32',
                             '--batch', '2', '--seconds', '0.05',
                             '--threads', '1', '--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    assert {'metric', 'value', 'unit', 'speedup_vs_python'} <= set(rec)
    loaders = rec['results']['loaders']
    assert set(loaders) == {'python', 'python_u8', 'native_f32_t1',
                            'native_u8_t1', 'native_u8zc_t1'}
    assert all(v['clips_per_sec'] > 0 for v in loaders.values())
    assert {'native_f32_speedup_vs_python_f32',
            'native_u8_speedup_vs_python_u8'} <= set(rec['results'])
