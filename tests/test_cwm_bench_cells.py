"""The benchmark's IMU-conditioned cell on the CPU at a tiny size: the
port's ``ImuConditionedFlowGenerator`` fast dispatch against the plain
conjoined reference (cwm_bench/reference/conjoined.py) in f32 and bf16, the
float8 control failing the check, the conjoined engine's spans and
host-wait counters, and the conjoined FLOP counts against torch's FLOP
counter."""
import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from counterfactualworldmodels_tpu_torch.models import fast_conjoined
from counterfactualworldmodels_tpu_torch.utils import profiling
from cwm_bench import harness
from cwm_bench.counts import attention, conjoined
from cwm_bench.drivers import imu_dispatch

SEED = 2 ** 33 + 20          # wider than 32 bits, as the driver's are

MAIN = dict(is_imu=False, img_size=128, patch_size=16, in_chans=3,
            num_frames=2, tubelet_size=1, encoder_embed_dim=48,
            encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
            decoder_depth=2, decoder_num_heads=4, decoder_num_classes=768,
            mlp_ratio=2.0, qkv_bias=True, sequence_length=400,
            imu_tubelet=16, concat_dummy_token=True, padded=True,
            max_padding_tokens=8, min_padding_tokens=0)
CTX = dict(MAIN, is_imu=True, in_chans=6, sequence_length=48, imu_tubelet=8,
           encoder_embed_dim=32, decoder_embed_dim=24, decoder_num_classes=48,
           concat_dummy_token=False, max_padding_tokens=6)
IMU_TRAFFIC = dict(num_samples=4, sample_batch_size=4, passive=8,
                   warmup_calls=1, check_rows=3)


def imu_cell(dtype='float32', **traffic) -> harness.Cell:
    """cf-imu400-s256 cut to a tiny conjoined model (both streams padded,
    cross blocks before encoder layers 0 and 1 and after decoder layers 0
    and 1), RAFT at 2 iterations."""
    cell = harness.load_cell('cf-imu400-s256')
    cfg = copy.deepcopy(cell.config)
    cfg.update(dtype=dtype, main=MAIN, context=CTX,
               conjoin_encoder_layers=[[0, 0], [-1, -1]],
               conjoin_decoder_layers=[[0, 0], [1, 1]])
    cfg['raft'] = dict(cfg['raft'], iters=2)
    spec = copy.deepcopy(cell.spec)
    spec['traffic'].update(IMU_TRAFFIC, **traffic)
    return harness.Cell(cell.name, cell.workload, spec, cfg, cell.end_to_end,
                        cell.per_layer)


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.3, trace, device='cpu')


def test_imu_dispatch_f32_matches_the_reference():
    """The fast route in f32 agrees with the plain reference to round-off;
    the traced run reads every *.imu metric that needs no device trace."""
    result = _run(imu_cell(), trace=True)
    checks = {k: c['value'] for k, c in result['checks'].items()}
    assert result['correct'] is True, checks
    assert checks['pred_rel_err'] <= 1e-4
    assert checks['flow_gap_bf16x'] <= 1e-2
    assert checks['flow_full_gap_bf16x'] <= 1e-2
    assert checks['copy_max_abs'] == 0.0
    assert {'suffix_ms.imu', 'cross_ms.imu', 'raft_ms.imu',
            'host_syncs.imu', 'mfu.imu'} <= set(result['metrics'])
    assert result['metrics']['host_syncs.imu']['value'] == 20


def test_imu_dispatch_bf16_within_the_cells_limits():
    cell = imu_cell('bfloat16')
    result = _run(cell)
    assert result['correct'] is True, result['checks']
    assert set(result['checks']) == set(cell.spec['limits'])
    assert set(result['metrics']) == {'sims_per_s', 'setup_s'}


def test_imu_float8_control_fails_a_limit():
    cell = imu_cell()
    got = imu_dispatch.control(cell.config, cell.spec['traffic'], SEED,
                               torch.device('cpu'))
    limits = cell.spec['limits']
    assert any(not got[k] <= limits[k] for k in limits), got


def test_imu_fault_prediction_altered(monkeypatch):
    """One sample's predicted patches altered where the engine's decoder
    suffix returns them."""
    real = fast_conjoined._suffix_decoder

    def altered(*a, **k):
        y = real(*a, **k).clone()
        y[0] = y[0] * 1.1
        return y

    monkeypatch.setattr(fast_conjoined, '_suffix_decoder', altered)
    assert _run(imu_cell(check_rows=4))['correct'] is False


def test_imu_route_is_asserted():
    """A generator that takes the exact path fails the warm-up."""
    cell = imu_cell()
    run = imu_dispatch.Run(cell.config, cell.spec['traffic'], SEED,
                           torch.device('cpu'))
    run.gen.engine = 'exact'
    with pytest.raises(RuntimeError, match='cf.suffix.cross'):
        run.warmup()


IMU_STAGES = {'cf.dispatch': 1, 'cf.prompts': 3, 'cf.prefix_lookup': 1,
              'cf.prefix_build': 1, 'cf.assemble': 3, 'cf.suffix': 1,
              'cf.suffix.encoder': 1, 'cf.suffix.cross': 4,
              'cf.suffix.context': 5, 'cf.suffix.decoder': 1, 'cf.raft': 1,
              'raft.encoders': 1, 'raft.corr_pyramid': 1,
              'raft.iterations': 1}
IMU_SYNCS = {'host_sync.shifts_upload': 1, 'host_sync.shifts': 1,
             'host_sync.n_vis': 1, 'host_sync.frame0_clear': 1,
             'host_sync.ctx_visible': 1, 'host_sync.lru_key': 2,
             'host_sync.normalize': 8, 'host_sync.shift_scale': 1,
             'host_sync.frames': 4}


def test_imu_dispatch_spans_and_host_syncs():
    """The conjoined engine's stages under the plain engine's names, the
    cross blocks and the per-sample context stream inside the suffix, and
    the host waits of a dispatch of an unseen scene, then of a cached one
    (no prefix build, half the normalisation tables)."""
    cell = imu_cell()
    run = imu_dispatch.Run(cell.config, cell.spec['traffic'], SEED,
                           torch.device('cpu'))
    run.warmup()
    with profiling.collect() as col:
        run._dispatch(imu_dispatch.POOL)
    tot = col.totals()
    assert {k: v['count'] for k, v in tot.items()} == IMU_STAGES
    assert {k: v for k, v in col.counters.items()
            if k.startswith('host_sync.')} == IMU_SYNCS
    by_id = {r.id: r for r in col.records}
    for child, parent in (('cf.prefix_build', 'cf.prefix_lookup'),
                          ('cf.suffix.encoder', 'cf.suffix'),
                          ('cf.suffix.decoder', 'cf.suffix')):
        (rec,) = [r for r in col.records if r.name == child]
        assert by_id[rec.parent].name == parent
    parents = {by_id[r.parent].name for r in col.records
               if r.name in ('cf.suffix.cross', 'cf.suffix.context')}
    assert parents == {'cf.suffix.encoder', 'cf.suffix.decoder'}
    with profiling.collect() as again:
        run._dispatch(imu_dispatch.POOL)
    counts = {k: v['count'] for k, v in again.totals().items()}
    assert counts == {k: v for k, v in IMU_STAGES.items()
                      if k != 'cf.prefix_build'}
    assert again.counters['host_sync.normalize'] == 4
    assert again.counters['host_sync.frames'] == 2


def test_conjoined_counts_match_torchs_flop_counter():
    """The conjoined FLOP count of a dispatch equals torch's count of the
    engine's prefix and suffix passes at a suffix width its bucket holds
    exactly (8 visible frame-1 tokens a sample), and the attention kernels'
    work is the prefix's K1 and the decoder's two-source calls."""
    cell = imu_cell(passive=7)
    cfg, s = cell.config, 4
    run = imu_dispatch.Run(cfg, cell.spec['traffic'], SEED,
                           torch.device('cpu'))
    w, fc = run.gen.predictor, fast_conjoined
    params = fc.cast_params(w.model, w.params, torch.float32, 'cpu')
    x0 = torch.rand(1, 3, 128, 128)
    clip = imu_dispatch.imu_clip(cfg, SEED, 0, torch.device('cpu'))
    vis = torch.stack([torch.randperm(64)[:8] for _ in range(s)])
    with FlopCounterMode(display=False) as counter:
        cache = fc.encode_conjoined_prefix(w.model, params, x0, clip)
        fc.predict_frame1_conjoined(w.model, params, cache,
                                    torch.rand(s, 3, 128, 128), vis)
    assert counter.get_total_flops() == conjoined.dispatch_flops(cfg, s, 8)
    ops, nbytes = conjoined.dispatch_kernels(cfg, s)
    k1 = attention.fwd(1, 4, 64, 12, [(1, 64)])[0] * 2 + attention.fwd(
        1, 4, 64, 8, [(1, 64)])[0] * 2
    k2 = attention.fwd(s, 4, 72, 8, [(1, 64), (s, 72)])[0] * 2
    assert ops == k1 + k2 and nbytes > 0

