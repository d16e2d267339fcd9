"""The port's span registry (utils/profiling.py): the shared no-op when
off, parents, requests and self time, the profiler ranges, and the spans
and counters of a tiny counterfactual dispatch and training step."""
import json
import time

import numpy as np
import pytest
import torch

from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models import vmae
from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
from counterfactualworldmodels_tpu_torch.pipelines.segmentation import \
    FlowGenerator
from counterfactualworldmodels_tpu_torch.training import train as TT
from counterfactualworldmodels_tpu_torch.utils import profiling, weights

TINY = dict(img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=32,
            encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=16,
            decoder_depth=1, decoder_num_heads=2)


def test_span_off_is_the_shared_noop():
    assert profiling.span('a') is profiling.NO_SPAN
    assert profiling.span('b', request=True) is profiling.NO_SPAN
    with profiling.span('a') as rec:
        profiling.count('x')
    assert rec is None
    with profiling.collect() as col:
        pass
    assert col.records == [] and dict(col.counters) == {}
    # a closed collection leaves spans off again
    assert profiling.span('a') is profiling.NO_SPAN


def test_nested_spans_record_parents_requests_and_self_time():
    with profiling.collect() as col:
        for _ in range(2):
            with profiling.span('root', request=True):
                with profiling.span('stage'):
                    time.sleep(0.005)
                    with profiling.span('inner'):
                        time.sleep(0.01)
        with profiling.span('outside'):
            profiling.count('c', 2)
            profiling.count('c')
            kernels.LAUNCHES['window_lookup'] += 3
        with pytest.raises(RuntimeError, match='already open'):
            with profiling.collect():
                pass
    kernels.LAUNCHES['window_lookup'] -= 3
    recs = {(r.name, r.request): r for r in col.records}
    roots = [r for r in col.records if r.name == 'root']
    assert [r.request for r in roots] == [r.id for r in roots]
    assert len({r.request for r in roots}) == 2
    for root in roots:
        stage = recs[('stage', root.id)]
        inner = recs[('inner', root.id)]
        assert stage.parent == root.id and inner.parent == stage.id
        assert root.host_start <= stage.host_start <= inner.host_start
        assert inner.host_end <= stage.host_end <= root.host_end
    outside = recs[('outside', None)]
    assert outside.parent is None
    assert dict(col.counters) == {'c': 3, 'launches.window_lookup': 3}
    tot = col.totals()
    assert tot['inner']['count'] == tot['stage']['count'] == 2
    assert tot['inner']['host_s'] >= 0.02
    # on the CPU a span's device time is its host time
    for name in tot:
        assert tot[name]['device_s'] == tot[name]['host_s']
    stage = tot['stage']
    assert stage['self_host_s'] == pytest.approx(
        stage['host_s'] - tot['inner']['host_s'], abs=1e-9)
    assert stage['self_host_s'] >= 0.01
    assert tot['inner']['self_host_s'] == tot['inner']['host_s']


def test_stages_are_profiler_ranges_and_roots_are_not(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span('req.root', request=True):
            # under a profiler alone a stage opens its range and records
            # nothing
            with profiling.span('req.stage'):
                torch.ones(64).sum()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    names = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert 'req.stage' in names and 'req.root' not in names
    assert profiling.span('req.stage') is profiling.NO_SPAN


def _tiny_generator():
    cfg = vmae.PretrainVisionTransformer(**TINY)
    sd = weights.init_vmae_state_dict(cfg, torch.Generator().manual_seed(0))
    raft = weights.init_raft(RAFT(iters=2, device='cpu'),
                             torch.Generator().manual_seed(1))
    return cfg, FlowGenerator(predictor=cfg, params=sd, flow_model=raft,
                              raft_iters=2, imagenet_normalize_inputs=True,
                              prefix_pool=1, suffix_pool=1, seed=0,
                              device='cpu')


def _dispatch(gen, cfg, scene, s=4):
    g = torch.Generator().manual_seed(2)
    n0 = cfg.num_patches_per_frame
    active = torch.ones(1, 2 * n0, s, dtype=torch.bool)
    passive = torch.ones(1, 2 * n0, s, dtype=torch.bool)
    passive[:, :n0] = False                     # frame 0 visible
    for i in range(s):
        active[0, n0 + int(torch.randint(n0, (1,), generator=g)), i] = False
    shifts = np.array([[1, -1, 0, 2], [0, 1, -2, 1]])[:, :s]
    return gen.predict_counterfactual_videos_and_flows(
        scene, active_patches=active, passive_patches=passive,
        shifts=shifts, num_samples=s, sample_batch_size=s)


CF_STAGES = {'cf.dispatch': 1, 'cf.prompts': 3, 'cf.prefix_lookup': 1,
             'cf.suffix': 1, 'cf.suffix.encoder': 1, 'cf.suffix.decoder': 1,
             'cf.assemble': 3, 'cf.raft': 1, 'raft.encoders': 1,
             'raft.corr_pyramid': 1, 'raft.iterations': 1}
CF_SYNCS = {'host_sync.shifts_upload': 1, 'host_sync.shifts': 1,
            'host_sync.n_vis': 1, 'host_sync.fast_ok': 1,
            'host_sync.lru_key': 1, 'host_sync.normalize': 4,
            'host_sync.shift_scale': 1}


def test_tiny_dispatch_spans_and_host_syncs():
    """A dispatch of one chunk on a new scene: every stage of the engine,
    the prefix built under its lookup, the host's waits for the device (the
    frame-0 normalisation of the prefix only on a miss); on a repeat of the
    scene no build."""
    cfg, gen = _tiny_generator()
    scene = torch.rand(1, 2, 3, 32, 32, generator=torch.Generator()
                       .manual_seed(3))
    scene[:, 1] = scene[:, 0]
    with profiling.collect() as col:
        videos, flows = _dispatch(gen, cfg, scene)
    assert videos.shape == (4, 2, 3, 32, 32) and flows.shape[0] == 4
    tot = col.totals()
    assert {k: v['count'] for k, v in tot.items()} == dict(
        CF_STAGES, **{'cf.prefix_build': 1})
    assert {k: v for k, v in col.counters.items()
            if k.startswith('host_sync.')} == CF_SYNCS
    by_id = {r.id: r for r in col.records}
    (root,) = [r for r in col.records if r.name == 'cf.dispatch']
    assert all(r.request == root.id for r in col.records)
    for child, parent in (('cf.prefix_build', 'cf.prefix_lookup'),
                          ('cf.suffix.encoder', 'cf.suffix'),
                          ('cf.suffix.decoder', 'cf.suffix'),
                          ('raft.encoders', 'cf.raft'),
                          ('raft.corr_pyramid', 'cf.raft'),
                          ('raft.iterations', 'cf.raft')):
        (rec,) = [r for r in col.records if r.name == child]
        assert by_id[rec.parent].name == parent
    assert tot['cf.dispatch']['self_host_s'] >= 0
    with profiling.collect() as again:
        _dispatch(gen, cfg, scene)
    assert {k: v['count'] for k, v in again.totals().items()} == CF_STAGES
    assert {k: v for k, v in again.counters.items()
            if k.startswith('host_sync.')} == dict(CF_SYNCS,
                                                   **{'host_sync.normalize': 2})
    assert gen._prefix_lru.hits == 1 and gen._prefix_lru.misses == 1


@pytest.mark.parametrize('accum', [1, 2])
def test_tiny_train_step_spans(accum):
    cfg = vmae.PretrainVisionTransformer(**TINY)
    opt = TT.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                            total_steps=10)
    state = TT.init_train_state(cfg, opt, seed=1, device='cpu')
    masks, n_vis = TT.make_batch_masks(torch.Generator().manual_seed(0), cfg,
                                       2, 0.75)
    step = TT.make_train_step(cfg, opt, n_vis, remat=False, device='cpu',
                              accum_steps=accum)
    x = torch.rand(2, 2, 3, 32, 32)
    with profiling.collect() as col:
        state, met = step(state, x, masks)
    assert torch.isfinite(met['loss']) and state.step == 1
    counts = {k: v['count'] for k, v in col.totals().items()}
    assert counts == {'train.step': 1, 'train.forward': accum,
                      'train.backward': accum, 'train.update': 1}
    # the input normalisation's two tables, once per forward
    assert dict(col.counters) == {'host_sync.normalize': 2 * accum}
    (root,) = [r for r in col.records if r.name == 'train.step']
    assert all(r.request == root.id for r in col.records)
    assert all(r.parent == root.id for r in col.records if r is not root)


def test_dp_train_step_spans_the_allreduce():
    """The data-parallel step over a one-rank gloo group: the gradients'
    all-reduce is the span ``train.allreduce`` inside ``train.update``."""
    import socket

    import torch.distributed as dist

    from counterfactualworldmodels_tpu_torch.parallel import mesh as pmesh
    from counterfactualworldmodels_tpu_torch.parallel import multihost
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    multihost.initialize_distributed(f'tcp://localhost:{port}', 1, 0,
                                     device='cpu')
    try:
        cfg = vmae.PretrainVisionTransformer(**TINY)
        opt = TT.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                total_steps=10)
        state = TT.init_train_state(cfg, opt, seed=1, device='cpu')
        masks, n_vis = TT.make_batch_masks(
            torch.Generator().manual_seed(0), cfg, 2, 0.75)
        step, shard_state, _ = TT.make_sharded_train_step(
            cfg, opt, pmesh.make_mesh({'dp': 1}), n_vis, remat=False,
            device='cpu')
        state = shard_state(state)
        with profiling.collect() as col:
            state, met = step(state, torch.rand(2, 2, 3, 32, 32), masks)
    finally:
        dist.destroy_process_group()
    assert torch.isfinite(met['loss']) and state.step == 1
    counts = {k: v['count'] for k, v in col.totals().items()}
    assert counts == {'train.step': 1, 'train.forward': 1,
                      'train.backward': 1, 'train.update': 1,
                      'train.allreduce': 1}
    (red,) = [r for r in col.records if r.name == 'train.allreduce']
    (upd,) = [r for r in col.records if r.name == 'train.update']
    assert red.parent == upd.id

