"""The port's utils: micro-batching (held to the JAX package's semantics,
both implementations through the same checks), profiling, the backend
guard and the kernel-build cache."""
import json
import os
import sys
import threading
import time

import pytest
import torch

from counterfactualworldmodels_tpu.utils import batching as jbatching
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.utils import batching as tbatching
from counterfactualworldmodels_tpu_torch.utils import (backend_guard, cache,
                                                       profiling)

IMPLS = {'jax': jbatching, 'port': tbatching}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _threads(fns, stagger=0.01):
    ts = [threading.Thread(target=f) for f in fns]
    for th in ts:
        th.start()
        time.sleep(stagger)
    for th in ts:
        th.join(timeout=30)
        assert not th.is_alive()


def test_micro_batcher_merges_and_maps_results(impl):
    calls = []

    def dispatch(key, items):
        calls.append((key, list(items)))
        return [x * 10 for x in items]

    mb = impl.MicroBatcher(dispatch, window_s=0.25, max_items=8)
    results = {}
    _threads([lambda i=i: results.__setitem__(i, mb.run('k', i))
              for i in range(4)])
    assert results == {i: i * 10 for i in range(4)}
    assert len(calls) == 1 and sorted(calls[0][1]) == [0, 1, 2, 3]
    assert mb.batches == 1 and mb.batched_items == 4
    # distinct keys never merge
    calls.clear()
    _threads([lambda i=i: mb.run(f'k{i}', i) for i in range(2)], 0)
    assert len(calls) == 2


def test_micro_batcher_errors_reach_every_member(impl):
    def boom(key, items):
        raise RuntimeError('nope')

    mb = impl.MicroBatcher(boom, window_s=0.2)
    errs = []

    def worker():
        try:
            mb.run('k', 1)
        except RuntimeError as e:
            errs.append(str(e))

    _threads([worker] * 3)
    assert errs == ['nope'] * 3
    assert mb.batches == 0

    def short(key, items):
        return items[:-1]

    mb = impl.MicroBatcher(short, window_s=0.0)
    with pytest.raises(RuntimeError, match='results for'):
        mb.run('k', 1)


def test_micro_batcher_closes_at_the_cap(impl):
    calls = []

    def dispatch(key, items):
        calls.append(list(items))
        return list(items)

    mb = impl.MicroBatcher(dispatch, window_s=5.0, max_items=2)
    t0 = time.monotonic()
    _threads([lambda i=i: mb.run('k', i) for i in range(2)], 0)
    assert time.monotonic() - t0 < 4.0
    assert len(calls) == 1 and len(calls[0]) == 2


def test_micro_batcher_weight(impl):
    """max_items caps the total weight: an item that would push a batch
    over the cap leads a new one; 2 + 2 == 4 closes early at the cap."""
    calls = []

    def dispatch(key, items):
        calls.append(list(items))
        return list(items)

    mb = impl.MicroBatcher(dispatch, window_s=0.4, max_items=4,
                           weight=lambda it: it[1])
    out = {}
    _threads([lambda: out.__setitem__(0, mb.run('k', (0, 3))),
              lambda: out.__setitem__(1, mb.run('k', (1, 3)))], 0.05)
    assert len(calls) == 2 and all(len(c) == 1 for c in calls)
    assert out == {0: (0, 3), 1: (1, 3)}
    calls.clear()
    t0 = time.monotonic()
    _threads([lambda: mb.run('k', (2, 2)), lambda: mb.run('k', (3, 2))],
             0.05)
    assert len(calls) == 1 and sorted(calls[0]) == [(2, 2), (3, 2)]
    assert time.monotonic() - t0 < 0.39


def test_micro_batcher_under_contention(impl):
    """More threads than cores with a short switch interval: every item is
    answered with its own result, no dispatch exceeds the cap, and the
    counters add up (a lost update would break them)."""
    lock = threading.Lock()
    sizes = []

    def dispatch(key, items):
        with lock:
            sizes.append(len(items))
        return [(key, x) for x in items]

    mb = impl.MicroBatcher(dispatch, window_s=0.002, max_items=5)
    n = 4 * (os.cpu_count() or 2) + 3
    out = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _threads([lambda i=i: out.__setitem__(i, mb.run(i % 3, i))
                  for i in range(n)], 0)
    finally:
        sys.setswitchinterval(old)
    assert out == [(i % 3, i) for i in range(n)]
    assert max(sizes) <= 5 and sum(sizes) == n
    assert mb.batches == len(sizes) and mb.batched_items == n


def test_pad_to_bucket_matches_jax():
    for buckets in ((1, 2, 4, 8), (16, 1, 4), (3,), (1, 2, 4, 8, 16, 32, 64)):
        for n in range(0, 70):
            assert tbatching.pad_to_bucket(n, buckets) == \
                jbatching.pad_to_bucket(n, buckets)
    assert tbatching.pad_to_bucket(9, (1, 2, 4, 8)) == 8


def test_span_registry_and_metrics_logger(tmp_path):
    x = torch.ones(4)
    with profiling.collect() as col:
        with profiling.span('a'):
            (x * 2).sum()
        with profiling.span('a'):
            pass
        with profiling.span('b'):
            time.sleep(0.01)
    s = col.totals()
    assert s['a']['count'] == 2 and s['b']['count'] == 1
    assert s['b']['host_s'] >= 0.01 and s['b']['device_s'] >= 0.01
    assert [r.name for r in col.records] == ['a', 'a', 'b']
    path = tmp_path / 'm.jsonl'
    log = profiling.MetricsLogger(str(path))
    log.log(1, loss=torch.tensor(0.5), note='warm')
    log.log(2, loss=0.25)
    lines = [json.loads(v) for v in path.read_text().splitlines()]
    assert [r['step'] for r in lines] == [1, 2]
    assert lines[0]['loss'] == 0.5 and lines[0]['note'] == 'warm'
    assert set(lines[1]) == {'step', 'time', 'loss'}
    assert log.history == lines
    profiling.device_sync()
    profiling.device_sync(torch.zeros(2))      # CPU tensors: nothing to wait


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 't')) as d:
        torch.ones(8).sum()
    traces = os.listdir(d)
    assert len(traces) == 1 and traces[0].endswith('.json')
    w = profiling.StepTraceWindow(str(tmp_path / 'w'), first_step=0,
                                  warm_steps=1, num_steps=1)
    for step in range(4):
        w.tick(step)
        torch.ones(4).sum()
    w.close()
    assert len(os.listdir(tmp_path / 'w')) == 1
    profiling.StepTraceWindow(None, 0).tick(3)


def test_backend_guard_raises_without_a_gpu_unless_cpu_is_asked():
    backend_guard.ensure_live_backend('cpu')
    if torch.cuda.is_available():
        backend_guard.ensure_live_backend('cuda')
        return
    with pytest.raises(RuntimeError, match='no CUDA device answers'):
        backend_guard.ensure_live_backend('cuda')


def test_enable_persistent_cache_raises_when_the_build_fails(tmp_path,
                                                             monkeypatch):
    """The build runs in the directory given, and its failure raises (the
    JAX package's cache setup swallows every exception)."""
    monkeypatch.setattr(kernels, 'BUILD_DIR', kernels.BUILD_DIR)
    fake = tmp_path / 'cuda' / 'bin'
    fake.mkdir(parents=True)
    (fake / 'nvcc').write_text('#!/bin/sh\necho "nvcc: no GPU here" >&2\n'
                               'exit 1\n')
    (fake / 'nvcc').chmod(0o755)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'cuda'))
    build = tmp_path / 'build'
    with pytest.raises(RuntimeError, match='kernel build failed'):
        cache.enable_persistent_cache(str(build))
    assert kernels.BUILD_DIR == str(build)
    assert os.path.dirname(kernels.library_path('attention')) == str(build)
    assert not [f for f in os.listdir(build) if f.endswith('.so')]
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'none'))
    monkeypatch.setenv('PATH', str(tmp_path / 'none'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        cache.enable_persistent_cache()
