"""Port parity: the port's IMU-conditioned server (``ImuCwmService`` of
counterfactualworldmodels_tpu_torch.serve) against the JAX serving
script's, on the CPU.

The IMU-conditioned predictor is the tiny padded conjoined model of
tests/test_fast_conjoined.py (64 px, the serving script's tiny streams)
and flow2imu the same size with its 7-channel one-frame main stream; RAFT
runs 1 iteration. JAX-initialised weights are bridged by utils/weights.py;
the port's generator replays the JAX key schedule (``ImuDraws``) and its
service draws the multi-scene noise from the JAX script's keys. Both
servers answer the same requests over HTTP: a cold and a repeated
/counterfactual (the static IMU and the prefix cached), two concurrent
requests on different scenes over stacked conjoined caches, and
/movability at num_iters=1. PNGs within one uint8 step, raw maps within
1e-3, counters exactly.
"""
import os
import sys

import numpy as np
import pytest

from counterfactualworldmodels_tpu.pipelines import movability as jmov
from counterfactualworldmodels_tpu_torch import serve as tserve
from counterfactualworldmodels_tpu_torch.pipelines import movability as tmov

from torch_port_common import IMG, imu_wrappers
from test_torch_imu import ImuDraws
from test_torch_serve import (Server, assert_same_response,
                              jax_service_draws, png)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts'))
import serve as jserve  # noqa: E402

ARGS = dict(raft_iters=1, seed=0, engine='fast', prefix_cache_size=4,
            movability_samples=2, movability_iters=1)


@pytest.fixture(scope='module')
def servers():
    (jw, jfw, jr, rp), (tw, tfw, tr) = imu_wrappers(1)
    # the serving script's generator (build_imu_generator's final call)
    a = ARGS
    jg = jmov.make_imu_conditioned_movability_predictor()(
        predictor=jw, head_motion_predictor=jfw, flow_model=jr,
        flow_params=rp, raft_iters=a['raft_iters'],
        imagenet_normalize_inputs=True, seed=a['seed'], engine=a['engine'],
        prefix_cache_size=a['prefix_cache_size'],
        initialize_from_keypoints=False,
        num_initial_samples=a['movability_samples'],
        num_samples_per_iteration=a['movability_samples'],
        num_iters=a['movability_iters'],
        sample_batch_size=a['movability_samples'])
    tg = tserve.imu_movability_generator(
        tw, tfw, tr, type('Args', (), ARGS)(), device='cpu')
    assert isinstance(tg, tmov.MovabilityPredictor)
    ImuDraws(tg, a['seed'])
    kw = dict(engine='fast', batch_window_ms=500.0, max_scene_batch=8)
    js = Server(jserve.make_handler, jserve.ImuCwmService(jg, IMG, **kw))
    ts = Server(tserve.make_handler,
                jax_service_draws(tserve.ImuCwmService(tg, IMG, **kw)))
    yield js, ts
    js.close()
    ts.close()


def image(seed):
    """A smooth scene (random weights give finite but small flows on
    noise)."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(8, 8, 3)
    return np.kron(coarse, np.ones((IMG // 8, IMG // 8, 1))).round(3).tolist()


def test_imu_service_over_http_matches_jax(servers):
    js, ts = servers
    req = {'image': image(0), 'active': [[2, 3]], 'passive': [[5, 5]],
           'shift': [0, 1], 'num_samples': 2}
    for i in range(2):
        code, tout = ts.post('/counterfactual', req)
        jcode, jout = js.post('/counterfactual', req)
        assert code == jcode == 200
        assert tout['imu_conditioned'] is True and tout['engine'] == 'fast'
        assert tout['batched_samples'] == 2
        assert_same_response(tout, jout)
        seg = np.asarray(tout['segment_raw'])
        assert seg.shape == (IMG, IMG) and np.isfinite(seg).all()
        # flow2imu once for the scene; the prefix once, then a hit
        assert len(ts.service._imu_cache) == 1
        assert (ts.service.prefix_misses, ts.service.prefix_hits) == (1, i)

    mixed = [{'image': image(i), 'active': [[1, 6]], 'shift': [1, 1],
              'num_samples': 1} for i in (5, 6)]
    touts = ts.concurrent('/counterfactual', mixed)
    jouts = js.concurrent('/counterfactual', mixed)
    for (tc, to), (jc, jo) in zip(touts, jouts):
        assert tc == jc == 200 and to['scene_batched'] == 2
        assert_same_response(to, jo)

    code, tout = ts.post('/movability', {'image': image(0), 'iters': 1})
    jcode, jout = js.post('/movability', {'image': image(0), 'iters': 1})
    assert code == jcode == 200
    assert_same_response(tout, jout)
    m = np.asarray(tout['movability_raw'])
    assert m.shape == (IMG, IMG) and np.isfinite(m).all()
    assert png(tout['movability']).shape == (IMG, IMG, 3)
    # the scene's static IMU came from the cache: no flow2imu forward
    assert len(ts.service._imu_cache) == 3
    assert ts.post('/movability', {'image': image(0), 'iters': 'x'})[0] == 400

    tstats, jstats = ts.get('/stats')[1], js.get('/stats')[1]
    assert tstats == jstats
    assert tstats['micro_batching']['scene_batches'] == 1
    assert tstats['requests'] == 4
