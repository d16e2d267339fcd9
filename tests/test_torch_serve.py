"""Port parity: the port's HTTP server (counterfactualworldmodels_tpu_torch
.serve) against the JAX package's serving script, on the CPU.

Both servers run the tiny serving configuration (32 px, 8x8 patches,
RAFT with 1 iteration) with JAX-initialised weights bridged by
utils/weights.py, and answer the same requests over real HTTP. The port's
generator replays the JAX generator's key schedule (``JaxDraws``) and the
port's service draws its rectangularizer noise from the JAX script's keys
(PRNGKey(seed + request counter), split per sample, padded by repetition),
so both build the same prompts. Decoded PNGs agree within one uint8 step,
``segment_raw`` within 1e-3, cache and batching counters exactly.

The deliberate differences are held here too: a failure inside the fast
engine is a 500 with the engine label unchanged (the JAX script degrades
to the exact engine), and warmup lets no failure through.
"""
import base64
import io
import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import segmentation as jseg
from counterfactualworldmodels_tpu_torch import serve as tserve
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.pipelines import segmentation as tseg
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import JaxDraws, jax_uniform_noise, t

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts'))
import serve as jserve  # noqa: E402

IMG = 32
# scripts/serve.py's tiny predictor
TINY_SERVE = dict(img_size=(IMG, IMG), patch_size=(8, 8),
                  encoder_embed_dim=96, encoder_depth=2, encoder_num_heads=2,
                  decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2,
                  mlp_ratio=2.0, qkv_bias=True, num_frames=2, tubelet_size=1)
_init_vmae = jax.jit(jvmae.init_params, static_argnums=0)
_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


@pytest.fixture(scope='module')
def nets():
    jm = jvmae.PretrainVisionTransformer(**TINY_SERVE)
    params = _init_vmae(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**TINY_SERVE)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    jr = jraft.RAFT(iters=1)
    rp = _init_raft(jr, jax.random.PRNGKey(1), IMG)
    tr = traft.RAFT(iters=1, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rp)), strict=True)
    return (jm, params, jr, rp), (tm, sd, tr)


def generators(nets, engine='fast', jax_draws=True):
    (jm, params, jr, rp), (tm, sd, tr) = nets
    kw = dict(raft_iters=1, imagenet_normalize_inputs=True, seed=0,
              engine=engine, prefix_cache_size=4)
    jg = jseg.FlowGenerator(predictor=jm, params=params, flow_model=jr,
                            flow_params=rp, **kw)
    tg = tseg.FlowGenerator(predictor=tm, params=sd, flow_model=tr,
                            device='cpu', **kw)
    if jax_draws:
        JaxDraws(tg, 0)
    return jg, tg


def jax_service_draws(svc):
    """The port service's noise from the JAX script's keys."""
    def draw(s_total, s_pad, n):
        keys = jax.random.split(
            jax.random.PRNGKey(svc.seed + svc._req_counter), s_total)
        if s_pad > s_total:
            keys = jnp.concatenate(
                [keys, jnp.repeat(keys[-1:], s_pad - s_total, 0)], 0)
        return t(jax_uniform_noise(keys, n))
    svc._draw_noise = draw
    return svc


class Server:
    """A ThreadingHTTPServer on a free port over a service."""

    def __init__(self, make_handler, service):
        self.service = service
        self.httpd = ThreadingHTTPServer(('127.0.0.1', 0),
                                         make_handler(service, 'cpu'))
        self.base = f'http://127.0.0.1:{self.httpd.server_address[1]}'
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.status, json.loads(r.read())

    def post(self, path, payload, raw=None):
        body = raw if raw is not None else json.dumps(payload).encode()
        req = urllib.request.Request(self.base + path, body,
                                     {'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def concurrent(self, path, payloads):
        """POST the payloads from threads, each after the previous one has
        joined the batcher's open batch (a fixed order of the batch)."""
        out = [None] * len(payloads)

        def go(i):
            out[i] = self.post(path, payloads[i])

        threads = []
        batcher = self.service._batcher
        for i in range(len(payloads)):
            th = threading.Thread(target=go, args=(i,))
            th.start()
            threads.append(th)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with batcher._lock:
                    n = sum(len(b['entries'])
                            for b in batcher._pending.values())
                if n == i + 1:
                    break
                time.sleep(0.005)
            else:
                raise AssertionError('request did not reach the batcher')
        for th in threads:
            th.join(timeout=600)
            assert not th.is_alive()
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def png(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def assert_same_response(tout, jout):
    """Same keys and flags; PNGs within one uint8 step; the raw segment
    within 1e-3."""
    assert set(tout) == set(jout)
    for k in tout:
        if k == 'segment_raw':
            np.testing.assert_allclose(np.asarray(tout[k]),
                                       np.asarray(jout[k]), atol=1e-3)
        elif k in ('simulation', 'flow_rgb', 'segment', 'prediction',
                   'movability'):
            a, b = png(tout[k]), png(jout[k])
            assert a.shape == b.shape
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, k
        elif k == 'movability_raw':
            np.testing.assert_allclose(np.asarray(tout[k]),
                                       np.asarray(jout[k]), atol=1e-3)
        else:
            assert tout[k] == jout[k], k


def image(seed, size=IMG):
    return np.random.RandomState(seed).rand(size, size, 3).round(3).tolist()


@pytest.fixture(scope='module')
def fast_servers(nets):
    jg, tg = generators(nets, 'fast')
    kw = dict(engine='fast', batch_window_ms=500.0, max_scene_batch=8)
    js = Server(jserve.make_handler, jserve.CwmService(jg, IMG, **kw))
    ts = Server(tserve.make_handler,
                jax_service_draws(tserve.CwmService(tg, IMG, **kw)))
    yield js, ts
    js.close()
    ts.close()


def test_fast_engine_over_http_matches_jax(fast_servers):
    """/health, /predict, a cold and a warm /counterfactual, two
    concurrent same-scene requests in one dispatch and two concurrent
    requests on new scenes in one mixed-scene dispatch, then /stats."""
    js, ts = fast_servers
    assert ts.get('/health') == (200, {'status': 'ok', 'backend': 'cpu'})
    img = image(0)
    code, tout = ts.post('/predict', {'image': img, 'active': [[1, 2]]})
    assert code == 200
    assert_same_response(tout, js.post('/predict', {'image': img,
                                                    'active': [[1, 2]]})[1])
    assert png(tout['prediction']).shape == (IMG, IMG, 3)

    req = {'image': img, 'active': [[2, 2]], 'passive': [[0, 1]],
           'shift': [0, 1], 'num_samples': 2}
    for hit in (False, True):
        code, tout = ts.post('/counterfactual', req)
        assert code == 200 and tout['prefix_cache_hit'] is hit
        assert_same_response(tout, js.post('/counterfactual', req)[1])
        seg = np.asarray(tout['segment_raw'])
        assert seg.shape == (IMG, IMG) and np.isfinite(seg).all()

    # same scene, two requests: one dispatch of 3 samples padded to 4
    same = [dict(req, num_samples=1, shift=[1, 0]),
            dict(req, num_samples=2, shift=[-1, 1])]
    touts = ts.concurrent('/counterfactual', same)
    jouts = js.concurrent('/counterfactual', same)
    for (tc, to), (jc, jo) in zip(touts, jouts):
        assert tc == jc == 200 and to['batched_samples'] == 4
        assert_same_response(to, jo)

    # two new scenes: one mixed-scene dispatch over stacked prefix caches
    mixed = [{'image': image(i), 'active': [[3, 1]], 'shift': [1, 1],
              'num_samples': 1} for i in (5, 6)]
    touts = ts.concurrent('/counterfactual', mixed)
    jouts = js.concurrent('/counterfactual', mixed)
    for (tc, to), (jc, jo) in zip(touts, jouts):
        assert tc == jc == 200 and to['scene_batched'] == 2
        assert to['prefix_cache_hit'] is False
        assert_same_response(to, jo)

    tstats, jstats = ts.get('/stats')[1], js.get('/stats')[1]
    assert tstats == jstats
    assert tstats['micro_batching']['dispatches'] == 4
    assert tstats['micro_batching']['requests_batched'] == 6
    assert tstats['micro_batching']['scene_batches'] == 1
    assert tstats['prefix_cache'] == {'hits': 2, 'misses': 3, 'size': 4}
    # the per-click route keeps its own LRU: one miss on the first image
    assert ts.service.G._prefix_lru.misses == 1


def test_exact_engine_over_http_matches_jax(nets):
    jg, tg = generators(nets, 'exact')
    kw = dict(engine='exact', batch_window_ms=0)
    js = Server(jserve.make_handler, jserve.CwmService(jg, IMG, **kw))
    ts = Server(tserve.make_handler, tserve.CwmService(tg, IMG, **kw))
    try:
        req = {'image': image(3), 'active': [[1, 1]], 'passive': [[2, 3]],
               'shift': [-1, 0], 'num_samples': 2}
        code, tout = ts.post('/counterfactual', req)
        assert code == 200
        assert set(tout) == {'simulation', 'flow_rgb', 'segment',
                             'segment_raw'}
        assert_same_response(tout, js.post('/counterfactual', req)[1])
        assert ts.get('/stats')[1] == js.get('/stats')[1]
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize('cap,scene_cap', [(64, 8), (48, 6), (5, 3), (1, 1)])
def test_buckets_match_jax(cap, scene_cap):
    g = types.SimpleNamespace(device=torch.device('cpu'))
    ts = tserve.CwmService(g, IMG, max_batch_samples=cap,
                           max_scene_batch=scene_cap)
    js = jserve.CwmService(g, IMG, max_batch_samples=cap,
                           max_scene_batch=scene_cap)
    assert tserve.CwmService._pow2_buckets(cap) == \
        jserve.CwmService._pow2_buckets(cap)
    assert ts._s_buckets == js._s_buckets
    assert ts._scene_buckets() == js._scene_buckets()


@pytest.mark.parametrize('shape', [(20, 17, 3), (3, 9, 13), (2, 2, 3),
                                   (48, 40, 3)],
                         ids=['rgb', 'grey-ish', 'tiny', 'wide'])
def test_png_writer_decodes_bitwise(shape):
    """The port's PNG writer (no PIL) against PIL's decoder: the decoded
    image equals the uint8 array; _png_b64 decodes as the JAX script's."""
    rng = np.random.RandomState(sum(shape))
    a = rng.randint(0, 256, shape).astype(np.uint8)
    if shape[-1] != 3:
        a = a[0]
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(tserve.encode_png(a)))), a)
    f = rng.rand(*a.shape).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(png(tserve._png_b64(f)),
                                  png(jserve._png_b64(f)))
    with pytest.raises(ValueError):
        tserve.encode_png(a.astype(np.float32))


@pytest.mark.parametrize('size', [(48, 40), (20, 24), (32, 32)],
                         ids=['down', 'up', 'same'])
def test_parse_image_resize_matches_jax(size):
    """_parse_image: HWC or CHW lists, resized as jax.image.resize's
    antialiased bilinear does."""
    g = types.SimpleNamespace(device=torch.device('cpu'))
    ts, js = tserve.CwmService(g, IMG), jserve.CwmService(g, IMG)
    a = np.random.RandomState(1).rand(*size, 3).astype(np.float32)
    for img in (a.tolist(), a.transpose(2, 0, 1).tolist()):
        tx = ts._parse_image({'image': img})
        jx = js._parse_image({'image': img})
        assert tuple(tx.shape) == jx.shape == (1, 3, IMG, IMG)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    with pytest.raises(ValueError, match='3 channels'):
        ts._parse_image({'image': np.zeros((4, 5, 6)).tolist()})


@pytest.fixture(scope='module')
def port_server(nets):
    _, tg = generators(nets, 'fast', jax_draws=False)
    ts = Server(tserve.make_handler, tserve.CwmService(
        tg, IMG, engine='fast', batch_window_ms=1.0))
    yield ts
    ts.close()


def test_malformed_requests_are_400(port_server):
    ts = port_server
    img = image(2)
    for path, payload, raw in (
            ('/counterfactual', None, b'{not json'),
            ('/counterfactual', None, b'[1, 2]'),
            ('/counterfactual', {'image': img}, None),
            ('/counterfactual', {'image': img, 'active': [[1, 1]],
                                 'num_samples': 0}, None),
            ('/counterfactual', {'image': img, 'active': [[1, 1]],
                                 'num_samples': 65}, None),
            ('/counterfactual', {'image': img, 'active': [[1, 1]],
                                 'shift': [1]}, None),
            ('/predict', {'image': [[0.1]]}, None),
            ('/predict', {'image': [[[0.1, 0.2]], [[0.3]]]}, None),
            ('/predict', {}, None)):
        code, out = ts.post(path, payload, raw)
        assert code == 400, (path, payload, raw, out)
    assert ts.post('/nope', {})[0] == 404
    assert ts.post('/movability', {'image': img})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(ts.base + '/nope', timeout=30)
    assert e.value.code == 404
    assert ts.service._req_counter == 0


def test_fast_engine_failure_is_a_500_and_keeps_the_engine(port_server,
                                                          monkeypatch):
    """The deliberate deviation: an exception inside the fast engine (a
    kernel's included) reaches the client as a 500; the service does not
    switch to the exact engine and serves the next request on 'fast'."""
    ts = port_server

    def broken(*args, **kwargs):
        raise RuntimeError('kernel launch failed')

    req = {'image': image(4), 'active': [[1, 1]], 'num_samples': 1}
    with monkeypatch.context() as m:
        m.setattr(tserve, 'counterfactual_videos_and_flows_fast', broken)
        code, out = ts.post('/counterfactual', req)
    assert code == 500 and 'kernel launch failed' in out['error']
    assert ts.service.engine == 'fast'
    assert ts.get('/stats')[1]['engine'] == 'fast'
    code, out = ts.post('/counterfactual', req)
    assert code == 200 and out['engine'] == 'fast'


def test_dispatch_runs_without_grad_on_handler_threads(port_server,
                                                      monkeypatch):
    """Grad mode is per thread: the service turns it off around its
    dispatches, whichever request thread leads the batch."""
    ts = port_server
    seen = []
    real = tserve.counterfactual_videos_and_flows_fast

    def spy(*args, **kwargs):
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_grad_enabled()))
        return real(*args, **kwargs)

    monkeypatch.setattr(tserve, 'counterfactual_videos_and_flows_fast', spy)
    assert torch.is_grad_enabled()
    code, out = ts.post('/counterfactual', {'image': image(7),
                                            'active': [[0, 3]]})
    assert code == 200 and seen == [(False, False)]


def test_warmup_restores_counters_and_draws(nets):
    """After warmup (every route and bucket, nothing swallowed) the
    service's counters, prefix caches and the generator's draws are as on
    a cold server, so a request computes what it would there."""
    outs = []
    for warm in (True, False):
        _, tg = generators(nets, 'fast', jax_draws=False)
        svc = tserve.CwmService(tg, IMG, engine='fast', batch_window_ms=1.0)
        if warm:
            warmed = svc.warmup(buckets=(1, 2), active_counts=(1, 5),
                                log=None)
            assert [r[:2] for r in warmed] == [
                ('predict', 1), ('counterfactual[fast]', 1),
                ('counterfactual[fast]', 1), ('counterfactual[fast]', 2),
                ('counterfactual[fast]', 2), ('mixed-scene', 2)]
            assert (svc._req_counter, svc.scene_batches, svc.prefix_misses,
                    tg._prefix_lru.misses, svc._batcher.batches) == \
                (0, 0, 0, 0, 0)
        out = svc.counterfactual({'image': image(8), 'active': [[1, 3]],
                                  'num_samples': 2})
        pred = svc.predict({'image': image(8), 'active': [[2, 2]]})
        outs.append((out, pred))
    assert outs[0] == outs[1]


def test_warmup_lets_failures_through(nets, monkeypatch):
    _, tg = generators(nets, 'fast', jax_draws=False)
    svc = tserve.CwmService(tg, IMG, engine='fast')

    def broken(*args, **kwargs):
        raise RuntimeError('kernel build failed')

    monkeypatch.setattr(tserve, 'counterfactual_videos_and_flows_fast',
                        broken)
    with pytest.raises(RuntimeError, match='kernel build failed'):
        svc.warmup(buckets=(1,), active_counts=(1,), log=None)
