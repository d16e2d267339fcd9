"""IMU-conditioned counterfactual dispatches in a closed loop, through
``ImuConditionedFlowGenerator.predict_counterfactual_videos_and_flows``.

The cell's configuration is a conjoined VMAE (``main`` and ``context``
StreamSpec groups, the cross blocks' layer pairs) probed by the
configuration's RAFT. Each call hands the generator a new seeded scene,
``num_samples`` prompts of the demo policy (traffic/prompts.py) and the
call's own IMU clip (N(0, 1), seeded) as the head motion, so no
head-motion model runs: the predictor's own wrapper fills the generator's
head-motion slot, which gives only the IMU token layout (25 tokens of 16 x
6 samples, as the released flow2imu's). One chunk of
``sample_batch_size`` samples, one caller waiting for each call. The
generator routes the chunk to the conjoined shared-prefix engine and then
RAFT; the first warm-up call asserts that route by its spans.
``sims_per_s`` is the samples returned over the window's seconds.

The output check holds two calls' videos and flows against the plain
conjoined reference (reference/conjoined.py) and the plain RAFT, as the
dispatch driver does. The traced run collects the program's spans and
counters over dispatches of unseen scenes (``stage_spans``) and profiles
more of them.
"""
from __future__ import annotations

import gc
import statistics
from typing import Dict

import torch

from cwm_bench import conjoined_weights, tracing, weights
from cwm_bench.drivers import merge_worst, port_raft
from cwm_bench.drivers.dispatch import POOL, Run as DispatchRun, _sync, judged
from cwm_bench.reference import conjoined as ref_conj
from cwm_bench.traffic import prompts as traffic_prompts
from cwm_bench.traffic.prompts import call_seed

STAGE_UNITS = 3    # unseen-scene dispatches whose spans the traced run reads
CLIP_STREAM = 6    # the generator stream of the calls' IMU clips


def port_conjoined(cfg: Dict, dtype: torch.dtype, attn_impl: str, device):
    """The port's ConjoinedVMAE for the configuration's stream groups
    (square ``img_size`` and ``patch_size`` given as one number)."""
    from counterfactualworldmodels_tpu_torch.models import conjoined as conj

    def spec(group):
        g = dict(group)
        g['img_size'] = (g['img_size'],) * 2
        g['patch_size'] = (g['patch_size'],) * 2
        return conj.StreamSpec(**g)

    return conj.ConjoinedVMAE(
        main=spec(cfg['main']), context=spec(cfg['context']),
        conjoin_encoder_layers=[tuple(p) for p in
                                cfg['conjoin_encoder_layers']],
        conjoin_decoder_layers=[tuple(p) for p in
                                cfg['conjoin_decoder_layers']],
        cross_num_heads=cfg['cross_num_heads'],
        cross_mlp_ratio=cfg['cross_mlp_ratio'], dtype=dtype,
        attn_impl=attn_impl, device=device)


def imu_clip(cfg: Dict, seed: int, call: int, device) -> torch.Tensor:
    """Call ``call``'s IMU clip [1, C, L], N(0, 1)."""
    c = cfg['context']
    g = torch.Generator(device=device)
    g.manual_seed(call_seed(seed, call, CLIP_STREAM))
    return torch.randn(1, c['in_chans'], c['sequence_length'], generator=g,
                       device=device)


def head_motion(clip: torch.Tensor, tubelet: int) -> torch.Tensor:
    """The clip [B, C, T*pt] in the generator's head-motion layout, IMU
    tokens [B, T, pt*C] (einops 'b c (t pt) -> b t (pt c)')."""
    b, c, length = clip.shape
    t = length // tubelet
    return clip.reshape(b, c, t, tubelet).permute(0, 2, 3, 1).reshape(
        b, t, tubelet * c)


class Run(DispatchRun):
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from counterfactualworldmodels_tpu_torch.models.conjoined import \
            ConjoinedPredictorWrapper
        from counterfactualworldmodels_tpu_torch.pipelines.imu import \
            ImuConditionedFlowGenerator
        self.cfg, self.traffic = config, traffic
        self.seed, self.dev = seed, device
        r = config['raft']
        dtype = getattr(torch, config['dtype'])
        attn = 'flash' if device.type == 'cuda' else 'dense'
        model = port_conjoined(config, dtype, attn, device)
        wrapper = ConjoinedPredictorWrapper(
            model, params=conjoined_weights.conjoined_state_dict(
                config, seed, device),
            main_input='rgb01', context_input='imu')
        self.raft = port_raft(r, weights.raft_config_state_dict(r, seed,
                                                                device),
                              dtype, device)
        self.gen = ImuConditionedFlowGenerator(
            predictor=wrapper, head_motion_predictor=wrapper,
            flow_model=self.raft, raft_iters=r['iters'],
            imagenet_normalize_inputs=True, seed=seed % (2 ** 31),
            device=device)
        self.s = traffic['num_samples']
        self.profile_units = 1
        # POOL calls for the warm-up and the window, then an unseen scene
        # for each dispatch of stage_spans and of the profiler
        n = POOL + STAGE_UNITS + tracing.PASSES * self.profile_units
        self.calls = [self._draw(c) for c in range(n)]
        self.shifts = [p.shifts.T.cpu().numpy() for p in self.calls]
        pt = config['context']['imu_tubelet']
        self.heads = [head_motion(imu_clip(config, seed, c, device), pt)
                      for c in range(n)]
        self.kept_call, self.rows = judged(seed, traffic, device)
        self.kept = {}
        self.profiled = 0
        self.counters: Dict[str, float] = {}

    def _draw(self, c: int):
        m, t = self.cfg['main'], self.traffic
        return traffic_prompts.draw(self.seed, c, m['img_size'],
                                    m['img_size'] // m['patch_size'], self.s,
                                    t['passive'], t['max_shift'], self.dev)

    def _dispatch(self, i: int):
        p = self.calls[i]
        return self.gen.predict_counterfactual_videos_and_flows(
            p.scene, active_patches=p.active_mask,
            passive_patches=p.passive_mask, shifts=self.shifts[i],
            num_samples=self.s,
            sample_batch_size=self.traffic['sample_batch_size'],
            fix_passive=True, head_motion=self.heads[i])

    def warmup(self):
        """The warm-up calls; the first one under a span collection, which
        has to show the conjoined engine's cross blocks."""
        from counterfactualworldmodels_tpu_torch.utils import profiling
        with profiling.collect() as col:
            self.call(POOL - 1)
            _sync(self.dev)
        if 'cf.suffix.cross' not in col.totals():
            raise RuntimeError(
                'the dispatch did not run the conjoined shared-prefix '
                "engine's cross blocks (no span cf.suffix.cross)")
        for c in range(1, self.traffic['warmup_calls']):
            self.call(POOL - 1 - c)
            _sync(self.dev)

    # -- trace run --------------------------------------------------------
    def stage_spans(self) -> Dict[str, float]:
        """Medians over STAGE_UNITS dispatches of unseen scenes, each under
        its own span collection: the device ms of ``cf.suffix``, of all
        ``cf.suffix.cross`` together and of ``cf.raft``; the host waits
        (``host_sync.*``) of a dispatch go to ``counters``. A span the
        program lacks gives no entry."""
        from counterfactualworldmodels_tpu_torch.utils import profiling
        spans = {'suffix_ms': 'cf.suffix', 'cross_ms': 'cf.suffix.cross',
                 'raft_ms': 'cf.raft'}
        got = {k: [] for k in spans}
        syncs = []
        for u in range(STAGE_UNITS):
            with profiling.collect() as col:
                self._dispatch(POOL + u)
            tot = col.totals()
            for key, name in spans.items():
                if name in tot:
                    got[key].append(tot[name]['device_s'] * 1e3)
            syncs.append({k: v for k, v in col.counters.items()
                          if k.startswith('host_sync.')})
        self.counters = {k: statistics.median(s.get(k, 0) for s in syncs)
                         for k in set().union(*syncs)}
        return {k: statistics.median(v) for k, v in got.items() if v}

    def profiled_unit(self):
        """A dispatch of a scene that the prefix cache has never held."""
        self._dispatch(POOL + STAGE_UNITS + self.profiled)
        self.profiled += 1

    # -- output check ------------------------------------------------------
    def check(self) -> Dict[str, float]:
        kept = dict(self.kept)
        last_n, last_out = kept.pop('last')
        kept.pop(last_n, None)
        everyone = torch.arange(self.s, device=self.dev)
        judged_calls = [(c, self.rows, out) for c, out in kept.items()]
        judged_calls.append((last_n, everyone, last_out))
        del self.gen, self.calls, self.kept, self.raft, self.heads
        gc.collect()
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()
        return _judge(self.cfg, self.traffic, self.seed, self.dev,
                      [(c % POOL, rows, out)
                       for c, rows, out in judged_calls])


def _judge(cfg, traffic, seed, device, calls) -> Dict[str, float]:
    """The worst of ``judge`` over calls (c, rows, (videos, flows))."""
    m = cfg['main']
    sd = conjoined_weights.conjoined_state_dict(cfg, seed, device)
    sd_raft = weights.raft_config_state_dict(cfg['raft'], seed, device)
    worst: Dict[str, float] = {}
    for c, rows, (videos, flows) in calls:
        p = traffic_prompts.draw(seed, c, m['img_size'],
                                 m['img_size'] // m['patch_size'],
                                 traffic['num_samples'], traffic['passive'],
                                 traffic['max_shift'], device)
        prompts = (p.scene, p.active[rows], p.passive[rows], p.shifts[rows])
        merge_worst(worst, ref_conj.judge(cfg, sd, sd_raft, prompts,
                                          imu_clip(cfg, seed, c, device),
                                          videos, flows))
    return worst


def control(config: Dict, traffic: Dict, seed: int, device
            ) -> Dict[str, float]:
    """The output check's numbers with the float8 reference in the
    program's place, on the prompts of two calls of a run of this seed:
    the early call's judged rows, and every row of a later one."""
    first, rows = judged(seed, traffic, device)
    m = config['main']
    sd = conjoined_weights.conjoined_state_dict(config, seed, device)
    sd_raft = weights.raft_config_state_dict(config['raft'], seed, device)
    everyone = torch.arange(traffic['num_samples'], device=device)
    calls = []
    for c, rows in ((first, rows), (first + 5, everyone)):
        p = traffic_prompts.draw(seed, c, m['img_size'],
                                 m['img_size'] // m['patch_size'],
                                 traffic['num_samples'], traffic['passive'],
                                 traffic['max_shift'], device)
        prompts = (p.scene, p.active[rows], p.passive[rows], p.shifts[rows])
        calls.append((c, rows, ref_conj.control_outputs(
            config, sd, sd_raft, prompts, imu_clip(config, seed, c,
                                                   device))))
    return _judge(config, traffic, seed, device, calls)
