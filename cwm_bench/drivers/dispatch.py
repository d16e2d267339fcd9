"""Counterfactual dispatches in a closed loop, through
``FlowGenerator.predict_counterfactual_videos_and_flows``.

Each call hands the generator a new seeded scene and ``num_samples``
prompts of the demo policy (traffic/prompts.py) as masks and shifts, with
``sample_batch_size`` samples a chunk; one caller waits for each call's
videos and flows before it sends the next. ``sims_per_s`` is the samples
returned over the window's seconds.

The output check holds the videos and flows of two calls of the window
against the plain reference: every sample of the last call, and
``check_rows`` samples, drawn from the seed, of a call drawn from the
seed among the first three.

The traced run times RAFT-24 alone on the last call's videos through the
port's public ``apply_raft_shared0``, and profiles dispatches of scenes
that no call before them showed, so that the generator's prefix cache
misses as it does in every call of the window.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from cwm_bench import tracing, weights
from cwm_bench.drivers import merge_worst, port_raft, port_vmae
from cwm_bench.harness import Window
from cwm_bench.reference import cf as ref_cf
from cwm_bench.traffic import prompts as traffic_prompts

POOL = 48          # distinct calls drawn before the window; then they repeat


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


class Run:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from counterfactualworldmodels_tpu_torch.pipelines.segmentation \
            import FlowGenerator
        self.cfg, self.traffic = config, traffic
        self.seed, self.dev = seed, device
        v, r, rung = config['vmae'], config['raft'], config['rung']
        dtype = getattr(torch, config['dtype'])
        self.model = port_vmae(v, dtype)
        self.raft = port_raft(r, weights.raft_config_state_dict(r, seed,
                                                                device),
                              dtype, device)
        self.gen = FlowGenerator(
            predictor=self.model,
            params=weights.vmae_state_dict(v, seed, device),
            flow_model=self.raft,
            raft_iters=r['iters'], imagenet_normalize_inputs=True,
            prefix_pool=rung['prefix_pool'], suffix_pool=rung['suffix_pool'],
            fast_gelu=rung['gelu'], seed=seed % (2 ** 31), device=device)
        self.s = traffic['num_samples']
        self.profile_units = 1
        # POOL calls for the warm-up and the window, then an unseen scene
        # for each profiled dispatch, the profiler's warm-up's included
        self.calls = [self._draw(c) for c in range(
            POOL + tracing.PASSES * self.profile_units)]
        # shifts as the [2, S] host array the generator takes
        self.shifts = [p.shifts.T.cpu().numpy() for p in self.calls]
        self.kept_call, self.rows = judged(seed, traffic, device)
        self.kept = {}
        self.profiled = 0

    def _draw(self, c: int):
        v, t = self.cfg['vmae'], self.traffic
        return traffic_prompts.draw(self.seed, c, v['img_size'],
                                    v['img_size'] // v['patch_size'], self.s,
                                    t['passive'], t['max_shift'], self.dev)

    def call(self, c: int):
        """Call ``c`` of the warm-up or the window: its prompts repeat
        after POOL calls."""
        return self._dispatch(c % POOL)

    def _dispatch(self, i: int):
        p = self.calls[i]
        videos, flows = self.gen.predict_counterfactual_videos_and_flows(
            p.scene, active_patches=p.active_mask,
            passive_patches=p.passive_mask,
            shifts=self.shifts[i], num_samples=self.s,
            sample_batch_size=self.traffic['sample_batch_size'],
            fix_passive=True)
        return videos, flows

    def warmup(self):
        for c in range(self.traffic['warmup_calls']):
            self.call(POOL - 1 - c)
            _sync(self.dev)

    def window(self, seconds: float) -> Window:
        n = 0
        t0 = time.perf_counter()
        while True:
            videos, flows = self.call(n)
            _sync(self.dev)
            if n == self.kept_call:
                self.kept[n] = (videos[self.rows], flows[self.rows, 0])
            n += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        # the last call whole, copied in case the program reuses its buffers
        self.kept['last'] = (n - 1, (videos.clone(), flows[:, 0].clone()))
        sims = n * self.s
        return Window(units=n, seconds=elapsed, attempted=sims, failed=0,
                      metrics={'sims_per_s': sims / elapsed})

    # -- trace run --------------------------------------------------------
    def stage_spans(self) -> Dict[str, float]:
        """ms of RAFT-24 alone on the last call's videos, by CUDA events
        around repeated calls of the port's public flow probe."""
        from counterfactualworldmodels_tpu_torch.models.raft.raft import \
            apply_raft_shared0
        video = self.kept['last'][1][0]
        iters = self.cfg['raft']['iters']
        return {'raft_ms': _time_ms(
            lambda: apply_raft_shared0(self.raft, video, iters, True), 3,
            self.dev)}

    def profiled_unit(self):
        """A dispatch of a scene that the prefix cache has never held."""
        self._dispatch(POOL + self.profiled)
        self.profiled += 1

    # -- output check ------------------------------------------------------
    def check(self) -> Dict[str, float]:
        kept = dict(self.kept)
        last_n, last_out = kept.pop('last')
        kept.pop(last_n, None)
        everyone = torch.arange(self.s, device=self.dev)
        judged_calls = [(c, self.rows, out) for c, out in kept.items()]
        judged_calls.append((last_n, everyone, last_out))
        del self.gen, self.calls, self.kept, self.raft
        gc.collect()
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()
        sd_vmae = weights.vmae_state_dict(self.cfg['vmae'], self.seed,
                                          self.dev)
        sd_raft = weights.raft_config_state_dict(self.cfg['raft'], self.seed,
                                                 self.dev)
        worst: Dict[str, float] = {}
        for c, rows, (videos, flows) in judged_calls:
            p = self._draw(c % POOL)
            prompts = (p.scene, p.active[rows], p.passive[rows],
                       p.shifts[rows])
            merge_worst(worst, ref_cf.judge(self.cfg, sd_vmae, sd_raft,
                                            prompts, videos, flows))
        return worst


def _time_ms(fn, n: int, dev) -> float:
    with torch.no_grad():
        fn()
        _sync(dev)
        if dev.type != 'cuda':
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) * 1e3 / n
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n


def judged(seed: int, traffic: Dict, device):
    """(the call among the first three whose outputs are judged besides the
    last one, that call's judged sample rows), drawn from the seed."""
    g = torch.Generator(device='cpu').manual_seed(
        traffic_prompts.call_seed(seed, 0, 3))
    first = int(torch.randint(0, 3, (1,), generator=g))
    rows = torch.randperm(traffic['num_samples'], generator=g)[
        :traffic['check_rows']].sort().values.to(device)
    return first, rows


def control(config: Dict, traffic: Dict, seed: int, device
            ) -> Dict[str, float]:
    """The output check's numbers with the float8 reference in the
    program's place, on the prompts of two calls of a run of this seed:
    the early call's judged rows, and every row of a later one."""
    first, rows = judged(seed, traffic, device)
    v = config['vmae']
    sd_vmae = weights.vmae_state_dict(v, seed, device)
    sd_raft = weights.raft_config_state_dict(config['raft'], seed, device)
    worst: Dict[str, float] = {}
    everyone = torch.arange(traffic['num_samples'], device=device)
    for c, rows in ((first, rows), (first + 5, everyone)):
        p = traffic_prompts.draw(seed, c, v['img_size'],
                                 v['img_size'] // v['patch_size'],
                                 traffic['num_samples'], traffic['passive'],
                                 traffic['max_shift'], device)
        prompts = (p.scene, p.active[rows], p.passive[rows], p.shifts[rows])
        video, flow = ref_cf.control_outputs(config, sd_vmae, sd_raft,
                                             prompts)
        merge_worst(worst, ref_cf.judge(config, sd_vmae, sd_raft, prompts,
                                        video, flow))
    return worst
