"""Benchmark of the IMU-conditioned (conjoined) counterfactual workload.

Port of the JAX package's ``scripts/bench_conjoined.py``: the flagship
movability demo's predictor (the IMU-conditioned ViT-B 4x4 conjoined VMAE,
imu400) run through the counterfactual step on one card by both engines:

- fast: ``pipelines.imu._imu_counterfactual_step_fast`` (the conjoined
  shared-prefix engine; K1 in the prefix, K2 in the suffix decoder);
- exact: ``pipelines.imu._imu_counterfactual_step`` (S full conjoined
  forwards, K1 in every block),

each followed by RAFT (the window lookup every iteration), and reports
simulations per second for each, the speed-up and the per-stage ms of the
fast engine (prefix, suffix, RAFT). The demo prompt policy is bench's
(``_bench_common``); seeded random weights.

Timing: one warm call, then 3 windows of 6 dispatches (1 on the CPU), each
closed by one host fetch; the best window counts.

Env knobs: CWM_BENCH_S (default 16; 2 on the CPU), CWM_BENCH_RAFT_ITERS
(default 24), CWM_BENCH_MODEL=small (the small configuration; always on the
CPU). Under ``torchrun`` with WORLD_SIZE > 1 the samples split over the
ranks (``parallel.inference.sharded_imu_counterfactuals_fast`` and
``sharded_imu_counterfactuals``). There is no fallback: a failure raises.

    python -m counterfactualworldmodels_tpu_torch.scripts.bench_conjoined
    CWM_BENCH_RAFT_ITERS=1 python -m \\
        counterfactualworldmodels_tpu_torch.scripts.bench_conjoined \\
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .._device import resolve_device
from . import _bench_common as C


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--skip-exact', action='store_true',
                    help='time the fast engine only (the exact S = 16 '
                         'dispatch is ~5x the FLOPs)')
    ap.add_argument('--image', default=None,
                    help='.npy [H, W, 3] scene (or PNG / JPEG with PIL); '
                         'default: a seeded random movie')
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def build(small: bool, device: torch.device, raft_iters: int):
    """(wrapper, engine weights, RAFT) with seeded random weights: imu400
    (bf16, flash) or the small configuration (f32 dense on the CPU)."""
    from ..models import conjoined as conj
    from ..models import fast_conjoined as fc
    from ..models.raft.raft import RAFT
    from ..utils import weights
    cuda = device.type == 'cuda'
    dtype = torch.bfloat16 if cuda else torch.float32
    attn = 'flash' if cuda else 'dense'
    if small:
        model, hw = C.small_conjoined_model(dtype, attn, device)
    else:
        model, hw = conj.imu400_base_4x4patch_2frames_1tube(
            dtype=dtype, attn_impl=attn, device=device), 224
    g = torch.Generator(device=device)
    sd = weights.init_conjoined_state_dict(model, g.manual_seed(0))
    w = conj.ConjoinedPredictorWrapper(model, params=sd, main_input='rgb01',
                                       context_input='imu')
    raft = weights.init_raft(RAFT(iters=raft_iters, dtype=dtype,
                                  device=device), g.manual_seed(1))
    return w, fc.cast_params(model, sd, device=device), raft, hw


def main(argv=None):
    args = parse_args(argv)
    from .. import kernels
    from ..models import fast_conjoined as fc
    from ..models.raft.raft import apply_raft_shared0
    from ..ops.normalization import imagenet_normalize
    from ..pipelines.imu import (_imu_counterfactual_step,
                                 _imu_counterfactual_step_fast)
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    env = os.environ
    small = env.get('CWM_BENCH_MODEL') == 'small' or not cuda
    raft_iters = int(env.get('CWM_BENCH_RAFT_ITERS', 24))
    mesh, world, rank = C.sample_mesh(dev)
    w, fast_params, raft, hw = build(small, dev, raft_iters)
    model = w.model
    cfg = 'small' if small else 'imu400_base_4x4 (flagship)'

    s = int(env.get('CWM_BENCH_S', 16 if cuda else 2))
    if mesh is not None and s % world:
        s = max(world, s - s % world)
    n = model.main.num_patches
    n0 = n // 2
    rng = np.random.RandomState(args.seed)
    movie, source = C.demo_static_movie(hw, rng, image=args.image)
    x = torch.from_numpy(movie).to(dev)
    imu = torch.from_numpy((rng.randn(1, 6, model.context.sequence_length)
                            * 0.1).astype(np.float32)).to(dev)
    mask_c = torch.zeros((1, model.context.num_patches), dtype=torch.bool,
                         device=dev)
    p, a, sh, n_vis = C.demo_prompts(rng, n, s)
    passive, active, shifts, noise = C.as_tensors(
        dev, p, a, sh, C.demo_noise(s, n - n0))
    n_vis_c = w.context_n_vis(mask_c)

    @torch.no_grad()
    def fast():
        if mesh is not None:
            from ..parallel.inference import sharded_imu_counterfactuals_fast
            flows = sharded_imu_counterfactuals_fast(
                mesh, w, fast_params, raft, x, passive, active, shifts,
                noise, imu, mask_c, n_vis, True, raft_iters)[1]
        else:
            flows = _imu_counterfactual_step_fast(
                w, fast_params, raft, x, passive, active, shifts, noise, imu,
                mask_c, n_vis, True, raft_iters)[1]
        return flows.abs().float().sum()

    @torch.no_grad()
    def exact():
        # the demo prompts are one scene with frame 0 visible, so the
        # exact step may share RAFT's frame-0 passes
        if mesh is not None:
            from ..parallel.inference import sharded_imu_counterfactuals
            flows = sharded_imu_counterfactuals(
                mesh, w, raft, x, passive, active, shifts, noise,
                imu.repeat(s, 1, 1), mask_c.repeat(s, 1), n_vis, n_vis_c,
                True, raft_iters, True, shared0_ok=True)[1]
        else:
            flows = _imu_counterfactual_step(
                w, raft, x, passive, active, shifts, noise,
                imu.repeat(s, 1, 1), mask_c.repeat(s, 1), n_vis, n_vis_c,
                True, raft_iters, True, True)[1]
        return flows.abs().float().sum()

    per_window = 6 if cuda else 1

    def rate(fn):
        """(sims/s per card from the best window, one call's launches)."""
        fn().item()
        kernels.reset_launches()
        fn().item()
        launches = dict(kernels.LAUNCHES)
        return s / min(C.windows(fn, 3, per_window)) / world, launches

    rec = {
        'metric': 'conjoined (IMU-conditioned) counterfactual sims/sec/card',
        'unit': 'sims/sec/card',
        'config': dict({'model': cfg, 's': s, 'hw': hw,
                        'raft_iters': raft_iters, 'mesh': world,
                        'engine': 'conjoined shared-prefix',
                        'image': source}, **C.device_record(dev)),
    }
    fast_rate, rec['launches_fast'] = rate(fast)
    rec['value'] = round(fast_rate, 3)
    exact_rate = None
    if not args.skip_exact:
        exact_rate, rec['launches_exact'] = rate(exact)
    rec['exact_sims_per_sec'] = (None if exact_rate is None
                                 else round(exact_rate, 3))
    rec['speedup_vs_exact'] = (None if exact_rate is None
                               else round(fast_rate / exact_rate, 2))

    # per-stage ms of the fast engine (separate calls; small overhead each)
    xm = imagenet_normalize(x.expand(s, *x.shape[1:]), temporal_dim=1)
    x_m = xm.transpose(1, 2)
    vis1 = torch.from_numpy(np.stack([
        rng.choice(n0, 33, replace=False) for _ in range(s)])).to(dev)
    yv = torch.from_numpy(rng.rand(s, 2, 3, hw, hw).astype(np.float32)
                          ).to(dev)
    stage_iters = 6 if cuda else 1
    cache = fc.encode_conjoined_prefix(model, fast_params, x_m[0:1, :, 0],
                                       imu)
    rec['stages'] = {
        'prefix_ms': C.stage_ms(lambda: fc.encode_conjoined_prefix(
            model, fast_params, x_m[0:1, :, 0], imu), stage_iters),
        'suffix_ms': C.stage_ms(lambda: fc.predict_frame1_conjoined(
            model, fast_params, cache, x_m[:, :, 1], vis1), stage_iters),
        'raft_ms': C.stage_ms(lambda: apply_raft_shared0(
            raft, yv, raft_iters, True), stage_iters),
    }
    if rank == 0:
        if args.out:
            with open(args.out, 'w') as f:
                json.dump(rec, f, indent=1)
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    main()
