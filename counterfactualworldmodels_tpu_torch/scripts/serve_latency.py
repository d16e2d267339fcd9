"""First-request latency per prompt size through the serving surface.

Port of the JAX package's ``scripts/serve_latency.py``: builds the port's
``serve.CwmService`` (shared-prefix engine), runs its startup warm-up over
the suffix-width buckets (``fast_vmae.sfx_bucket``), then sends ONE
counterfactual request per prompt size 1 .. ``--max-prompt`` and times
each. The port compiles nothing per shape, so the warm-up builds and loads
the kernels and touches every route; every size should then run at its
steady latency. The first request also pays the scene's prefix pass (a
service-LRU miss), the later ones hit the cache.

Prints one JSON object ({"serve_first_request_by_prompt_size": {...}}),
with each request's kernel launches; ``--out`` also writes it to a file.

    python -m counterfactualworldmodels_tpu_torch.scripts.serve_latency
    python -m counterfactualworldmodels_tpu_torch.scripts.serve_latency \\
        --max-prompt 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .._device import resolve_device
from ._bench_common import device_record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default=None,
                    help='tiny | base | large (default: large on the card, '
                         'tiny on the CPU)')
    ap.add_argument('--img-size', type=int, default=None,
                    help='default: 224 on the card, 32 on the CPU')
    ap.add_argument('--num-samples', type=int, default=4)
    ap.add_argument('--max-prompt', type=int, default=16)
    ap.add_argument('--raft-iters', type=int, default=24,
                    help='RAFT iterations on the card (1 on the CPU)')
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def log(msg):
    print(f'[serve_latency] {msg}', file=sys.stderr, flush=True)


def main(argv=None):
    args = parse_args(argv)
    from .. import kernels, serve
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    model = args.model or ('large' if cuda else 'tiny')
    img_size = args.img_size or (224 if cuda else 32)
    raft_iters = args.raft_iters if cuda else 1

    log(f'building {model}/{img_size}px service...')
    t0 = time.perf_counter()
    gargs = argparse.Namespace(
        model=model, img_size=img_size, params=None, raft_params=None,
        raft_iters=raft_iters, seed=0, engine='fast', prefix_cache_size=4)
    G = serve.build_generator(gargs, device=dev)
    svc = serve.CwmService(G, img_size, engine='fast', batch_window_ms=0,
                           seed=0,
                           max_batch_samples=max(args.num_samples, 16))
    build_sec = time.perf_counter() - t0

    log(f'build {build_sec:.1f}s; warming up...')
    t0 = time.perf_counter()
    warmed = svc.warmup(buckets=(args.num_samples,), log=log)
    warmup_sec = time.perf_counter() - t0
    log(f'warmup {warmup_sec:.1f}s ({len(warmed)} routes)')

    grid = G.mask_shape[-1]
    rng = np.random.RandomState(3)
    img = rng.rand(img_size, img_size, 3).astype(np.float32)
    img = img.round(3).tolist()

    per_size, launches = {}, {}
    for k in range(1, args.max_prompt + 1):
        # k distinct patch coordinates (row-major over the grid)
        coords = [[j // grid, j % grid] for j in range(k)]
        req = {'image': img, 'active': coords, 'shift': [0, 1],
               'num_samples': args.num_samples}
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = svc.counterfactual(dict(req))
        dt = time.perf_counter() - t0
        per_size[k] = round(dt, 3)
        launches[k] = dict(kernels.LAUNCHES)
        log(f'prompt size {k}: first request {dt:.3f}s')
        if 'segment_raw' not in out:
            raise RuntimeError(f'no segment in the response: {sorted(out)}')
    worst = max(per_size.values())

    rec = {'serve_first_request_by_prompt_size': {
        'model': model, 'img_size': img_size, 'engine': 'fast',
        'num_samples': args.num_samples, 'raft_iters': raft_iters,
        'build_sec': round(build_sec, 2),
        'warmup_sec': round(warmup_sec, 2),
        'warmup_programs': len(warmed),
        'first_request_sec_by_prompt_size': per_size,
        'worst_first_request_sec': worst,
        # the 1 s target is a statement about the card only
        'target_met_lt_1s': bool(worst < 1.0) if cuda else None,
        'launches_by_prompt_size': launches,
        'note': ('one counterfactual request per prompt size after the '
                 'bucket warm-up (fast_vmae.sfx_bucket: sizes 1-4 / 5-8 / '
                 '9-16 share the width-4/8/16 suffix); the first request '
                 'also runs the scene prefix (a service-LRU miss)'),
        **device_record(dev),
    }}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return rec


if __name__ == '__main__':
    main()
