"""Serving load generator: counterfactual requests per second under
concurrency.

Port of the JAX package's ``scripts/loadgen.py``: drives the port's
``serve.CwmService`` in-process (no HTTP) with ``--clients`` threads in a
closed loop, each taking the next of ``--requests`` counterfactual
requests on a pool of ``--scenes`` seeded images, first with
micro-batching on (concurrent same-scene prompts join one dispatch along
the S axis, mixed scenes one dispatch over stacked prefix caches;
``utils/batching.py``), then off. Each trial is warmed on its first
2 x clients requests. Prints one JSON line with the throughput of each,
the speed-up and the batcher's counters. A failed request raises.

    python -m counterfactualworldmodels_tpu_torch.scripts.loadgen
    python -m counterfactualworldmodels_tpu_torch.scripts.loadgen \\
        --clients 4 --requests 8 --device cpu
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .._device import resolve_device
from ._bench_common import device_record


def run_trial(service, reqs, clients: int) -> float:
    """Issue ``reqs`` from ``clients`` threads, each taking the next one
    when its last returned; returns the elapsed seconds. A client's error
    ends that client and is raised here once every client has ended."""
    lock = threading.Lock()
    pending = iter(reqs)

    def client():
        while True:
            with lock:
                req = next(pending, None)
            if req is None:
                return
            service.counterfactual(req)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        futures = [pool.submit(client) for _ in range(clients)]
    dt = time.perf_counter() - t0
    for f in futures:
        f.result()
    return dt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--clients', type=int, default=8)
    ap.add_argument('--requests', type=int, default=64)
    ap.add_argument('--scenes', type=int, default=2)
    ap.add_argument('--samples', type=int, default=4,
                    help='num_samples per request')
    ap.add_argument('--model', default=None,
                    help='tiny | base | large (default: base on the card, '
                         'tiny on the CPU)')
    ap.add_argument('--img-size', type=int, default=0,
                    help='default: 224 on the card, 32 on the CPU')
    ap.add_argument('--batch-window-ms', type=float, default=5.0)
    ap.add_argument('--max-scene-batch', type=int, default=8,
                    help='cap per mixed-scene dispatch (see serve.py)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import kernels, serve
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    model = args.model or ('base' if cuda else 'tiny')
    img_size = args.img_size or (224 if cuda else 32)
    gargs = argparse.Namespace(
        model=model, img_size=img_size, params=None, raft_params=None,
        raft_iters=24 if cuda else 1, seed=args.seed)
    G = serve.build_generator(gargs, device=dev)

    rng = np.random.RandomState(args.seed)
    grid = G.mask_shape[-1]
    scenes = [rng.rand(img_size, img_size, 3).round(3).tolist()
              for _ in range(args.scenes)]
    reqs = [{'image': scenes[i % args.scenes],
             'active': [[int(rng.randint(grid)), int(rng.randint(grid))]],
             'shift': [0, 2], 'num_samples': args.samples}
            for i in range(args.requests)]

    results = {}
    for label, window in (('batched', args.batch_window_ms), ('serial', 0)):
        service = serve.CwmService(
            G, img_size, engine='fast', batch_window_ms=window,
            prefix_cache_size=max(4, args.scenes), seed=args.seed,
            max_scene_batch=args.max_scene_batch)
        # every dispatch shape once, out of the timed region
        run_trial(service, reqs[:2 * args.clients], args.clients)
        b = service._batcher
        before = (0, 0, 0) if b is None else (b.batches, b.batched_items,
                                              service.scene_batches)
        kernels.reset_launches()
        dt = run_trial(service, reqs, args.clients)
        results[label] = {
            'requests_per_sec': round(len(reqs) / dt, 3),
            'sims_per_sec': round(len(reqs) * args.samples / dt, 3),
            'engine': service.engine,
            # the timed trial's own counts (the warm-up's taken out)
            'micro_batching': (None if b is None else
                               {'dispatches': b.batches - before[0],
                                'requests_batched':
                                    b.batched_items - before[1],
                                'scene_batches':
                                    service.scene_batches - before[2]}),
            'launches': dict(kernels.LAUNCHES),
        }

    rec = {
        'metric': 'serving counterfactual requests/sec '
                  f'({args.clients} clients, {args.scenes} scenes)',
        'value': results['batched']['requests_per_sec'],
        'unit': 'requests/sec',
        'speedup_vs_serial':
            round(results['batched']['requests_per_sec'] /
                  results['serial']['requests_per_sec'], 2),
        'config': dict({'model': model, 'img_size': img_size,
                        'samples': args.samples, 'requests': args.requests,
                        'clients': args.clients,
                        'batch_window_ms': args.batch_window_ms},
                       **device_record(dev)),
        'trials': results,
    }
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    main()
