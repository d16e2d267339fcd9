"""Data-loader throughput: the native C++ loader against the Python one.

Port of the JAX package's ``scripts/bench_loader.py``: clips per second and
GB/s of decoded output of the port's loaders on a generated shard (or
``--shard``): ``data/native/clip_loader.cpp`` (``NativeClipLoader``) per
thread count, in f32 and uint8 output and with the zero-copy view, against
``PythonClipLoader`` in f32 and uint8. This bounds the input side of a
training step, which ``bench_train``'s synthetic batches leave out. The
loaders run on the host; ``--device`` follows the other entry points (the
card by default, and it must be there). A loader that cannot be built
raises (the JAX script skips the native rows).

Prints one JSON line; ``--out`` also writes the full results.

    python -m counterfactualworldmodels_tpu_torch.scripts.bench_loader
    python -m counterfactualworldmodels_tpu_torch.scripts.bench_loader \\
        --clips 16 --hw 32 --crop 32 --batch 4 --seconds 0.2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .._device import resolve_device
from ._bench_common import device_record


def measure(loader, batch_shape, seconds: float, itemsize: int = 4) -> dict:
    """Batches drawn for ``seconds`` after one warm batch (thread start-up,
    page cache): clips/s and GB/s of output."""
    it = iter(loader)
    next(it)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        next(it)
        n += 1
    dt = time.perf_counter() - t0
    out_bytes = n * itemsize * int(np.prod(batch_shape))
    return {'batches': n, 'clips_per_sec': round(n * batch_shape[0] / dt, 1),
            'decoded_gb_per_sec': round(out_bytes / dt / 1e9, 3)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--clips', type=int, default=512)
    ap.add_argument('--hw', type=int, default=224)
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--crop', type=int, default=224)
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--threads', default='1,2,4',
                    help='native thread counts to sweep')
    ap.add_argument('--shard', default=None,
                    help='an existing shard (default: a generated one)')
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda',
                    help='torch device of the run (the loaders are '
                         'host-only); "cpu" where there is no card')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..data.shards import NativeClipLoader, PythonClipLoader, write_shard
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        shard = args.shard
        if shard is None:
            shard = os.path.join(tmp, 'bench.shard')
            rng = np.random.RandomState(0)
            write_shard(shard, rng.randint(
                0, 256, (args.clips, 2, args.hw, args.hw, 3), np.uint8))
        results = run(shard, args, NativeClipLoader, PythonClipLoader)
    results.update(device_record(dev))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
    best = max(v['clips_per_sec'] for v in results['loaders'].values())
    rec = {'metric': 'loader_clips_per_sec', 'value': best,
           'unit': 'clips/s',
           'speedup_vs_python': results['native_speedup_vs_python'],
           'results': results}
    print(json.dumps(rec), flush=True)
    return rec


def run(shard, args, native_cls, python_cls) -> dict:
    crop = (min(args.crop, args.hw),) * 2
    bshape = (args.batch, 2, 3, *crop)
    results = {'shard_clips': args.clips, 'hw': args.hw,
               'batch': args.batch, 'seconds': args.seconds, 'loaders': {}}
    loaders = results['loaders']

    def note(key):
        print(f'{key}: {json.dumps(loaders[key])}', file=sys.stderr,
              flush=True)

    loaders['python'] = measure(
        python_cls(shard, batch_size=args.batch, crop_size=crop), bshape,
        args.seconds)
    note('python')
    # u8: crop / flip only, normalized on the device (the training default)
    loaders['python_u8'] = measure(
        python_cls(shard, batch_size=args.batch, crop_size=crop,
                   out_dtype='u8'), bshape, args.seconds, itemsize=1)
    note('python_u8')
    for t in (int(v) for v in args.threads.split(',') if v):
        for mode, zc in (('f32', False), ('u8', False), ('u8', True)):
            nat = native_cls(shard, batch_size=args.batch, crop_size=crop,
                             num_threads=t, out_dtype=mode, zero_copy=zc)
            key = f'native_{mode}{"zc" if zc else ""}_t{t}'
            try:
                loaders[key] = measure(nat, bshape, args.seconds,
                                       itemsize=4 if mode == 'f32' else 1)
            finally:
                nat.close()
            note(key)

    base = loaders['python']['clips_per_sec']
    best = max(v['clips_per_sec'] for v in loaders.values())
    # mode-fair ratios (native against the Python loader with the same
    # output), and the best against the Python f32 loader
    nat_f32 = [v['clips_per_sec'] for k, v in loaders.items()
               if k.startswith('native_f32')]
    nat_u8 = [v['clips_per_sec'] for k, v in loaders.items()
              if k.startswith('native_u8')]
    if nat_f32:
        results['native_f32_speedup_vs_python_f32'] = round(
            max(nat_f32) / base, 2)
    if nat_u8:
        results['native_u8_speedup_vs_python_u8'] = round(
            max(nat_u8) / loaders['python_u8']['clips_per_sec'], 2)
    results['native_speedup_vs_python'] = round(best / base, 2)
    return results


if __name__ == '__main__':
    main()
