"""Micro-benchmark of the decoder-suffix attention candidates.

Port of the JAX package's ``scripts/bench_attention.py``. The decoder
suffix attention (each sample's frame-1 queries over [the shared scene
prefix ; its own suffix] keys) sets the exact rung's dispatch rate, so this
times each implementation at the exact rung's shape, ViT-L 4x4 @ 224:
[S, 8 heads, 3136 queries; 3136 + 3136 keys], head dim 64, bf16 on the
card (f32 on the CPU). Rows:

- ``ours``: K1 (``ops.flash_attention.flash_attention``) on the
  concatenated panels;
- ``ours-two-source``: K2 (``flash_attention_prefix``) reading the shared
  prefix panel in place;
- ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention``, the
  library candidate (no path of the port calls it);
- ``plain``: the plain version (``dense_attention``).

Each row: ms per call (one warm call, then the best of 3 windows of
``--iters`` calls closed by one host fetch), TFLOP/s of 4·S·H·Nq·Nk·D,
the largest error against the plain version's f32 output, and the kernel
launches of one call. A failing candidate raises (the JAX script records
the error and goes on).

    python -m counterfactualworldmodels_tpu_torch.scripts.bench_attention
    python -m counterfactualworldmodels_tpu_torch.scripts.bench_attention \\
        --s 2 --queries 64 --prefix 64 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ._bench_common import device_record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None)
    ap.add_argument('--s', type=int, default=16, help='sample batch S')
    ap.add_argument('--iters', type=int, default=8)
    ap.add_argument('--heads', type=int, default=8)
    ap.add_argument('--queries', type=int, default=3136,
                    help='frame-1 queries (and suffix keys) per sample')
    ap.add_argument('--prefix', type=int, default=3136,
                    help='shared prefix keys')
    ap.add_argument('--head-dim', type=int, default=64)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def inputs(rng, b, h, nq, n0, d, dtype, device):
    """(q, k, v) with k, v [S, H, N0 + Nq, D] whose first N0 rows are the
    same in every sample (the shared prefix: the concatenating candidates
    see the keys the two-source kernel reads), values N(0, 0.05²)."""
    def mk(*shape):
        return torch.from_numpy(
            (rng.randn(*shape) * 0.05).astype(np.float32)).to(device, dtype)
    q = mk(b, h, nq, d)
    k = mk(b, h, n0 + nq, d)
    v = mk(b, h, n0 + nq, d)
    k[:, :, :n0] = k[:1, :, :n0].clone()
    v[:, :, :n0] = v[:1, :, :n0].clone()
    return q, k, v


def main(argv=None):
    args = parse_args(argv)
    from .. import kernels
    from ..ops import flash_attention as fa
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    dtype = torch.bfloat16 if cuda else torch.float32
    b, h, nq, n0, d = args.s, args.heads, args.queries, args.prefix, \
        args.head_dim
    nk = n0 + nq
    q, k, v = inputs(np.random.RandomState(args.seed), b, h, nq, n0, d,
                     dtype, dev)
    # the shared prefix panels and the per-sample suffix panels
    k0, v0 = k[:1, :, :n0].contiguous(), v[:1, :, :n0].contiguous()
    k1, v1 = k[:, :, n0:].contiguous(), v[:, :, n0:].contiguous()
    with torch.no_grad():
        ref = fa.dense_attention(q.float(), k.float(), v.float())
    flops = 4.0 * b * h * nq * nk * d

    def timeit(fn):
        fn().abs().float().sum().item()
        best = float('inf')
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                last = fn()
            last.abs().float().sum().item()
            best = min(best, (time.perf_counter() - t0) / args.iters)
        return best

    candidates = {
        'ours': lambda: fa.flash_attention(q, k, v),
        'ours-two-source': lambda: fa.flash_attention_prefix(q, k0, v0, k1,
                                                             v1),
        'sdpa': lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
        'plain': lambda: fa.dense_attention(q, k, v),
    }
    rows = {}
    with torch.no_grad():
        for name, fn in candidates.items():
            dt = timeit(fn)
            kernels.reset_launches()
            out = fn()
            err = float((out.float() - ref).abs().max())
            rows[name] = {'ms': round(dt * 1e3, 4),
                          'tflops_per_s': round(flops / dt / 1e12, 2),
                          'max_abs_err_vs_plain_f32': err,
                          'launches': {kk: vv for kk, vv in
                                       kernels.LAUNCHES.items() if vv}}
            print(f'{name}: {rows[name]}', file=sys.stderr)

    report = dict({
        'workload': f'decoder suffix attention B={b} H={h} NQ={nq} NK={nk} '
                    f'D={d} {str(dtype).replace("torch.", "")}',
        'flops_per_call_tf': round(flops / 1e12, 3),
        'library': 'sdpa (torch.nn.functional.scaled_dot_product_attention)',
        'rows': rows}, **device_record(dev))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == '__main__':
    main()
