#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Builds the port's CUDA kernels from ``counterfactualworldmodels_tpu_torch/
csrc`` and drives its two paths through the entry points a user calls: the
shared-prefix counterfactual-flow dispatch
``pipelines.segmentation.counterfactual_videos_and_flows_fast`` (ViT-L 4x4
@224 + RAFT-24, bf16, S = 16 prompts) and VMAE training
``training.train.make_train_step`` (ViT-L 4x4 @224, bf16, batch 4, mask
ratio 0.9), both from seeded random weights. Phases:

1. device: name, power limit, torch and CUDA versions;
2. build: nvcc for sm_90a, with the seconds it took; each kernel's
   registers and spills (ptxas) and its count of HGMMA (wgmma)
   instructions in ``cuobjdump -sass``: every bf16 attention kernel
   (``*_sm90``) must be there at each head dim, hold some, and not spill
   at D = 64;
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes, in f32 and bf16, with the kernel's, the plain version's
   and one library call's times, the ratio to the library call and the
   share of the bound; the window lookup (f32 sums) one level per call and
   fused, four levels in one launch as a RAFT iteration calls it, with f32
   and bf16 output, timed by CUDA-graph replay beside CUDA events; the
   training pair (K5 forward with logsumexp, K6 backward) at the encoder
   and decoder training shapes, with K6's determinism check;
4. both paths at the tests' small configurations on the card and on the
   CPU (f32, TF32 off): masks equal, videos and flows within tolerance;
   three train steps with equal losses and gradient norms;
5. the full-width dispatch at the library-default rung and the exact rung:
   shapes, finite flows, visible frame-1 pixels pasted unchanged, and the
   launch counts that show every kernel of the path ran;
6. full-width training: one warm-up and three timed steps with finite
   losses, sec/step, clips/s, MFU and peak memory, and the launch counts
   of every step (K5 72, K6 36, K1 0); then the exact forward
   ``models.vmae.apply_vmae`` (K1 36) against the plain dense path,
   checked in f32 and reported in bf16;
7. the kernels RAFT's ``convc1`` launches on the lookup's bf16 output
   (torch.profiler, last: it makes every later launch cost more).

Exits non-zero without a result line if there is no GPU or any phase
fails. Otherwise the last three lines are the kernel table (JSON), the
card's ``nvidia-smi`` name and power limit, and the result line.
``--record PATH`` also writes the full record of every phase (timings,
errors, the profile of a dispatch) as JSON to PATH.
"""
import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

# attention kernel vs plain: f32 absolute (K1 2e-5, K2 3e-5); bf16 within
# REL_BF16 of the plain output's largest magnitude (at the main-path shapes
# outputs are ~0.03, where an absolute 2e-2 would pass a lost key tile)
TOL_F32 = 2e-5
TOL_K2_F32 = 3e-5
TOL_LOOKUP = 1e-5
# training pair: f32 gradients at atol 2e-4 / rtol 1e-4 and the lse at
# 1e-4 / 1e-5 (tests/test_flash_attention.py's bounds); bf16 outputs within
# 2e-2 of their largest magnitude
TOL_GRAD = dict(atol=2e-4, rtol=1e-4)
TOL_LSE = dict(atol=1e-4, rtol=1e-5)
REL_BF16 = 2e-2
# the bf16 tensor-core kernels, each built for these head dims: the build
# phase finds each in the ptxas report and the SASS by its mangled name
SM90_KERNELS = {'attention': ('attention_fwd_sm90',),
                'attention_bwd': ('dkdv_sm90', 'dq_sm90')}
HEAD_DIMS = (16, 32, 64, 128)
S_FULL = 16
B_TRAIN = 4
MASK_RATIO = 0.9

REPLACES = {
    'flash_attention': 'counterfactualworldmodels_tpu/ops/flash_attention.py:295',
    'flash_attention_prefix':
        'counterfactualworldmodels_tpu/ops/flash_attention.py:673',
    'window_lookup': 'counterfactualworldmodels_tpu/models/raft/corr.py:300',
    'flash_attention_lse':
        'counterfactualworldmodels_tpu/ops/flash_attention.py:341',
    'flash_attention_bwd':
        'counterfactualworldmodels_tpu/ops/flash_attention.py:400',
}
REPLACES_K4 = 'counterfactualworldmodels_tpu/models/raft/corr.py:215'
SOURCES = {
    'flash_attention': 'counterfactualworldmodels_tpu_torch/csrc/attention.cu',
    'flash_attention_prefix':
        'counterfactualworldmodels_tpu_torch/csrc/attention.cu',
    'window_lookup': 'counterfactualworldmodels_tpu_torch/csrc/window_lookup.cu',
    'flash_attention_lse':
        'counterfactualworldmodels_tpu_torch/csrc/attention.cu',
    'flash_attention_bwd':
        'counterfactualworldmodels_tpu_torch/csrc/attention_bwd.cu',
}


def log(phase, msg):
    print(f'[{phase}] {msg}', flush=True)


def time_ms(torch, fn, target_ms=150.0):
    """Mean device time of fn() over enough back-to-back calls to fill
    ~target_ms, from CUDA events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    reps = int(min(50, max(3, target_ms / max(one, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(prof):
    """{kernel name: device microseconds} of a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith('CUDA'):
            continue
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        out[e.key] = out.get(e.key, 0) + us
    return out


def kernel_device_us(torch, fn):
    """{kernel: device microseconds} of one call of fn after a warm-up,
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_us(prof)


def graph_ms(torch, fns, reps=48, replays=5):
    """Device time per call of the functions fns, called in turn (one per
    copy of the inputs, so that each call can find its data out of L2):
    CUDA events around replays of a CUDA graph that holds reps calls. No
    host time between launches counts, so this times a 5-10 us kernel where
    time_ms times the Python around it. Not torch.profiler: once it has
    run, every later launch costs more host time (phase 5's wall times
    would move), and its kernel sums for these short calls lost events in
    some runs."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def library_ms(torch, fn):
    """time_ms of the library yardstick, or None if this PyTorch build has
    no kernel for the call (the yardstick is not part of the port)."""
    try:
        return time_ms(torch, fn)
    except Exception as e:  # a yardstick only: report it and carry on
        print(f'library call unavailable: {type(e).__name__}: {e}',
              file=sys.stderr)
        return None


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes')


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def attention_tol(dtype_name, ref, f32_tol):
    """f32: the absolute bound; bf16: REL_BF16 of max|ref|."""
    if dtype_name == 'float32':
        return f32_tol
    return REL_BF16 * float(ref.float().abs().max())


def with_ratios(r):
    """A phase-3 row with its time over the library call's and the share
    of the bound it reaches."""
    lib = r.get('library_ms')
    r['x_library'] = None if not lib else r['ms'] / lib
    r['bound_share'] = r['bound_ms'] / r['ms']
    return r


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

def attention_cases(torch, F, fa, rec):
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    k1_cases = [  # (label, B, H, Nq, Nk, d)
        ('encoder prefix', 1, 16, 3136, 3136, 64),
        ('decoder prefix', 1, 8, 3136, 3136, 64),
        ('ragged', 2, 3, 1000, 777, 64),
        ('Nq != Nk (concat route)', 1, 8, 3136, 6272, 64),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split('.')[1]
        for label, b, h, nq, nk, d in k1_cases:
            q = rnd(b, h, nq, d, dtype=dtype, scale=d ** -0.5)
            k = rnd(b, h, nk, d, dtype=dtype)
            v = rnd(b, h, nk, d, dtype=dtype)
            out = fa.flash_attention(q, k, v)
            ref = fa._chunked_dense_attention(q, k, v)
            err = max_err(out, ref)
            tol = attention_tol(dn, ref, TOL_F32)
            ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
            plain_ms = time_ms(torch,
                               lambda: fa._chunked_dense_attention(q, k, v))
            lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0))
            item = q.element_size()
            flops = 4 * b * h * nq * nk * d
            nbytes = item * b * h * d * (2 * nq + 2 * nk)
            bms, by = bound(flops, nbytes, dn)
            r = dict(kernel='flash_attention', case=label, dtype=dn,
                     shape=[b, h, nq, nk, d], max_abs_err=err, tol=tol,
                     max_abs_plain=float(ref.float().abs().max()),
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9)
            rec['phase3'].append(with_ratios(r))
            log('3 kernels', json.dumps(r))
            if not err <= tol:
                raise AssertionError(f'K1 {label} {dn}: err {err} > {tol}')

    k2_cases = [  # (label, S, H, Nq, N0, N1, S0, w0, w1)
        ('exact rung', 16, 8, 3136, 3136, 3136, 1, 1.0, 1.0),
        ('pool4 rung', 16, 8, 3136, 196, 196, 1, 16.0, 16.0),
        ('stacked prefixes s0=S', 4, 8, 3136, 196, 196, 4, 16.0, 16.0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split('.')[1]
        for label, s, h, nq, n0, n1, s0, w0, w1 in k2_cases:
            q = rnd(s, h, nq, 64, dtype=dtype, scale=0.125)
            k0, v0 = (rnd(s0, h, n0, 64, dtype=dtype) for _ in range(2))
            k1, v1 = (rnd(s, h, n1, 64, dtype=dtype) for _ in range(2))
            args = (q, k0, v0, k1, v1, w0, w1)
            out = fa.flash_attention_prefix(*args)
            ref = fa._dense_two_source(*args)
            err = max_err(out, ref)
            tol = attention_tol(dn, ref, TOL_K2_F32)
            ms = time_ms(torch, lambda: fa.flash_attention_prefix(*args))
            plain_ms = time_ms(torch, lambda: fa._dense_two_source(*args))
            kc = torch.cat([k0.expand(s, -1, -1, -1), k1], 2)
            vc = torch.cat([v0.expand(s, -1, -1, -1), v1], 2)
            bias = torch.cat([torch.full((n0,), math.log(w0), device=dev),
                              torch.full((n1,), math.log(w1), device=dev)]
                             ).to(dtype)
            mask = None if w0 == w1 == 1.0 else bias[None]
            lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, scale=1.0))
            del kc, vc
            item = q.element_size()
            flops = 4 * s * h * nq * (n0 + n1) * 64
            nbytes = item * 64 * h * (2 * s * nq + 2 * s0 * n0 + 2 * s * n1)
            bms, by = bound(flops, nbytes, dn)
            r = dict(kernel='flash_attention_prefix', case=label, dtype=dn,
                     shape=[s, h, nq, n0, n1, 64, s0], weights=[w0, w1],
                     max_abs_err=err, tol=tol,
                     max_abs_plain=float(ref.float().abs().max()),
                     ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=bms, bound_by=by,
                     tflops=flops / ms / 1e9)
            rec['phase3'].append(with_ratios(r))
            log('3 kernels', json.dumps(r))
            if not err <= tol:
                raise AssertionError(f'K2 {label} {dn}: err {err} > {tol}')

    z = torch.zeros
    for bad, what in (((z(3, 2, 64, 64, device=dev), z(2, 2, 8, 64, device=dev),
                        z(2, 2, 8, 64, device=dev), z(3, 2, 8, 64, device=dev),
                        z(3, 2, 8, 64, device=dev)), 'prefix batch dim'),
                      ((z(3, 2, 64, 64, device=dev), z(1, 2, 0, 64, device=dev),
                        z(1, 2, 0, 64, device=dev), z(3, 2, 8, 64, device=dev),
                        z(3, 2, 8, 64, device=dev)), 'empty panel')):
        try:
            fa.flash_attention_prefix(*bad)
        except ValueError as e:
            if what not in str(e):
                raise
            log('3 kernels', f'K2 rejects: {what}')
        else:
            raise AssertionError(f'K2 accepted a bad call ({what})')


def grid_sample_grid(torch, x, y, r, h, w):
    """The reference RAFT's sampling grid for grid_sample(align_corners=
    True): [N, 2r+1, 2r+1, 2], normalised, the first window axis offsetting
    x."""
    p = 2 * r + 1
    d = torch.linspace(-r, r, p, device=x.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing='ij'), -1)
    grid = torch.stack([x, y], -1)[:, None, None] + delta[None]
    scale = torch.tensor([2.0 / max(w - 1, 1), 2.0 / max(h - 1, 1)],
                         device=x.device)
    return grid * scale - 1


def touched_values(torch, x, y, r, h, w):
    """Level values a lookup must read for this data: the in-bounds part of
    each query's (2r+2)^2 patch."""
    xc = torch.floor(torch.clamp(x, -(r + 1.0), w + r)) - r
    yc = torch.floor(torch.clamp(y, -(r + 1.0), h + r)) - r
    cols = (torch.clamp(xc + 2 * r + 2, max=w) - torch.clamp(xc, min=0)
            ).clamp(min=0)
    rows = (torch.clamp(yc + 2 * r + 2, max=h) - torch.clamp(yc, min=0)
            ).clamp(min=0)
    return float((cols * rows).sum())


def lookup_bound(touched, n, outputs, out_item):
    """Bound of a lookup: the touched level values and the coordinates read
    once, the outputs written once; about 4 operations per output (the row
    lerp, shared by two outputs, and the column lerp)."""
    return bound(4 * outputs, 4 * touched + 8 * n + out_item * outputs,
                 'float32')


def lookup_cases(torch, F, corr, rec):
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(1)
    n, r = S_FULL * 784, 4
    p = 2 * r + 1
    # one level per call (window_lookup, the K3/K4 contract's entry)
    for h in (28, 14, 7, 3):
        level = torch.randn(n, h, h, generator=g, device=dev)
        # coordinates reach 6 px past every edge: out-of-bounds windows
        x = torch.rand(n, generator=g, device=dev) * (h + 12) - 6
        y = torch.rand(n, generator=g, device=dev) * (h + 12) - 6
        out = corr.window_lookup(level, x, y, r)
        ref = corr._window_lookup(corr.pad_pyramid([level], r)[0], x, y, r,
                                  h, h)
        err = max_err(out, ref)
        ms = time_ms(torch, lambda: corr.window_lookup(level, x, y, r))
        dev_ms = graph_ms(torch, [lambda: corr.window_lookup(level, x, y, r)])
        plain_ms = time_ms(torch, lambda: corr._window_lookup(
            corr.pad_pyramid([level], r)[0], x, y, r, h, h))
        gridn = grid_sample_grid(torch, x, y, r, h, h)
        lvl4 = level[:, None]

        def lib():
            return F.grid_sample(lvl4, gridn, align_corners=True)[:, 0]

        lib_err = max_err(lib(), out)
        lib_ms = library_ms(torch, lib)
        bms, by = lookup_bound(touched_values(torch, x, y, r, h, h), n,
                               n * p * p, 4)
        r_ = dict(kernel='window_lookup', case=f'level {h}x{h}',
                  dtype='float32', shape=[n, h, h, r], max_abs_err=err,
                  tol=TOL_LOOKUP, library_err=lib_err, ms=ms,
                  device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=bms, bound_by=by)
        rec['phase3'].append(with_ratios(r_))
        log('3 kernels', json.dumps(r_))
        if not err <= TOL_LOOKUP:
            raise AssertionError(f'lookup level {h}: err {err}')

    fused_lookup_cases(torch, F, corr, rec)


LOOKUP_SIZES = (28, 14, 7, 3)


def fused_lookup_inputs(torch, F):
    """The fused lookup of one RAFT iteration at the dispatch shape: four
    levels [S*784, s, s], coordinates [S, 28, 28, 2] = the pixel grid moved
    by up to 8 px (windows at the borders cross the edges), and the
    reference RAFT's sampling grids. Four copies, called in turn by the
    timings, so that a call finds its data out of L2, as in the dispatch,
    where the update block's convolutions run between two lookups. Returns
    (copies, the yardstick: grid_sample on each level, then the concat, as
    the reference RAFT's CorrBlock does)."""
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(2)
    n, r = S_FULL * 784, 4
    ar = torch.arange(28.0, device=dev)
    grid = torch.stack(torch.meshgrid(ar, ar, indexing='xy'), -1)
    copies = []
    for _ in range(4):
        pyr = [torch.randn(n, s, s, generator=g, device=dev)
               for s in LOOKUP_SIZES]
        coords = grid + torch.rand(S_FULL, 28, 28, 2, generator=g,
                                   device=dev) * 16 - 8
        xy = [coords[..., k].reshape(n) for k in (0, 1)]
        grids = [grid_sample_grid(torch, xy[0] / 2 ** i, xy[1] / 2 ** i, r,
                                  s, s) for i, s in enumerate(LOOKUP_SIZES)]
        copies.append((pyr, coords, grids))

    def corr_block(pyr, coords, grids):
        return torch.cat([F.grid_sample(lv[:, None], gr, align_corners=True)
                          .reshape(S_FULL, 28, 28, (2 * r + 1) ** 2)
                          for lv, gr in zip(pyr, grids)], -1)

    return copies, corr_block


def fused_lookup_cases(torch, F, corr, rec):
    n, r = S_FULL * 784, 4
    p = 2 * r + 1
    copies, corr_block = fused_lookup_inputs(torch, F)
    pyr, coords, grids = copies[0]
    before = corr.kernels.LAUNCHES['window_lookup']
    out = corr.lookup_pyramid(pyr, coords, r)
    per_call = corr.kernels.LAUNCHES['window_lookup'] - before
    out_bf16 = corr.lookup_pyramid(pyr, coords, r, torch.bfloat16)
    ref = corr._lookup_pyramid(pyr, coords, r)
    err = max_err(out, ref)
    bitwise = bool(torch.equal(out_bf16, out.to(torch.bfloat16)))
    lib_err = max_err(corr_block(pyr, coords, grids), out)
    plain_ms = graph_ms(torch, [lambda c=c: corr._lookup_pyramid(c[0], c[1], r)
                                for c in copies])
    lib_ms = graph_ms(torch, [lambda c=c: corr_block(*c) for c in copies])
    lib_event_ms = library_ms(torch, lambda: corr_block(pyr, coords, grids))
    xy = [coords[..., k].reshape(n) for k in (0, 1)]
    touched = sum(touched_values(torch, xy[0] / 2 ** i, xy[1] / 2 ** i, r,
                                 s, s) for i, s in enumerate(LOOKUP_SIZES))
    outputs = n * len(LOOKUP_SIZES) * p * p
    for dt, got in ((torch.float32, out), (torch.bfloat16, out_bf16)):
        ms = graph_ms(torch, [
            lambda c=c, dt=dt: corr.lookup_pyramid(c[0], c[1], r, dt)
            for c in copies])
        event_ms = time_ms(torch, lambda: corr.lookup_pyramid(pyr, coords,
                                                              r, dt))
        bms, by = lookup_bound(touched, n, outputs, got.element_size())
        r_ = dict(kernel='window_lookup',
                  case='pyramid 28/14/7/3' + ('' if dt == torch.float32
                                              else ', bf16 out'),
                  dtype='float32', out_dtype=str(dt).split('.')[1],
                  shape=[n, list(LOOKUP_SIZES), r],
                  max_abs_err=max_err(got, ref), library_err=lib_err,
                  launches_per_call=per_call, ms=ms,
                  ms_from='CUDA graph replay', event_ms=event_ms,
                  plain_ms=plain_ms, library_ms=lib_ms,
                  library_event_ms=lib_event_ms, bound_ms=bms, bound_by=by)
        if dt == torch.float32:
            r_['tol'] = TOL_LOOKUP
        else:
            r_['bitwise_equal_to_f32_cast'] = bitwise
        rec['phase3'].append(with_ratios(r_))
        log('3 kernels', json.dumps(r_))
    if not (err <= TOL_LOOKUP and bitwise and per_call == 1):
        raise AssertionError(f'fused lookup: err {err}, bf16 output equal to '
                             f'the f32 cast: {bitwise}, launches {per_call}')


def _close(torch, a, ref):
    """f32: atol 2e-4 / rtol 1e-4; bf16: within 2e-2 of max|ref|."""
    if a.dtype == torch.float32:
        return bool(torch.allclose(a, ref, **TOL_GRAD))
    return max_err(a, ref) <= REL_BF16 * float(ref.float().abs().max())


def training_kernel_cases(torch, F, fa, rec):
    """K5 (forward with logsumexp) and K6 (fused backward) at the training
    shapes: compared with their plain versions at batch 1 (the f32 case at
    its own size), timed at the training batch."""
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)
    d = 64

    def inputs(b, h, nq, nk, dtype):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device=dev)
                    * scale).to(dtype)
        return (rnd(b, h, nq, d, scale=d ** -0.5), rnd(b, h, nk, d),
                rnd(b, h, nk, d), rnd(b, h, nq, d))

    cases = [  # (label, dtype, batch compared, batch timed, H, Nq, Nk,
               #  launches of (K5, K6) per remat train step)
        ('encoder', torch.bfloat16, 1, B_TRAIN, 16, 3450, 3450, (48, 24)),
        ('decoder', torch.bfloat16, 1, B_TRAIN, 8, 6272, 6272, (24, 12)),
        ('ragged', torch.float32, 2, 2, 3, 1000, 777, (0, 0)),
    ]
    for label, dtype, bc, bt, h, nq, nk, per_step in cases:
        dn = str(dtype).split('.')[1]
        q, k, v, do = inputs(bc, h, nq, nk, dtype)
        out, lse = fa._flash_forward_lse(q, k, v)
        ref, ref_lse = fa._chunked_dense_attention(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        grads = fa._flash_backward(q, k, v, do, lse, delta)
        again = fa._flash_backward(q, k, v, do, lse, delta)
        ref_grads = fa._chunked_attention_bwd(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        ok5 = (_close(torch, out, ref)
               and bool(torch.allclose(lse, ref_lse, **TOL_LSE)))
        ok6 = all(_close(torch, a, r) for a, r in zip(grads, ref_grads))
        deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
        err5 = dict(out=max_err(out, ref), lse=max_err(lse, ref_lse),
                    max_abs_plain=float(ref.float().abs().max()))
        err6 = {n: max_err(a, r) for n, a, r in zip(('dq', 'dk', 'dv'),
                                                    grads, ref_grads)}
        err6['max_abs_plain'] = max(float(r.float().abs().max())
                                    for r in ref_grads)
        del q, k, v, do, out, lse, ref, ref_lse, grads, again, ref_grads

        q, k, v, do = inputs(bt, h, nq, nk, dtype)
        out, lse = fa._flash_forward_lse(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        ms5 = time_ms(torch, lambda: fa._flash_forward_lse(q, k, v))
        plain5 = time_ms(torch, lambda: fa._chunked_dense_attention(
            q, k, v, with_lse=True))
        lib5 = library_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
        ms6 = time_ms(torch, lambda: fa._flash_backward(q, k, v, do, lse,
                                                        delta))
        plain6 = time_ms(torch, lambda: fa._chunked_attention_bwd(
            q, k, v, do, lse, delta))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves, scale=1.0)
            torch.autograd.grad(o, leaves, do)

        fb = library_ms(torch, sdpa_fwd_bwd)
        lib6 = None if fb is None or lib5 is None else fb - lib5
        item = q.element_size()
        pairs = bt * h * nq * nk * d
        for kernel, ms, plain, lib, flops, nbytes, err, ok, launches in (
                ('flash_attention_lse', ms5, plain5, lib5, 4 * pairs,
                 item * bt * h * d * (2 * nq + 2 * nk) + 4 * bt * h * nq,
                 err5, ok5, per_step[0]),
                # the function's work is 10*pairs (the TPU kernel's five
                # products); the two-pass kernel does 14*pairs
                ('flash_attention_bwd', ms6, plain6, lib6, 10 * pairs,
                 item * bt * h * d * (3 * nq + 3 * nk) + 8 * bt * h * nq,
                 err6, ok6, per_step[1])):
            bms, by = bound(flops, nbytes, dn)
            r = dict(kernel=kernel, case=label, dtype=dn,
                     shape=[bt, h, nq, nk, d], compared_batch=bc,
                     errors=err, max_abs_err=max(v for n, v in err.items()
                                                 if n != 'max_abs_plain'),
                     ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
                     bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9,
                     launches_per_train_step=launches)
            if kernel == 'flash_attention_bwd':
                r['deterministic'] = deterministic
                r['kernel_tflops'] = 14 * pairs / ms / 1e9
            rec['phase3'].append(with_ratios(r))
            log('3 kernels', json.dumps(r))
        del q, k, v, do, out, lse, leaves
        if not (ok5 and ok6 and deterministic):
            raise AssertionError(f'K5/K6 {label} {dn}: {err5} {err6} '
                                 f'deterministic={deterministic}')


# ---------------------------------------------------------------------------
# phases 4 and 5: the slice through its entry points
# ---------------------------------------------------------------------------

def prompts(rng, n, s, n_passive):
    """The benchmark's demo prompt policy: frame 0 visible; n_passive
    visible patches + 1 active patch per sample in frame 1; shifts in
    [-3, 3] patches. Masks [1, N, S], True = masked."""
    npf = n // 2
    p = np.ones((1, n, s), dtype=bool)
    p[:, :npf] = False
    a = p.copy()
    for i in range(s):
        p[0, npf + rng.choice(npf, n_passive, replace=False), i] = False
        a[0, npf + rng.randint(npf), i] = False
    shifts = rng.randint(-3, 4, size=(1, s, 2)).astype(np.int64)
    return p, a, shifts, npf + n_passive + 1


def small_slice(torch, port, rec):
    from counterfactualworldmodels_tpu_torch.models import fast_vmae, vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        counterfactual_videos_and_flows_fast)
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(0))
    raft_cpu = weights.init_raft(RAFT(iters=2, device='cpu'),
                                 torch.Generator().manual_seed(1))
    raft_gpu = RAFT(iters=2, device='cuda')
    raft_gpu.load_state_dict(raft_cpu.state_dict(), strict=True)
    rng = np.random.RandomState(2)
    s, n, n0 = 4, model.num_patches, model.num_patches_per_frame
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    p, a, shifts, _ = prompts(rng, n, s, 6)
    n_vis = n0 + 7
    noise = (rng.rand(s, n - n0) * 0.999).astype(np.float32)
    pad = fast_vmae.sfx_bucket(n_vis - n0, n - n0)
    for rung in ((1, 1, 'erf'), (4, 4, 'tanh')):
        outs = {}
        for dev in ('cpu', 'cuda'):
            fp = fast_vmae.stack_vmae_params(model, sd, torch.float32, dev)
            raft = raft_cpu if dev == 'cpu' else raft_gpu
            port.kernels.reset_launches()
            y, f, m = counterfactual_videos_and_flows_fast(
                model, fp, raft, *(torch.from_numpy(v).to(dev) for v in
                                   (x, p, a, shifts, noise)),
                pad, True, 2, True, True, True, None, *rung, n_vis=n_vis)
            outs[dev] = (y.cpu(), f.cpu(), m.cpu(),
                         dict(port.kernels.LAUNCHES))
        (yc, fc, mc, lc), (yg, fg, mg, lg) = outs['cpu'], outs['cuda']
        r = dict(rung=list(rung), masks_equal=bool(torch.equal(mc, mg)),
                 video_err=max_err(yc, yg), flow_err=max_err(fc, fg),
                 launches_cpu=lc, launches_gpu=lg, tol_video=1e-4,
                 tol_flow=1e-3)
        rec['phase4'].append(r)
        log('4 small slice', json.dumps(r))
        if not (r['masks_equal'] and r['video_err'] <= 1e-4
                and r['flow_err'] <= 1e-3):
            raise AssertionError(f'small slice card vs CPU: {r}')
        path = ('flash_attention', 'flash_attention_prefix', 'window_lookup')
        if (any(lc.values()) or not all(lg[k] for k in path)
                or any(v for k, v in lg.items() if k not in path)):
            raise AssertionError(f'launch counts: cpu {lc}, gpu {lg}')


def small_train(torch, port, rec):
    """Three remat train steps of the small configuration, with flash
    attention (K5/K6 on the card, their plain versions on the CPU), from
    the same weights and masks: losses and gradient norms agree."""
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.training import train as T
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True,
        attn_impl='flash')
    opt = T.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    init = vmae.init_params(cfg, seed=0, device='cpu').state_dict()
    rng = np.random.RandomState(5)
    gen = torch.Generator().manual_seed(5)
    batches = []
    for _ in range(3):
        mask, n_vis = T.make_batch_masks(gen, cfg, 4, MASK_RATIO)
        x = torch.from_numpy(rng.rand(4, 2, 3, 32, 32).astype(np.float32))
        batches.append((x, mask))
    runs = {}
    for dev in ('cpu', 'cuda'):
        module = vmae.PretrainVisionTransformerModule(cfg, device=dev)
        module.load_state_dict(init, strict=True)
        state = T.TrainState(0, module, opt.init(module.parameters()))
        step = T.make_train_step(cfg, opt, n_vis, remat=True, device=dev)
        port.kernels.reset_launches()
        metrics = []
        for x, mask in batches:
            state, m = step(state, x, mask)
            metrics.append([float(m['loss']), float(m['grad_norm'])])
        runs[dev] = (metrics, dict(port.kernels.LAUNCHES))
    (mc, lc), (mg, lg) = runs['cpu'], runs['cuda']
    rel = max(abs(g / c - 1) for rc, rg in zip(mc, mg) for c, g in zip(rc, rg))
    depth = cfg.encoder_depth + cfg.decoder_depth
    expect = dict(lc, flash_attention_lse=3 * 2 * depth,
                  flash_attention_bwd=3 * depth)
    r = dict(config='small, flash attention, f32, remat', steps=3,
             cpu=mc, cuda=mg, max_rel_diff=rel, tol_rel=1e-4,
             launches_cpu=lc, launches_gpu=lg)
    rec['phase4'].append(r)
    log('4 small train', json.dumps(r))
    if not (rel <= 1e-4 and not any(lc.values()) and lg == expect):
        raise AssertionError(f'small train card vs CPU: {r}')


def full_width(torch, port, rec, smi):
    from counterfactualworldmodels_tpu_torch.models import fast_vmae, vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.ops import patches
    from counterfactualworldmodels_tpu_torch.pipelines import perturbation
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        counterfactual_videos_and_flows_fast)
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    model = vmae.large_4x4patch_2frames_1tube()
    g = torch.Generator(device=dev).manual_seed(0)
    sd = weights.init_vmae_state_dict(model, g)
    fp = fast_vmae.stack_vmae_params(model, sd, torch.bfloat16, dev)
    del sd
    raft = weights.init_raft(RAFT(iters=24, dtype=torch.bfloat16,
                                  device=dev), g)
    torch.cuda.synchronize()
    log('5 full width', f'weights ready in {time.perf_counter() - t0:.1f}s')

    rng = np.random.RandomState(3)
    n, n0 = model.num_patches, model.num_patches_per_frame
    n1 = n - n0
    frame = rng.rand(3, 224, 224).astype(np.float32)
    x = torch.from_numpy(np.broadcast_to(frame, (1, 2, 3, 224, 224)).copy())
    p, a, shifts, n_vis = prompts(rng, n, S_FULL, 32)
    x, p, a, shifts = (torch.from_numpy(np.asarray(v)).to(dev)
                       for v in (x, p, a, shifts))
    noise = torch.rand(S_FULL, n1, generator=g, device=dev) * 0.999
    pad = fast_vmae.sfx_bucket(n_vis - n0, n1)
    default = fast_vmae.resolve_pools(56, 56)
    # the prompts the dispatch builds, for the pasted-pixels check
    x_mocos, m_ref = perturbation.make_motion_counterfactual(
        x[0], p[0].T, a[0].T, shifts[0], noise, model.full_patch_size,
        n_vis_target=n_vis)
    expect = {name: 0 for name in port.kernels.LAUNCHES}
    expect.update(flash_attention=model.encoder_depth + model.decoder_depth,
                  flash_attention_prefix=model.decoder_depth,
                  window_lookup=24)

    def dispatch(rung):
        return counterfactual_videos_and_flows_fast(
            model, fp, raft, x, p, a, shifts, noise, pad, True, 24, True,
            True, True, None, *rung, n_vis=n_vis)

    results = []
    for name, rung in (('default', default), ('exact', (1, 1, 'erf'))):
        dispatch(rung)                       # warm-up (cuDNN autotune etc.)
        torch.cuda.synchronize()
        port.kernels.reset_launches()
        y, flows, masks = dispatch(rung)
        torch.cuda.synchronize()
        launches = dict(port.kernels.LAUNCHES)
        # checks: shapes, finite, masks as built, visible pixels pasted
        ok_shapes = (tuple(y.shape) == (S_FULL, 2, 3, 224, 224)
                     and tuple(flows.shape) == (S_FULL, 1, 2, 224, 224)
                     and tuple(masks.shape) == (S_FULL, n))
        finite = bool(torch.isfinite(flows).all() and torch.isfinite(y).all())
        masks_ok = bool(torch.equal(masks, m_ref)
                        and ((~masks).sum(-1) == n_vis).all())
        vis1 = ~masks[:, n0:]
        raw = patches.patchify(x_mocos[:, 1:2], model.full_patch_size)
        out = patches.patchify(y[:, 1:2], model.full_patch_size)
        pasted = bool(torch.equal(out[vis1], raw[vis1])
                      and torch.equal(y[:, 0], x_mocos[:, 0]))
        # time whole dispatches (host clock around synchronized runs)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            dispatch(rung)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        ms = float(np.median(times))
        r = dict(rung=name, pools_gelu=list(rung), launches=launches,
                 expected_launches=expect, shapes_ok=ok_shapes,
                 finite=finite, masks_ok=masks_ok, pasted_ok=pasted,
                 flow_abs_mean=float(flows.abs().mean()),
                 ms_per_dispatch=ms, dispatch_ms_runs=times,
                 sims_per_s=S_FULL / (ms / 1e3),
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 card=smi)
        if name == 'default':
            r['profile'] = profile_dispatch(torch, lambda: dispatch(rung))
        results.append(r)
        rec['phase5'].append(r)
        log('5 full width', json.dumps(r))
        if not (ok_shapes and finite and masks_ok and pasted
                and launches == expect):
            raise AssertionError(f'full-width {name} rung failed: {r}')
    return results


def convc1_kernels(torch, rec):
    """The kernels RAFT's first motion-encoder conv launches on the
    lookup's bf16 output ([S, 28, 28, 324] read as NCHW): a copy or cast of
    its input would show here. Runs last: after a profiler session every
    launch costs more host time, which would move the timed phases."""
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    raft = weights.init_raft(RAFT(iters=1, dtype=torch.bfloat16,
                                  device=dev), g)
    feat = torch.randn(S_FULL, 28, 28, 324, generator=g, device=dev,
                       dtype=torch.bfloat16).permute(0, 3, 1, 2)
    rec['convc1_kernels_us'] = kernel_device_us(
        torch, lambda: raft.update_block.encoder.convc1(feat))
    log('7 convc1', json.dumps(rec['convc1_kernels_us']))


def full_train(torch, port, rec, smi):
    """ViT-L 4x4 @224 training at full width through make_train_step, then
    the exact forward apply_vmae against the plain dense path."""
    import dataclasses
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.training import flops
    from counterfactualworldmodels_tpu_torch.training import train as T
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    cfg = vmae.large_4x4patch_2frames_1tube(dtype=torch.bfloat16,
                                            attn_impl='flash')
    opt = T.make_optimizer(learning_rate=1.5e-4, warmup_steps=1,
                           total_steps=100)
    state = T.init_train_state(cfg, opt, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, n_vis = T.make_batch_masks(gen, cfg, B_TRAIN, MASK_RATIO)

    def mask_fn(g, b):
        return T.make_batch_masks(g, cfg, b, MASK_RATIO)[0]

    step = T.make_train_step(cfg, opt, n_vis, remat=True, mask_fn=mask_fn,
                             device=dev)
    # synthetic clips as training/train_vmae.py makes them: a random frame
    # and the same frame shifted by up to 8 px
    rng = np.random.RandomState(0)
    base = rng.rand(B_TRAIN, 1, 3, 224, 224).astype(np.float32)
    clips = [torch.from_numpy(np.concatenate(
        [base, np.roll(base, tuple(rng.randint(-8, 9, 2)), axis=(-2, -1))],
        1)).to(dev) for _ in range(4)]
    torch.cuda.synchronize()
    log('6 train', f'weights and clips ready in '
                   f'{time.perf_counter() - t0:.1f}s')
    depth = cfg.encoder_depth + cfg.decoder_depth
    zeros = {name: 0 for name in port.kernels.LAUNCHES}
    expect = dict(zeros, flash_attention_lse=2 * depth,
                  flash_attention_bwd=depth)
    losses, norms, times, launches = [], [], [], []
    for i, x in enumerate(clips):        # step 0 is the warm-up
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        port.kernels.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, x, gen)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t1)
        launches.append(dict(port.kernels.LAUNCHES))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec = float(np.median(times))
    step_flops = flops.vmae_train_flops(cfg, B_TRAIN, n_vis)
    r = dict(config='large_4x4patch_2frames_1tube bf16 flash', batch=B_TRAIN,
             mask_ratio=MASK_RATIO, n_vis=n_vis, remat=True, losses=losses,
             grad_norms=norms, sec_per_step_runs=times, sec_per_step=sec,
             clips_per_s=B_TRAIN / sec, train_flops_per_step=step_flops,
             mfu=step_flops / sec / PEAK_FLOPS['bfloat16'],
             peak_mem_gib=peak, launches_per_step=launches,
             expected_launches=expect, card=smi)
    finite = all(math.isfinite(v) for v in losses + norms)
    counts_ok = all(ln == expect for ln in launches)
    r['profile'] = profile_dispatch(torch, lambda: step(state, clips[-1], gen))
    log('6 train', json.dumps(r))

    # the exact forward: K1 in every block, against the plain dense path
    # on the same (trained) weights. The check is in f32 with TF32 off, at
    # apply_vmae's own bound (tests/test_vmae.py: atol 2e-4 / rtol 1e-4).
    # The bf16 run is reported: two bf16 paths that round the attention
    # probabilities at different points drift apart by a few bf16 ulps
    # over 36 layers, which measures the rounding, not the kernel (phase 3
    # holds bf16 K1 to its plain version at these shapes).
    model = state.model
    del state, step                      # the optimizer's moments
    for p in model.parameters():
        p.grad = None
    weights = model.state_dict()
    del model
    xv = clips[0].transpose(1, 2).contiguous()
    mask = mask_fn(gen, B_TRAIN)
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd = {}
    for dn, dtype in (('bfloat16', torch.bfloat16), ('float32', torch.float32)):
        outs = {}
        for impl in ('dense', 'flash'):
            module = vmae.PretrainVisionTransformerModule(
                dataclasses.replace(cfg, dtype=dtype, attn_impl=impl),
                device=dev)
            module.load_state_dict(weights, strict=True)
            port.kernels.reset_launches()
            t1 = time.perf_counter()
            outs[impl] = vmae.apply_vmae(module, xv, mask, n_vis)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            del module
        launches_fwd = dict(port.kernels.LAUNCHES)   # of the flash run
        y, ref = outs['flash'], outs['dense']
        fwd[dn] = dict(batch=B_TRAIN, shape=list(y.shape), flash_seconds=secs,
                       launches=launches_fwd, max_abs_err=max_err(y, ref),
                       mean_abs_err=float((y.float() - ref.float()).abs().mean()),
                       max_abs_plain=float(ref.float().abs().max()),
                       finite=bool(torch.isfinite(y.float()).all()))
        ok = (fwd[dn]['finite']
              and launches_fwd == dict(zeros, flash_attention=depth)
              and tuple(y.shape) == (B_TRAIN, cfg.num_patches - n_vis,
                                     cfg.out_dim))
        if dtype == torch.float32:
            fwd[dn]['tol'] = TOL_GRAD
            ok = ok and bool(torch.allclose(y, ref, **TOL_GRAD))
        fwd[dn]['ok'] = ok
        del outs, y, ref
    r['apply_vmae'] = fwd
    log('6 train', 'apply_vmae ' + json.dumps(fwd))
    ok_fwd = fwd['bfloat16']['ok'] and fwd['float32']['ok']
    rec['phase6'] = r
    if not (finite and counts_ok and ok_fwd):
        raise AssertionError('full-width training failed')
    return r


def _category(kernel_name):
    k = kernel_name.lower()
    for cat, keys in (('attention kernel (K1/K2/K5)', ('attention_kernel',
                                                       'attention_fwd_sm90')),
                      ('attention backward kernel (K6)', ('dkdv_kernel',
                                                          'dq_kernel',
                                                          'dkdv_sm90',
                                                          'dq_sm90')),
                      ('window lookup kernel', ('window_lookup',)),
                      ('convolution', ('conv', 'cudnn', 'implicit',
                                       'xmma_fprop', 'winograd')),
                      ('matmul', ('gemm', 'cutlass', 'nvjet', 'cublas')),
                      ('softmax/reduce', ('softmax', 'reduce'))):
        if any(x in k for x in keys):
            return cat
    return 'elementwise/copy/other'


def sm90_fragment(fn, d):
    """The part of the mangled name of kernel fn<d> (a function template in
    an unnamed namespace) that names it: '18attention_fwd_sm90ILi64E'."""
    return f'{len(fn)}{fn}ILi{d}E'


def ptxas_report(log):
    """{mangled kernel name: {registers, spill_stores, spill_loads}} from
    nvcc -Xptxas -v."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            out[cur] = {}
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', ln)
        if m and cur:
            out[cur]['registers'] = int(m.group(1))
    return out


def hgmma_counts(lib_path):
    """{mangled kernel name: HGMMA instructions} from cuobjdump -sass, or
    None where the toolkit has no cuobjdump."""
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    tool = shutil.which('cuobjdump') or os.path.join(cuda_home, 'bin',
                                                     'cuobjdump')
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r'Function : (\w+)', ln)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and 'HGMMA' in ln:
            counts[cur] += 1
    return counts


def profile_dispatch(torch, fn):
    """Device time by kernel of one dispatch (or train step) under
    torch.profiler, and the device's busy share of its wall time. A measurement, not a
    check: a profiler that records no device time gives 'not measured'."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels_us = _device_us(prof)
        busy_ms = sum(kernels_us.values()) / 1e3
        if busy_ms <= 0:
            return 'not measured (no device time in the trace)'
        cats = {}
        for k, us in kernels_us.items():
            cats[_category(k)] = cats.get(_category(k), 0) + us / 1e3
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]
        return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                    idle_share=max(0.0, 1 - busy_ms / wall_ms),
                    by_category_ms=dict(sorted(cats.items(),
                                               key=lambda kv: -kv[1])),
                    top_kernels_ms=[[k[:90], us / 1e3] for k, us in top])
    except Exception as e:  # the trace is optional; report why it is absent
        return f'not measured ({type(e).__name__}: {e})'


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--record', help='write the full record as JSON here')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch.nn.functional as F
    import counterfactualworldmodels_tpu_torch as port
    from counterfactualworldmodels_tpu_torch.models.raft import corr
    from counterfactualworldmodels_tpu_torch.ops import flash_attention as fa

    rec = {'phase3': [], 'phase4': [], 'phase5': []}
    failed = []
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    rec['device'] = dict(name=kind, smi=smi, torch=torch.__version__,
                         cuda=torch.version.cuda, count=torch.cuda.device_count())
    log('1 device', json.dumps(rec['device']))

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            log(name, f'ok in {time.perf_counter() - t0:.1f}s')
            return out
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            log(name, 'FAILED')
            failed.append(name)
            return None

    def build():
        t0 = time.perf_counter()
        reports = port.kernels.build()
        rec['build_s'] = time.perf_counter() - t0
        log('2 build', f'nvcc built {sorted(reports)} in {rec["build_s"]:.1f}s')
        rec['build'] = {}
        for name in port.kernels.SOURCES:
            path = port.kernels.library_path(name)
            with open(path + '.log') as f:
                kernels = ptxas_report(f.read())
            hgmma = hgmma_counts(path)
            if hgmma is None:
                log('2 build', f'{name}: the toolkit has no cuobjdump: '
                               'HGMMA not counted')
            for kernel, info in kernels.items():
                if hgmma is not None:
                    info['hgmma'] = hgmma.get(kernel, 0)
                log('2 build', f'{name}: {kernel} {json.dumps(info)}')
            if hgmma is not None:
                log('2 build', f'{name}: {sum(hgmma.values())} HGMMA '
                               'instructions in the library')
            rec['build'][name] = kernels
            for fn in SM90_KERNELS.get(name, ()):
                for d in HEAD_DIMS:
                    found = [v for k, v in kernels.items()
                             if sm90_fragment(fn, d) in k]
                    if len(found) != 1:
                        raise AssertionError(f'{name}: {fn}<{d}> is not in '
                                             'the ptxas report once')
                    info = found[0]
                    if hgmma is not None and not info['hgmma']:
                        raise AssertionError(f'{name}: {fn}<{d}> has no HGMMA')
                    if d == 64 and (info.get('spill_stores')
                                    or info.get('spill_loads')):
                        raise AssertionError(f'{name}: {fn}<64> spills: {info}')

    phase('2 build', build)
    if not failed:
        phase('3 kernels', attention_cases, torch, F, fa, rec)
        phase('3 kernels', lookup_cases, torch, F, corr, rec)
        phase('3 kernels', training_kernel_cases, torch, F, fa, rec)
        phase('4 small slice', small_slice, torch, port, rec)
        phase('4 small train', small_train, torch, port, rec)
        torch.backends.cudnn.allow_tf32 = True
        full = phase('5 full width', full_width, torch, port, rec, smi)
        train = phase('6 train', full_train, torch, port, rec, smi)
        phase('7 convc1', convc1_kernels, torch, rec)
    rec['failed'] = failed
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, 'w') as f:
            json.dump(rec, f, indent=1)
    if failed:
        print(f'chip_smoke: failed phases {failed}', file=sys.stderr)
        return 1

    def pick(kernel, dtype, case):
        return next(r for r in rec['phase3'] if r['kernel'] == kernel
                    and r['dtype'] == dtype and r['case'] == case)

    # launches: one default-rung dispatch (K1-K4), one train step (K5, K6)
    default_launches = full[0]['launches']
    step_launches = train['launches_per_step'][-1]
    table = []
    for kid, kernel, dtype, case, launches, replaces in (
            ('K1', 'flash_attention', 'bfloat16', 'encoder prefix',
             default_launches, REPLACES['flash_attention']),
            ('K2', 'flash_attention_prefix', 'bfloat16', 'pool4 rung',
             default_launches, REPLACES['flash_attention_prefix']),
            ('K3', 'window_lookup', 'float32', 'pyramid 28/14/7/3',
             default_launches, REPLACES['window_lookup']),
            # K3 and K4 differ only in TPU layout: one kernel serves both
            ('K4', 'window_lookup', 'float32', 'pyramid 28/14/7/3',
             default_launches, REPLACES_K4),
            ('K5', 'flash_attention_lse', 'bfloat16', 'encoder',
             step_launches, REPLACES['flash_attention_lse']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'encoder',
             step_launches, REPLACES['flash_attention_bwd'])):
        r = pick(kernel, dtype, case)
        table.append(dict(name=kernel, tpu_kernel=kid, route='cuda',
                          source=SOURCES[kernel], replaces=replaces,
                          launches=launches[kernel],
                          max_abs_err=r['max_abs_err'], ms=r['ms'],
                          plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                          bound_by=r['bound_by'],
                          library_ms=r['library_ms']))
    print(json.dumps({'kernels': table}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
