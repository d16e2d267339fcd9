#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Builds the port's CUDA kernels from ``counterfactualworldmodels_tpu_torch/
csrc`` and drives its two paths through the entry points a user calls:
counterfactual flows, through the shared-prefix dispatch
``pipelines.segmentation.counterfactual_videos_and_flows_fast`` (ViT-L 4x4
@224 + RAFT-24, bf16, S = 16 prompts) and through ``FlowGenerator``, which
serves the motion maps, the per-click predictions and the multi-scene
dispatch; movability, through ``pipelines.movability.MovabilityPredictor``
(the same models and a RAFT-24 keypoint predictor); the IMU-conditioned
path, through ``pipelines.imu.ImuConditionedFlowGenerator`` and
``pipelines.movability.ImuConditionedMovabilityPredictor`` (the
IMU-conditioned ViT-B 4x4 predictor and flow2imu, bf16, with RAFT-24);
and VMAE training ``training.train.make_train_step`` (ViT-L 4x4 @224,
bf16, batch 4, mask ratio 0.9), all from seeded random weights. Phases:

1. device: name, power limit, torch and CUDA versions;
2. build: nvcc for sm_90a, with the seconds it took; each kernel's
   registers and spills (ptxas) and its count of HGMMA (wgmma)
   instructions in ``cuobjdump -sass``: every tensor-core attention
   kernel (bf16 ``*_sm90``; f32 in split tf32, the forward
   ``attention_fwd_tf32`` and the backward ``dkdv_tf32`` / ``dq_tf32``)
   must be there at each head dim, hold some, and not spill at D = 64;
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes, in f32 and bf16, with the kernel's, the plain version's
   and one library call's times, the ratio to the library call and the
   share of the bound (f32 attention rows: the split-tf32 tensor-core
   bound, 3 x operations / 495 TFLOP/s, with the CUDA-core bound beside
   it; rows under 0.1 ms also timed by CUDA-graph replay, kernel and
   library call); the window lookup (f32 sums) one level per call and
   fused, four levels in one launch as a RAFT iteration calls it, at the
   large RAFT's radius 4 and the small one's 3, with f32 and bf16 output,
   timed by CUDA-graph replay beside CUDA events; the
   training pair (K5 forward with logsumexp, K6 backward) at the encoder
   and decoder training shapes, in bf16 and f32, with K6's determinism
   check; the IMU
   path's shapes: K1 at the ViT-B 4x4 prefix and at the IMU stream's head
   dim 32, K2 at the conjoined decoder suffix; K2 with own-key lengths at
   the cf and imu encoder suffixes (3 samples a block in bf16), against
   K2's plain version; K1, K5 and K6 at head dims
   8, 24 and 48 (run padded to 16, 32 and 64) in f32 and bf16; K5 and K6
   at the ChannelMAE trainer's shapes (with and without the flow group)
   and at the imu400 main stream's; K1, K5 and K6 at one tp = 2 rank's
   heads and K1 at an sp = 2 rank's queries (phase 9's shapes); phase
   10's: K5 and K6 in f32 at the Soft ChannelMAE's structure-extraction
   shapes, K1 and K2 at the fidelity report's S = 8 legs (f32 and bf16)
   and at the demo's ViT-B 8x8; the residual add + LayerNorm pass at the
   benchmark dispatch's suffix rows (the sum bitwise, the rows within one
   bf16 ulp), against ``x + r`` then ``F.layer_norm``; the qkv pass at the
   cf and imu decoder suffixes (q and unpooled k, v bitwise, pooled k, v
   within one bf16 ulp), against the bias add, head split, scale and pool
   the engine ran before;
4. both paths at the tests' small configurations on the card and on the
   CPU (f32, TF32 off): masks equal, videos and flows within tolerance;
   three train steps with equal losses and gradient norms; FlowGenerator
   on both engines from the same draws (videos within 1e-4, flows within
   1e-3 px); RAFT(small=True) and the keypoint head RAFT(output_dim=1) at
   64x64 (flows within 1e-3 px, the map within 1e-4, the small model's
   lookups at radius 3); a small MovabilityPredictor (num_iters=1) from the
   same draws (maps within 1e-3, every iteration's patches equal); the
   small IMU-conditioned pipeline (both engines, with the static-scene
   IMU from flow2imu) and a small IMU movability predictor, card against
   CPU within 1e-3, with their launch counts; three steps of
   ``make_cmae_train_step`` (a tiny ChannelMAE, encoder head dim 48) and
   of ``make_conjoined_train_step`` (train_conjoined's ``small`` model,
   head dims 24, 16 and 8), losses and gradient norms within 1e-4, and the
   tiny ChannelMAE's ``channel_mae_predict_image`` within 1e-4 (K1);
5. the full-width dispatch at the library-default rung and the exact rung:
   shapes, finite flows, visible frame-1 pixels pasted unchanged, and the
   launch counts that show every kernel of the path ran (the LayerNorm
   pass 147 a dispatch, the qkv pass 72; the later phases through the
   shared-prefix engines count the attention kernels and the lookup only,
   and phase 11 the LayerNorm and qkv passes too); then (5b)
   ``pipelines.segmentation.FlowGenerator`` on the same weights: (a) a cold
   scene's motion map (K1 36, K2 36 of which the encoder's 24 packed,
   lookup 24, one LRU miss), held against the direct dispatch on its
   prompts and draws, (b) the same scene again (K1 0, K2 36, lookup 24,
   one hit), (c) a per-click predict on the warm scene (K2 36 only), (d)
   the exact engine on 4 prompts (K1 36, lookup 24), (e) the multi-scene
   dispatch over 4 scenes' stacked prefix caches (K2 36, each with s0 =
   4, none packed, lookup 24); each timed, median of 3 after a
   warm-up, with the generator's overhead over the direct dispatch, (a)'s
   time split within a call (sampler, chunk, filter, the rest) on 3 more
   cold scenes, and the LRU key's host time; then (5c)
   ``MovabilityPredictor(...)(x)`` at the library defaults (keypoint
   initialisation, 16 initial samples, 2 iterations of 16, chunks of 4)
   with a RAFT-24 keypoint predictor: ms per call (median of 3 after a
   warm-up, a new image each call), the keypoint predictor's ms within a
   call, the launches per call (K1 36, K2 432, lookup 312), the outputs'
   checks, flow_to_rgb on the card against the CPU, one more call's split
   (keypoints, samplers, chunks, filters) and one timed call without the
   flow-sample filter (its later iterations sample from a real map); then
   (5d) the IMU-conditioned path at full width: (a) a cold motion map of
   16 prompts in one chunk with the static-scene IMU (K1 48: flow2imu's
   32 and the prefix's 16; K2 16, the encoder's 12 packed; lookup 72:
   FramePairFlow's forward and backward RAFT-24 and the probe), (b) the
   same scene again (an LRU hit: K1 32, K2 16, lookup 72), (c) the exact
   engine on 4 prompts (K1 64, lookup 72), (d)
   ``ImuConditionedMovabilityPredictor(...)(x)`` at the library defaults
   with a RAFT-24 keypoint predictor (K1 112, K2 192,
   lookup 456 per call) and one unfiltered call, each the median of 3
   after a warm-up, with peak memory and the split of one more cold map
   (flow2imu, sampler, chunk, filter, the rest); then (5e) the HTTP
   server ``serve.CwmService`` on phase 5's weights behind a
   ThreadingHTTPServer after its warmup: /health, /predict (K1 36, K2
   36), a cold /counterfactual of 16 samples (K1 36, K2 36, lookup 24, one
   service-LRU miss), the same again (K2 36, lookup 24), 4 concurrent
   same-scene requests in one dispatch (K2 36, lookup 24) and 4
   concurrent requests on new scenes in one mixed-scene dispatch (K1 144,
   K2 36 with s0 = 4, lookup 24), /stats; each route timed over HTTP
   (median of 3 after a warm-up) and one warm request split (JSON, image
   parse, dispatch, PNGs, the rest); ``serve.ImuCwmService`` on phase
   5d's models (/counterfactual cold and warm, /movability at the
   server's defaults with the static IMU cached); the interactive
   interface's click, 'f', 'b' and 'x' on a ViT-L FlowGenerator through a
   stub axes object; the server's PNG writer against a decoder written
   here; the default dispatch's profile comes after these;
6. full-width training: one warm-up and three timed steps with finite
   losses, sec/step, clips/s, MFU and peak memory, and the launch counts
   of every step (K5 72, K6 36, K1 0); then the exact forward
   ``models.vmae.apply_vmae`` (K1 36) against the plain dense path,
   checked in f32 and reported in bf16; (6b) the ChannelMAE and conjoined
   trainers through their entry points' ``main(argv)``: ``train_cmae`` at
   the script's defaults (ViT-B, 224 px, 32 px patches, batch 32), the
   same with ``--with-flow`` (RAFT-12 on every batch), and
   ``train_conjoined --model imu400`` (batch 8), each one warm-up, three
   timed steps and one profiled step (device busy time, idle share, time
   by kernel class), with every step's launches asserted (K5 32 / K6 16,
   plus lookup 12 with the flow; imu400 K5 64 / K6 32), sec/step,
   samples/s and peak memory; (6c) a seeded shard of 64 clips of
   2x224x224x3 uint8 with an IMU sidecar, the native loader built afresh
   from the port's ``data/native/clip_loader.cpp``, ``train_vmae --shard
   --input-mode u8`` at its defaults for 4 steps with a checkpoint every
   2, resumed from step 2 in a new state (steps 3-4 bitwise the
   uninterrupted run's losses), and ``train_conjoined --shard`` on the sidecar for
   2 steps, resumed from step 1;
8. RAFT training and data-parallel work (before phase 7): (a)
   ``training.train_raft --mode flow`` through ``main(argv)`` at the
   script's defaults (large RAFT, 224 px, batch 8, 12 iterations, remat,
   bf16, synthetic warps): one warm-up, three timed steps (sec/step,
   pairs/s, peak memory) and one profiled step (busy share, the gather
   lookup's device ms forward and backward, beside the lookup timed alone),
   finite losses and EPE, no lookup kernel in any step; (b) ``--mode
   keypoint --teacher movability --teacher-model tiny`` for 2 steps, the
   teacher's K1, K2 and lookup launches asserted; (c) the small RAFT's
   flow and keypoint train steps card against CPU (f32, TF32 off, 64 px,
   3 steps each, within 1e-4); (d) a process group of one rank over NCCL:
   ``make_sharded_train_step`` at phase 6's configuration, three steps
   bitwise ``make_train_step``'s (K5 72 / K6 36 a step), and
   ``parallel.sharded_counterfactuals_fast`` on phase 5's dispatch (K1 36,
   K2 36, lookup 24; masks bitwise, videos within phase 5b's bar); (e) two
   gloo ranks sharing the card (spawned processes): three dp steps of the
   tests' small VMAE against the single-process step on the global batch
   and the tiny sample-sharded dispatch against the direct one, within the
   CPU tests' tolerances, every rank's parameters bitwise equal;
9. model sharding (after phase 8): (a) a process group of one rank over
   NCCL, mesh {'dp': 1, 'tp': 1}: ``make_sharded_train_step`` at phase 6's
   configuration through the tensor-parallel modules (the two autograd
   Functions at size 1, the tp-aware clip), three steps bitwise
   ``make_train_step``'s, K5 72 / K6 36 a step; then two gloo ranks sharing
   the card, mesh {'dp': 1, 'tp': 2}: (b) the VMAE step at ViT-L 4x4 @224
   widths with its depth cut to 2 encoder + 1 decoder blocks (two f32
   steps within 1e-5 of the single-process step on the card: losses,
   grad_norm and the gathered parameters; four bf16 steps, sec/step of the
   last three and the share of a step in the gloo all-reduces; K5 and K6
   counted by shape at the halved heads), the small ChannelMAE and
   conjoined steps against their single-process steps; (c) the tp, sp and
   pp encoder forwards at ViT-L widths (4 blocks, the 3136-token prefix,
   pp 2 stages x 2 microbatches) against the sequential stack, in f32 and
   bf16, K1 counted by shape ([1,8,3136,3136,64] tp, [1,16,1568,3136,64]
   sp); (d) ``train_vmae --synthetic --model base --tp 2`` through
   ``main(argv)`` for 2 steps with a checkpoint, resumed in this process
   at tp = 1: the third loss within 1e-5 of an uninterrupted tp = 1 run's;
10. the remaining entry points, ``scripts/`` (after phase 9): (a)
   ``extract_structure`` at --model paper (f32): 100 steps timed with K5
   16 / K6 16 a step asserted, the visibility falling, then ``main(argv)``
   (both PNGs decoded here), and the tiny model card against CPU over 10
   steps (losses within 1e-4 relative); (b) ``make_shards.main`` on a
   seeded .npy of 64 clips of 2x224x224x3 with an IMU stream, 32 a shard:
   two shards and sidecars read back bitwise through the native loader,
   clips per second; (c) ``fidelity_report.main`` at --model large
   --samples 8 --max-images 2, bf16 with the f32 decomposition and the
   conjoined flagship, every leg's ms and launches asserted, the JSON in
   chiprun_out/fidelity_report.json; (d) the demo at --model base, then
   --model large --movability, each step's ms and launches, every PNG
   decoded here;
11. the measurement entry points (after phase 10): each script's
   ``main(argv)`` at full width: ``bench`` (ViT-L 4x4 + RAFT-24, bf16, S =
   16, the S probe at 64, the rung ladder, the stages; K1 36, K2 36, lookup
   24 a dispatch), ``bench_sweep --sizes 16``, ``latency_bench --model
   large`` (the cold prediction, the warm click, the imu400 click),
   ``serve_latency`` to prompt 16, ``loadgen`` at base 224,
   ``bench_conjoined`` at imu400 (both engines), ``bench_train``'s ten
   families at 2 steps (K5 / K6 a step asserted), ``bench_loader`` and
   ``bench_attention`` at S = 16; every JSON line parsed, finite, with a
   positive headline, and each cut of a default listed in the record;
7. the kernels RAFT's ``convc1`` launches on the lookup's bf16 output
   (torch.profiler, last: it makes every later launch cost more).

Exits non-zero without a result line if there is no GPU or any phase
fails. Otherwise the last three lines are the kernel table (JSON: each
row's launches on the path of its shapes, and the kernel's launches on
every path), the card's ``nvidia-smi`` name and power limit, and the
result line.
``--record PATH`` also writes the full record of every phase (timings,
errors, the profile of a dispatch) as JSON to PATH.
"""
import argparse
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12
# f32 attention's bound: the tensor cores in tf32 (495 TFLOP/s) at three
# products per f32-accurate product (split tf32, csrc/sm90_mma.cuh)
PEAK_TF32 = 495e12
SPLIT_TF32_PASSES = 3
# rows whose kernel takes less than this are also timed by CUDA-graph
# replay: there CUDA events around back-to-back calls time the Python
GRAPH_BELOW_MS = 0.1

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
# the tensor-core kernels (bf16, and f32 in split tf32), each built for
# these head dims: the build phase finds each in the ptxas report and the
# SASS by its mangled name
SM90_KERNELS = {'attention': ('attention_fwd_sm90', 'attention_fwd_tf32'),
                'attention_bwd': ('dkdv_sm90', 'dq_sm90', 'dkdv_tf32',
                                  'dq_tf32')}
# the template arguments after the head dim of a kernel built more than
# once a head dim: attention_fwd_sm90<D, PACK> (PACK: the packed K2)
SM90_VARIANTS = {'attention_fwd_sm90': ('Lb0E', 'Lb1E')}
HEAD_DIMS = (16, 32, 64, 128)
S_FULL = 16
# the tests' small VMAE (tests/torch_port_common.SMALL_VMAE)
SMALL_VMAE = dict(img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
                  encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
                  decoder_depth=2, decoder_num_heads=2, num_frames=2,
                  qkv_bias=True)
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


# The residual add + LayerNorm pass runs once per norm of the shared-prefix
# engines, the qkv pass once per block. Phases that run those engines
# compare the other kernels' launches by path and leave these two counters
# out (strip_norm); phases 5 and 11 hold them to the engine's counts
# (norm_launches, qkv_launches); every other phase expects them at 0 with
# the rest.
NORM = 'add_layer_norm'
QKV = 'qkv_heads'


def strip_norm(launches):
    return {k: v for k, v in launches.items() if k not in (NORM, QKV)}


def engine_launches(port):
    """The launch counts, the LayerNorm and qkv passes' left out."""
    return strip_norm(port.kernels.LAUNCHES)


def suffix_k2(enc, dec, passes=1, packed=False):
    """K2's launches in `passes` suffix passes of a shared-prefix engine
    with `enc` encoder and `dec` decoder blocks over prompts with visible
    frame-1 tokens: every encoder block (those tokens against the encoder
    prefix) and every decoder block. packed: bf16 with a shared prefix,
    where the encoder blocks' launches pack samples (Nq, the bucket of the
    visible count, is at most 64)."""
    return dict(flash_attention_prefix=passes * (enc + dec),
                flash_attention_prefix_packed=passes * enc if packed else 0)


def norm_launches(enc_depth, dec_depth, prefix):
    """The LayerNorm pass's launches in one suffix pass of the VMAE engine
    (two a block, enc_norm, dec_norm), plus the scene's prefix where it is
    built (two a block, enc_norm): 74 and 147 at ViT-L."""
    suffix = 2 * enc_depth + 2 * dec_depth + 2
    return suffix + (2 * enc_depth + 2 * dec_depth + 1 if prefix else 0)


def qkv_launches(enc_depth, dec_depth, prefix):
    """The qkv pass's launches in one suffix pass of the VMAE engine (one
    a block), plus the scene's prefix where it is built: 36 and 72 at
    ViT-L."""
    return (enc_depth + dec_depth) * (2 if prefix else 1)


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
    """{kernel name: device microseconds} of a torch.profiler run. User
    annotations (the optimizer's ``Optimizer.step#...`` range) are spans
    over kernels already counted, not kernels, and are left out."""
    out = {}
    for e in prof.key_averages():
        if (not str(e.device_type).endswith('CUDA')
                or getattr(e, 'is_user_annotation', False)):
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


def attention_bound(flops, nbytes, dtype_name):
    """bound_ms and bound_by of an attention row; f32 rows at the split-tf32
    tensor-core rate (SPLIT_TF32_PASSES x operations / PEAK_TF32), with
    the CUDA-core figure beside it as bound_cuda_core_ms."""
    if dtype_name != 'float32':
        bms, by = bound(flops, nbytes, dtype_name)
        return dict(bound_ms=bms, bound_by=by)
    t_ops = SPLIT_TF32_PASSES * flops / PEAK_TF32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                bound_cuda_core_ms=bound(flops, nbytes, 'float32')[0])


def add_graph_ms(torch, r, kernel_fn, library_fn=None):
    """A row whose kernel takes under GRAPH_BELOW_MS: its device time by
    CUDA-graph replay (graph_ms), and the library call's where one is
    given; None where the library call cannot be captured."""
    if r['ms'] >= GRAPH_BELOW_MS:
        return
    r['graph_ms'] = graph_ms(torch, [kernel_fn])
    if library_fn is not None and r.get('library_ms') is not None:
        try:
            r['library_graph_ms'] = graph_ms(torch, [library_fn])
        except Exception as e:  # a yardstick only: report it and carry on
            print(f'library call not captured: {type(e).__name__}: {e}',
                  file=sys.stderr)
            r['library_graph_ms'] = None


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
        # the IMU-conditioned path (phase 5d): the ViT-B 4x4 prefix and
        # the IMU context decoder of the exact engine (head dim 32)
        ('ViT-B 4x4 prefix', 1, 12, 3136, 3136, 64),
        ('IMU context decoder, D 32', 4, 6, 50, 50, 32),
        # head dims the kernels run padded (to 16, 32, 64): the small
        # conjoined model's IMU decoder (D 8) and main encoder (D 24), the
        # tiny ChannelMAE's encoder (D 48) at the trainers' batches
        ('padded D 8', 8, 4, 50, 50, 8),
        ('padded D 24', 8, 4, 39, 39, 24),
        ('padded D 48', 32, 2, 13, 13, 48),
        # model sharding (phase 9 (c)): a tp = 2 rank's heads of the ViT-L
        # prefix, and an sp = 2 rank's local queries against every key
        ('tp 2 encoder prefix', 1, 8, 3136, 3136, 64),
        ('sp 2 local queries', 1, 16, 1568, 3136, 64),
        # the fidelity report's exact legs (phase 10 (c), S = 8): the
        # encoder over 3136 + 33 visible tokens, the decoder over all
        ('exact encoder S 8', 8, 16, 3169, 3169, 64),
        ('exact decoder S 8', 8, 8, 6272, 6272, 64),
        # the demo's ViT-B 8x8 prefix (phase 10 (d))
        ('ViT-B 8x8 encoder prefix', 1, 12, 784, 784, 64),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split('.')[1]
        for label, b, h, nq, nk, d in k1_cases:
            q = rnd(b, h, nq, d, dtype=dtype, scale=d ** -0.5)
            k = rnd(b, h, nk, d, dtype=dtype)
            v = rnd(b, h, nk, d, dtype=dtype)
            out = fa.flash_attention(q, k, v)
            ref = fa.dense_attention(q, k, v)
            err = max_err(out, ref)
            tol = attention_tol(dn, ref, TOL_F32)
            ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
            plain_ms = time_ms(torch,
                               lambda: fa.dense_attention(q, k, v))
            lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0))
            item = q.element_size()
            flops = 4 * b * h * nq * nk * d
            nbytes = item * b * h * d * (2 * nq + 2 * nk)
            r = dict(kernel='flash_attention', case=label, dtype=dn,
                     shape=[b, h, nq, nk, d], max_abs_err=err, tol=tol,
                     max_abs_plain=float(ref.float().abs().max()),
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     **attention_bound(flops, nbytes, dn),
                     tflops=flops / ms / 1e9)
            add_graph_ms(torch, r, lambda: fa.flash_attention(q, k, v),
                         lambda: F.scaled_dot_product_attention(q, k, v,
                                                                scale=1.0))
            rec['phase3'].append(with_ratios(r))
            log('3 kernels', json.dumps(r))
            if not err <= tol:
                raise AssertionError(f'K1 {label} {dn}: err {err} > {tol}')

    k2_cases = [  # (label, S, H, Nq, N0, N1, S0, w0, w1)
        ('exact rung', 16, 8, 3136, 3136, 3136, 1, 1.0, 1.0),
        ('pool4 rung', 16, 8, 3136, 196, 196, 1, 16.0, 16.0),
        # the multi-scene dispatch: 4 scenes' prefixes, the exact rung
        ('stacked prefixes s0=S', 4, 8, 3136, 3136, 3136, 4, 1.0, 1.0),
        # the conjoined decoder suffix (phase 5d): frame 1's 3136 rows and
        # the 64 null-padding rows against the prefix and themselves
        ('conjoined decoder suffix', 16, 6, 3200, 3136, 3200, 1, 1.0, 1.0),
        # the fidelity report's engine legs (phase 10 (c), S = 8) and the
        # demo's ViT-B 8x8 motion map at its default rung (phase 10 (d))
        ('exact rung S 8', 8, 8, 3136, 3136, 3136, 1, 1.0, 1.0),
        ('pool4 rung S 8', 8, 8, 3136, 196, 196, 1, 16.0, 16.0),
        ('ViT-B 8x8 pool4 S 8', 8, 6, 784, 49, 49, 1, 16.0, 16.0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split('.')[1]
        for label, s, h, nq, n0, n1, s0, w0, w1 in k2_cases:
            q = rnd(s, h, nq, 64, dtype=dtype, scale=0.125)
            k0, v0 = (rnd(s0, h, n0, 64, dtype=dtype) for _ in range(2))
            k1, v1 = (rnd(s, h, n1, 64, dtype=dtype) for _ in range(2))
            args = (q, k0, v0, k1, v1, w0, w1)
            out = fa.flash_attention_prefix(*args)
            ref = fa._dense_attention_prefix(*args)
            err = max_err(out, ref)
            tol = attention_tol(dn, ref, TOL_K2_F32)
            ms = time_ms(torch, lambda: fa.flash_attention_prefix(*args))
            plain_ms = time_ms(torch,
                               lambda: fa._dense_attention_prefix(*args))
            kc = torch.cat([k0.expand(s, -1, -1, -1), k1], 2)
            vc = torch.cat([v0.expand(s, -1, -1, -1), v1], 2)
            bias = torch.cat([torch.full((n0,), math.log(w0), device=dev),
                              torch.full((n1,), math.log(w1), device=dev)]
                             ).to(dtype)
            mask = None if w0 == w1 == 1.0 else bias[None]
            lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, scale=1.0))
            item = q.element_size()
            flops = 4 * s * h * nq * (n0 + n1) * 64
            nbytes = item * 64 * h * (2 * s * nq + 2 * s0 * n0 + 2 * s * n1)
            r = dict(kernel='flash_attention_prefix', case=label, dtype=dn,
                     shape=[s, h, nq, n0, n1, 64, s0], weights=[w0, w1],
                     max_abs_err=err, tol=tol,
                     max_abs_plain=float(ref.float().abs().max()),
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     **attention_bound(flops, nbytes, dn),
                     tflops=flops / ms / 1e9)
            add_graph_ms(torch, r, lambda: fa.flash_attention_prefix(*args),
                         lambda: F.scaled_dot_product_attention(
                             q, kc, vc, attn_mask=mask, scale=1.0))
            del kc, vc
            rec['phase3'].append(with_ratios(r))
            log('3 kernels', json.dumps(r))
            if not err <= tol:
                raise AssertionError(f'K2 {label} {dn}: err {err} > {tol}')

    # the encoder suffix: each sample's 33 visible frame-1 tokens, bucketed
    # to 40, against the encoder prefix and its own tokens, the 7 pad keys
    # masked by an own-key length (K2 with own_len; bf16 packs 3 samples a
    # block) at ViT-L's (cf) and ViT-B's (imu) heads. plain: the dense
    # route it replaces; library: SDPA over the concatenated keys with the
    # pad-key mask
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split('.')[1]
        for label, s, h in (('cf encoder suffix', 256, 16),
                            ('imu encoder suffix', 256, 12)):
            nq, n0, live = 40, 3136, 33
            q = rnd(s, h, nq, 64, dtype=dtype, scale=0.125)
            k0, v0 = (rnd(1, h, n0, 64, dtype=dtype) for _ in range(2))
            k1, v1 = (rnd(s, h, nq, 64, dtype=dtype) for _ in range(2))
            own_len = torch.full((s,), live, dtype=torch.int32, device=dev)
            valid = torch.arange(nq, device=dev) < own_len[:, None]
            packed0 = fa.kernels.LAUNCHES['flash_attention_prefix_packed']
            out = fa.flash_attention_prefix(q, k0, v0, k1, v1,
                                            own_len=own_len)
            packs = (fa.kernels.LAUNCHES['flash_attention_prefix_packed']
                     - packed0)
            ref = fa._dense_attention_prefix(q, k0, v0, k1, v1,
                                             own_valid=valid)
            err = max_err(out, ref)
            tol = attention_tol(dn, ref, TOL_K2_F32)
            ms = time_ms(torch, lambda: fa.flash_attention_prefix(
                q, k0, v0, k1, v1, own_len=own_len))
            plain_ms = time_ms(torch, lambda: fa._dense_attention_prefix(
                q, k0, v0, k1, v1, own_valid=valid))
            kc = torch.cat([k0.expand(s, -1, -1, -1), k1], 2)
            vc = torch.cat([v0.expand(s, -1, -1, -1), v1], 2)
            keys = torch.cat([torch.ones(s, n0, dtype=torch.bool,
                                         device=dev), valid], 1)
            mask = keys[:, None, None]
            lib_ms = library_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, scale=1.0))
            item = q.element_size()
            flops = 4 * s * h * nq * (n0 + live) * 64
            nbytes = item * 64 * h * (2 * s * nq + 2 * n0 + 2 * s * live)
            r = dict(kernel='flash_attention_prefix', case=label, dtype=dn,
                     shape=[s, h, nq, n0, nq, 64, 1], own_len=live,
                     samples_per_block=128 // nq if packs else 1,
                     max_abs_err=err, tol=tol,
                     max_abs_plain=float(ref.float().abs().max()),
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     **attention_bound(flops, nbytes, dn),
                     tflops=flops / ms / 1e9)
            del kc, vc, ref
            rec['phase3'].append(with_ratios(r))
            log('3 kernels', json.dumps(r))
            if not err <= tol:
                raise AssertionError(f'K2 {label} {dn}: err {err} > {tol}')
            if packs != (dtype == torch.bfloat16):
                raise AssertionError(f'K2 {label} {dn}: {packs} packed '
                                     'launches')

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

    for radius in (4, 3):
        fused_lookup_cases(torch, F, corr, rec, radius)


LOOKUP_SIZES = (28, 14, 7, 3)


def fused_lookup_inputs(torch, F, r):
    """The fused lookup of one RAFT iteration at the dispatch shape, radius
    r: four levels [S*784, s, s], coordinates [S, 28, 28, 2] = the pixel
    grid moved by up to 8 px (windows at the borders cross the edges), and
    the reference RAFT's sampling grids. Four copies, called in turn by the
    timings, so that a call finds its data out of L2, as in the dispatch,
    where the update block's convolutions run between two lookups. Returns
    (copies, the yardstick: grid_sample on each level, then the concat, as
    the reference RAFT's CorrBlock does)."""
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(2)
    n = S_FULL * 784
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


def fused_lookup_cases(torch, F, corr, rec, r):
    """The fused lookup at radius r (4: the large RAFT's, 3: the small
    one's) against its plain version, f32 and bf16 out, timed by CUDA-graph
    replay beside the plain version and the library's four grid_sample
    calls and concat."""
    n = S_FULL * 784
    p = 2 * r + 1
    copies, corr_block = fused_lookup_inputs(torch, F, r)
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
                  case=('pyramid 28/14/7/3' + ('' if r == 4 else f', r {r}')
                        + ('' if dt == torch.float32 else ', bf16 out')),
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
        raise AssertionError(f'fused lookup r {r}: err {err}, bf16 output '
                             f'equal to the f32 cast: {bitwise}, launches '
                             f'{per_call}')


# the residual add + LayerNorm pass at the benchmark's counterfactual cell
# (256 prompts a dispatch): the decoder suffix's frame-1 rows and the
# encoder suffix's visible rows (33 a prompt, bucketed to 40)
LN_CASES = (('decoder suffix', 256 * 3136, 512),
            ('encoder suffix', 256 * 40, 1024))


def layer_norm_cases(torch, F, rec):
    """add_layer_norm (bf16 rows, a residual, bf16 scale and bias) against
    its plain version at LN_CASES: the sum bitwise, the normalised rows in
    bf16 ulps of each row's largest magnitude; times of the kernel, the
    plain version and the library's ``x + r`` then ``F.layer_norm``
    (never called by the port); the bound is the bytes it must move,
    x and r read, the sum and the rows written."""
    from counterfactualworldmodels_tpu_torch.ops import layer_norm as ln
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(19)
    bf16 = torch.bfloat16
    bad = []
    for case, rows, d in LN_CASES:
        x, r = (torch.randn(rows, d, device=dev, generator=g).to(bf16)
                for _ in range(2))
        scale = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf16)
        bias = (0.1 * torch.randn(d, device=dev, generator=g)).to(bf16)
        before = ln.kernels.LAUNCHES[NORM]
        h, y = ln.add_layer_norm(x, r, scale, bias)
        per_call = ln.kernels.LAUNCHES[NORM] - before
        ph, py = ln._add_layer_norm_plain(x, r, scale, bias, 1e-6)
        sum_equal = bool(torch.equal(h, ph))
        top = py.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
        ulps = float(((y.float() - py.float()).abs()
                      / torch.exp2(torch.floor(torch.log2(top)) - 7)).max())
        del h, y, ph, py, top

        def kernel():
            return ln.add_layer_norm(x, r, scale, bias)

        def library():
            return F.layer_norm(x + r, (d,), scale, bias, 1e-6)

        bms, by = bound(8 * rows * d, 4 * rows * d * x.element_size(),
                        'bfloat16')
        row = dict(kernel='add_layer_norm', case=case, dtype='bfloat16',
                   shape=[rows, d], residual=True, sum_bitwise=sum_equal,
                   max_ulps=ulps, launches_per_call=per_call,
                   ms=time_ms(torch, kernel),
                   plain_ms=time_ms(torch, lambda: ln._add_layer_norm_plain(
                       x, r, scale, bias, 1e-6)),
                   library_ms=library_ms(torch, library), bound_ms=bms,
                   bound_by=by)
        add_graph_ms(torch, row, kernel, library)
        rec['phase3'].append(with_ratios(row))
        log('3 kernels', json.dumps(row))
        if not (sum_equal and ulps <= 1.0 and per_call == 1):
            bad.append(case)
        del x, r
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f'add_layer_norm against its plain version: '
                             f'{bad}')


# the qkv pass at the benchmark's counterfactual cells (256 prompts a
# dispatch): the cf decoder suffix (ViT-L's decoder, 8 heads, k and v
# pooled 4 x 4 over the 56 x 56 grid) and the imu one (imu400's decoder, 6
# heads, 3136 + 64 rows, unpooled); (case, S, N, heads, d, pool, grid)
QKV_CASES = (('cf decoder suffix', 256, 3136, 8, 64, 4, (56, 56)),
             ('imu decoder suffix', 256, 3200, 6, 64, 1, None))


def qkv_heads_cases(torch, F, rec):
    """qkv_heads (bf16, both biases) against its plain version at
    QKV_CASES: q and unpooled k, v bitwise, pooled k, v in bf16 ulps of
    each value; times of the kernel, the plain version and the library
    yardstick, the passes the engine ran before (the stacked bias added,
    ``permute().contiguous()``, ``q * scale``, the f32 pooled mean), which
    the port no longer calls; the bound is the bytes it must move, qkv
    read, q, k and v written."""
    from counterfactualworldmodels_tpu_torch.ops import linear as lin
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(23)
    bf16 = torch.bfloat16
    bad = []
    for case, s, n, heads, d, pool, grid in QKV_CASES:
        a = heads * d
        qkv = (2 * torch.randn(s, n, 3 * a, device=dev,
                               generator=g)).to(bf16)
        qb, vb = (torch.randn(a, device=dev, generator=g).to(bf16)
                  for _ in range(2))
        scale = d ** -0.5
        before = lin.kernels.LAUNCHES[QKV]
        got = lin.qkv_heads(qkv, qb, vb, heads, scale, pool, grid)
        per_call = lin.kernels.LAUNCHES[QKV] - before
        want = lin._qkv_heads_plain(qkv, qb, vb, heads, scale, pool, grid)
        q_equal = bool(torch.equal(got[0], want[0]))
        kv_equal = all(bool(torch.equal(x, y))
                       for x, y in zip(got[1:], want[1:]))
        ulps = max(float(((x.float() - y.float()).abs() / torch.exp2(
            torch.floor(torch.log2(y.float().abs().clamp_min(1e-30))) - 7)
        ).max()) for x, y in zip(got[1:], want[1:]))
        del got, want

        def kernel():
            return lin.qkv_heads(qkv, qb, vb, heads, scale, pool, grid)

        def library():
            x = qkv + torch.stack([qb, torch.zeros_like(qb), vb]).reshape(-1)
            q, k, v = x.reshape(s, n, 3, heads, d).permute(
                2, 0, 3, 1, 4).contiguous().unbind(0)
            if pool > 1:
                k, v = (lin._pool_grid(t, pool, grid) for t in (k, v))
            return q * scale, k, v

        n_kv = n // (pool * pool)
        nbytes = (3 * s * n * a + s * n * a + 2 * s * n_kv * a) * 2
        bms, by = bound(3 * s * n * a, nbytes, 'bfloat16')
        row = dict(kernel=QKV, case=case, dtype='bfloat16',
                   shape=[s, n, 3 * a], heads=heads, d=d, pool=pool,
                   q_bitwise=q_equal, kv_bitwise=kv_equal, kv_max_ulps=ulps,
                   launches_per_call=per_call, ms=time_ms(torch, kernel),
                   plain_ms=time_ms(torch, lambda: lin._qkv_heads_plain(
                       qkv, qb, vb, heads, scale, pool, grid)),
                   library_ms=library_ms(torch, library), bound_ms=bms,
                   bound_by=by)
        rec['phase3'].append(with_ratios(row))
        log('3 kernels', json.dumps(row))
        if not (q_equal and (kv_equal if pool == 1 else ulps <= 1.0)
                and per_call == 1):
            bad.append(case)
        del qkv
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f'qkv_heads against its plain version: {bad}')


def _close(torch, a, ref):
    """f32: atol 2e-4 / rtol 1e-4; bf16: within 2e-2 of max|ref|."""
    if a.dtype == torch.float32:
        return bool(torch.allclose(a, ref, **TOL_GRAD))
    return max_err(a, ref) <= REL_BF16 * float(ref.float().abs().max())


def training_kernel_cases(torch, F, fa, rec):
    """K5 (forward with logsumexp) and K6 (fused backward) at the training
    shapes: compared with their plain versions at batch 1 for the ViT-L
    VMAE rows, at the training batch for the others, and timed at the
    training batch."""
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, h, nq, nk, d, dtype):
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device=dev)
                    * scale).to(dtype)
        return (rnd(b, h, nq, d, scale=d ** -0.5), rnd(b, h, nk, d),
                rnd(b, h, nk, d), rnd(b, h, nq, d))

    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, dtype, batch compared, batch timed, H, Nq, Nk, D,
               #  launches of (K5, K6) per remat train step)
        ('encoder', bf, 1, B_TRAIN, 16, 3450, 3450, 64, (48, 24)),
        ('decoder', bf, 1, B_TRAIN, 8, 6272, 6272, 64, (24, 12)),
        # the same in f32: the size of the f32 backward's work
        ('encoder', f32, 1, B_TRAIN, 16, 3450, 3450, 64, (48, 24)),
        ('decoder', f32, 1, B_TRAIN, 8, 6272, 6272, 64, (24, 12)),
        ('ragged', f32, 2, 2, 3, 1000, 777, 64, (0, 0)),
        # train_cmae's defaults (ViT-B, 224 px, 32 px patches, batch 32,
        # ratio 0.75): 13 visible tokens, 49 in the decoder; with the flow
        # group 26 and 98
        ('ChannelMAE encoder', bf, 32, 32, 12, 13, 13, 64, (24, 12)),
        ('ChannelMAE decoder', bf, 32, 32, 6, 49, 49, 64, (8, 4)),
        ('ChannelMAE+flow encoder', bf, 32, 32, 12, 26, 26, 64, (24, 12)),
        ('ChannelMAE+flow decoder', bf, 32, 32, 6, 98, 98, 64, (8, 4)),
        # train_conjoined --model imu400, batch 8, ratio 0.9: the main
        # stream's 627 visible tokens and its decoder over 6272 + 64 nulls
        ('imu400 main encoder', bf, 8, 8, 12, 627, 627, 64, (24, 12)),
        ('imu400 main decoder', bf, 8, 8, 6, 6336, 6336, 64, (8, 4)),
        # a tp = 2 rank of the ViT-L step (phase 9 (b)): half the heads
        ('tp 2 encoder', bf, 1, B_TRAIN, 8, 3450, 3450, 64, (48, 24)),
        ('tp 2 decoder', bf, 1, B_TRAIN, 4, 6272, 6272, 64, (24, 12)),
        # structure extraction (phase 10 (a)): the paper Soft ChannelMAE
        # in f32, all 49 tokens in the encoder, 49 + 49 in the decoder;
        # (K5, K6) per optimisation step
        ('Soft ChannelMAE encoder', f32, 1, 1, 12, 49, 49, 64, (12, 12)),
        ('Soft ChannelMAE decoder', f32, 1, 1, 6, 98, 98, 64, (4, 4)),
    ]
    for dt in (f32, bf):
        cases += [  # padded head dims at the small trainers' shapes
            ('padded D 8', dt, 8, 8, 4, 50, 50, 8, (4, 2)),
            ('padded D 24', dt, 8, 8, 4, 39, 39, 24, (8, 4)),
            ('padded D 48', dt, 32, 32, 2, 13, 13, 48, (4, 2))]
    for label, dtype, bc, bt, h, nq, nk, d, per_step in cases:
        dn = str(dtype).split('.')[1]
        q, k, v, do = inputs(bc, h, nq, nk, d, dtype)
        out, lse = fa._flash_forward_lse(q, k, v)
        ref, ref_lse = fa.dense_attention(q, k, v, with_lse=True)
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

        q, k, v, do = inputs(bt, h, nq, nk, d, dtype)
        out, lse = fa._flash_forward_lse(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        ms5 = time_ms(torch, lambda: fa._flash_forward_lse(q, k, v))
        plain5 = time_ms(torch, lambda: fa.dense_attention(
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
        for (kernel, ms, plain, lib, flops, nbytes, err, ok, launches, fn,
             lib_fn) in (
                ('flash_attention_lse', ms5, plain5, lib5, 4 * pairs,
                 item * bt * h * d * (2 * nq + 2 * nk) + 4 * bt * h * nq,
                 err5, ok5, per_step[0],
                 lambda: fa._flash_forward_lse(q, k, v),
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)),
                # the function's work is 10*pairs (the TPU kernel's five
                # products); the two-pass kernel does 14*pairs
                ('flash_attention_bwd', ms6, plain6, lib6, 10 * pairs,
                 item * bt * h * d * (3 * nq + 3 * nk) + 8 * bt * h * nq,
                 err6, ok6, per_step[1],
                 lambda: fa._flash_backward(q, k, v, do, lse, delta), None)):
            r = dict(kernel=kernel, case=label, dtype=dn,
                     shape=[bt, h, nq, nk, d], compared_batch=bc,
                     errors=err, max_abs_err=max(v for n, v in err.items()
                                                 if n != 'max_abs_plain'),
                     ok=ok, ms=ms, plain_ms=plain, library_ms=lib,
                     **attention_bound(flops, nbytes, dn),
                     tflops=flops / ms / 1e9,
                     launches_per_train_step=launches)
            if kernel == 'flash_attention_bwd':
                r['deterministic'] = deterministic
                r['kernel_tflops'] = 14 * pairs / ms / 1e9
            # the backward's library call is the difference of two timed
            # calls (forward + backward, forward): no graph of its own
            add_graph_ms(torch, r, fn, lib_fn)
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
                pad, True, 2, True, None, *rung, n_vis=n_vis)
            outs[dev] = (y.cpu(), f.cpu(), m.cpu(),
                         engine_launches(port))
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
    # the f32 reference-layout weights wait on the host for phase 5b's
    # generator, out of the dispatch's peak memory
    sd = {k: v.cpu() for k, v in sd.items()}
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
                  **suffix_k2(model.encoder_depth, model.decoder_depth,
                              packed=True),
                  window_lookup=24,
                  add_layer_norm=norm_launches(model.encoder_depth,
                                               model.decoder_depth, True),
                  qkv_heads=qkv_launches(model.encoder_depth,
                                         model.decoder_depth, True))

    def dispatch(rung):
        return counterfactual_videos_and_flows_fast(
            model, fp, raft, x, p, a, shifts, noise, pad, True, 24, True,
            None, *rung, n_vis=n_vis)

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
        results.append(r)
        rec['phase5'].append(r)
        log('5 full width', json.dumps(r))
        if not (ok_shapes and finite and masks_ok and pasted
                and launches == expect):
            raise AssertionError(f'full-width {name} rung failed: {r}')
    # the seeded weights, for phase 5b, and the default dispatch, profiled
    # after phase 5b has timed the generator
    return results, dict(model=model, sd=sd, fp=fp, raft=raft,
                         default=default, pad=pad,
                         inputs=dict(x=x, p=p, a=a, shifts=shifts,
                                     noise=noise, n_vis=n_vis),
                         default_ms=results[0]['ms_per_dispatch'],
                         dispatch=lambda: dispatch(default))


def fixed_draws(torch, gen, seed):
    """Give a FlowGenerator numpy-seeded draws (shifts, rectangularizer
    noise, the patch sampler's indices) on its device, so that generators
    on two devices build the same prompts."""
    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(gen.device)

    gen._draw_shifts = lambda s: tensor(rng.randint(-2, 3, (s, 2)))
    gen._draw_prompt_noise = lambda rows, n: tensor(
        (rng.rand(rows, n) * 0.999).astype(np.float32))
    gen._draw_patch_indices = lambda p, k: tensor(
        rng.randint(0, p.shape[1], (p.shape[0], k)))
    return gen


def small_generator(torch, port, rec):
    """FlowGenerator at the small configuration, f32, on the card and on
    the CPU from the same weights and draws: sample_counterfactual_motion_map
    and predict_counterfactual_videos_and_flows on both engines, with the
    launch counts of each run (none on the CPU)."""
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        FlowGenerator)
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(**SMALL_VMAE)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(0))
    raft_cpu = weights.init_raft(RAFT(iters=2, device='cpu'),
                                 torch.Generator().manual_seed(1))
    rng = np.random.RandomState(6)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    n, n0 = model.num_patches, model.num_patches_per_frame
    active = np.ones((1, n, 4), dtype=bool)
    active[:, :n0] = False
    for i in range(4):
        active[0, n0 + rng.choice(n0, 2, replace=False), i] = False
    path = ('flash_attention', 'flash_attention_prefix', 'window_lookup')
    expect_gpu = {'fast': path, 'exact': ('flash_attention', 'window_lookup')}
    for engine in ('fast', 'exact'):
        outs = {}
        for dev in ('cpu', 'cuda'):
            raft = raft_cpu
            if dev == 'cuda':
                raft = RAFT(iters=2, device='cuda')
                raft.load_state_dict(raft_cpu.state_dict(), strict=True)
            gen = fixed_draws(torch, FlowGenerator(
                predictor=model, params=sd, flow_model=raft, raft_iters=2,
                imagenet_normalize_inputs=True, engine=engine, device=dev), 7)
            port.kernels.reset_launches()
            fl, act, _ = gen.sample_counterfactual_motion_map(
                x, num_samples=4, sample_batch_size=2, do_filter=False)
            y, f = gen.predict_counterfactual_videos_and_flows(
                x, active, num_samples=4, sample_batch_size=4)
            outs[dev] = ([v.cpu() for v in (fl, act, y, f)],
                         engine_launches(port))
        (c, lc), (g, lg) = outs['cpu'], outs['cuda']
        r = dict(case=f'generator {engine}', masks_equal=bool(
            torch.equal(c[1], g[1])), video_err=max_err(c[2], g[2]),
            flow_err=max(max_err(c[0], g[0]), max_err(c[3], g[3])),
            launches_cpu=lc, launches_gpu=lg, tol_video=1e-4, tol_flow=1e-3)
        rec['phase4'].append(r)
        log('4 small generator', json.dumps(r))
        used = expect_gpu[engine]
        if not (r['masks_equal'] and r['video_err'] <= 1e-4
                and r['flow_err'] <= 1e-3 and not any(lc.values())
                and all(lg[k] for k in used)
                and not any(v for k, v in lg.items() if k not in used)):
            raise AssertionError(f'small generator card vs CPU: {r}')


def small_raft(torch, port, rec):
    """RAFT(small=True) (the radius-3 lookup) and the keypoint head
    RAFT(output_dim=1) at 64x64, 2 iterations, f32 (TF32 off), on the card
    and on the CPU from the same weights: flows within 1e-3 px, the
    keypoint map within 1e-4, and the lookup's launches (one per iteration,
    at radius 3 for the small model). Returns the small RAFT's launches."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(12)
    video = torch.from_numpy(rng.rand(3, 2, 3, 64, 64).astype(np.float32))
    radii = []
    real = traft.lookup_pyramid

    def spy(pyramid, coords, radius, *a):
        radii.append(radius)
        return real(pyramid, coords, radius, *a)

    traft.lookup_pyramid = spy
    launches = {}
    try:
        for name, kw, fn, tol in (
                ('small', dict(small=True),
                 lambda m, v: traft.apply_raft_shared0(m, v), 1e-3),
                ('keypoints', dict(output_dim=1),
                 lambda m, v: traft.RaftKeypointPredictor(m)(v), 1e-4)):
            cpu = weights.init_raft(traft.RAFT(iters=2, device='cpu', **kw),
                                    torch.Generator().manual_seed(1))
            gpu = traft.RAFT(iters=2, device='cuda', **kw)
            gpu.load_state_dict(cpu.state_dict(), strict=True)
            ref = fn(cpu, video)
            radii.clear()
            port.kernels.reset_launches()
            out = fn(gpu, video.cuda())
            torch.cuda.synchronize()
            launches[name] = dict(port.kernels.LAUNCHES)
            want = dict({k: 0 for k in launches[name]}, window_lookup=2)
            r = dict(case=f'raft {name} 64x64, 2 iterations',
                     shape=list(out.shape),
                     max_abs_err=max_err(out.cpu(), ref),
                     max_abs=float(ref.abs().max()), tol=tol,
                     radii=list(radii), launches_gpu=launches[name])
            rec['phase4'].append(r)
            log('4 small raft', json.dumps(r))
            if not (r['max_abs_err'] <= tol and launches[name] == want
                    and radii == [3 if name == 'small' else 4] * 2):
                raise AssertionError(f'raft {name} card vs CPU: {r}')
    finally:
        traft.lookup_pyramid = real
    return launches['small']


def small_movability(torch, port, rec):
    """MovabilityPredictor at the small configuration (the tests' VMAE,
    RAFT-2 as the flow probe and a RAFT-2 keypoint predictor, num_iters=1,
    S = 4 per iteration in chunks of 2), f32, on the card and on the CPU
    from the same weights and draws: the movability maps and the active and
    passive patches of every iteration agree; on the card K1 (the prefix
    once), K2 per chunk and the lookup per RAFT iteration ran."""
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.pipelines.movability import (
        MovabilityPredictor)
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(**SMALL_VMAE)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(0))
    nets_cpu = [weights.init_raft(traft.RAFT(iters=2, device='cpu', **kw),
                                  torch.Generator().manual_seed(i + 1))
                for i, kw in enumerate((dict(), dict(output_dim=1)))]
    x = np.random.RandomState(13).rand(1, 3, 32, 32).astype(np.float32)
    outs = {}
    for dev in ('cpu', 'cuda'):
        nets = nets_cpu
        if dev == 'cuda':
            nets = []
            for m, kw in zip(nets_cpu, (dict(), dict(output_dim=1))):
                g = traft.RAFT(iters=2, device=dev, **kw)
                g.load_state_dict(m.state_dict(), strict=True)
                nets.append(g)
        gen = fixed_draws(torch, MovabilityPredictor(
            predictor=model, params=sd, flow_model=nets[0], raft_iters=2,
            keypoint_predictor=traft.RaftKeypointPredictor(nets[1]),
            imagenet_normalize_inputs=True, num_initial_samples=4,
            num_samples_per_iteration=4, sample_batch_size=2, num_iters=1,
            device=dev), 8)
        port.kernels.reset_launches()
        out = gen(x, do_filter=False)
        outs[dev] = (out.cpu(), [m.cpu() for m in gen.movability_maps],
                     [a.cpu() for a in gen.active_patches_per_iter],
                     [p.cpu() for p in gen.passive_patches_per_iter],
                     engine_launches(port))
    (c, cm, ca, cp, lc), (g, gm, ga, gp, lg) = outs['cpu'], outs['cuda']
    depth = model.encoder_depth + model.decoder_depth
    # two motion maps of 2 chunks each, every chunk a RAFT-2; the keypoint
    # RAFT-2 once
    want = dict({k: 0 for k in lg}, flash_attention=depth,
                **suffix_k2(model.encoder_depth, model.decoder_depth, 4),
                window_lookup=4 * 2 + 2)
    r = dict(case='movability small, num_iters 1, S 4',
             masks_equal=all(torch.equal(a, b) for a, b in zip(ca + cp,
                                                                ga + gp)),
             map_err=max(max_err(a, b) for a, b in zip(cm, gm)),
             map_max=float(c.max()), launches_cpu=lc, launches_gpu=lg,
             expected_gpu=want, tol_map=1e-3)
    rec['phase4'].append(r)
    log('4 small movability', json.dumps(r))
    if not (r['masks_equal'] and r['map_err'] <= 1e-3
            and not any(lc.values()) and lg == want):
        raise AssertionError(f'small movability card vs CPU: {r}')


def small_imu_models(torch, dev):
    """The small IMU-conditioned predictor and flow2imu (64 px, 8x8
    patches, 2 layers; every head dim 16, the smallest the kernels take),
    seeded weights from the CPU: (predictor, flow2imu) modules with their
    state dicts loaded."""
    from counterfactualworldmodels_tpu_torch.models import conjoined as C
    from counterfactualworldmodels_tpu_torch.utils import weights
    ctx = dict(is_imu=True, in_chans=6, sequence_length=48, imu_tubelet=8,
               encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
               decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=2,
               decoder_num_classes=48, mlp_ratio=2.0)
    main = dict(img_size=(64, 64), patch_size=(8, 8), encoder_embed_dim=64,
                encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
                decoder_depth=2, decoder_num_heads=2, mlp_ratio=2.0)
    pairs = dict(conjoin_encoder_layers=((0, 0), (-1, -1)),
                 conjoin_decoder_layers=((0, 0), (1, 1)))
    specs = (
        (C.StreamSpec(in_chans=3, num_frames=2, padded=True,
                      max_padding_tokens=8, **main),
         C.StreamSpec(concat_dummy_token=False, padded=True,
                      max_padding_tokens=6, **ctx)),
        (C.StreamSpec(in_chans=7, num_frames=1, decoder_num_classes=448,
                      **main),
         C.StreamSpec(concat_dummy_token=True, **ctx)))
    out = []
    for i, (m, c) in enumerate(specs):
        cpu = C.ConjoinedVMAE(main=m, context=c, device='cpu', **pairs)
        sd = weights.init_conjoined_state_dict(
            cpu, torch.Generator().manual_seed(30 + i))
        mod = C.ConjoinedVMAE(main=m, context=c, device=dev, **pairs)
        mod.load_state_dict(sd, strict=True)
        out.append((mod, {k: v.to(dev) for k, v in sd.items()}))
    return out


def imu_launches(imu, f2i, raft_iters, maps, chunks, prefixes,
                 exact_chunks=0, packed=False):
    """The launches the IMU-conditioned path's code gives: per motion map
    flow2imu's exact forward (K1 in every block of both streams; its
    FramePairFlow runs RAFT forward and backward); per fast chunk the
    suffix (K2 in every main encoder and decoder block, suffix_k2) and the
    RAFT probe; per exact chunk the exact predictor (K1 in every block) and
    the probe; per LRU miss the prefix (K1 in every main block)."""
    def blocks(m):
        return (m.main.encoder_depth + m.main.decoder_depth
                + m.context.encoder_depth + m.context.decoder_depth)
    return dict(
        flash_attention=(maps * blocks(f2i) + exact_chunks * blocks(imu)
                         + prefixes * (imu.main.encoder_depth
                                       + imu.main.decoder_depth)),
        **suffix_k2(imu.main.encoder_depth, imu.main.decoder_depth, chunks,
                    packed),
        window_lookup=raft_iters * (2 * maps + chunks + exact_chunks))


def small_imu(torch, port, rec):
    """The IMU-conditioned pipeline at the small configuration, f32 (TF32
    off), on the card and on the CPU from the same weights and draws:
    ImuConditionedFlowGenerator's counterfactuals with the static-scene
    IMU on both engines, and ImuConditionedMovabilityPredictor (num_iters
    1, S = 2); videos, flows and maps within 1e-3, patches equal, the
    launch counts the code gives on the card and none on the CPU."""
    from counterfactualworldmodels_tpu_torch.models.conjoined import (
        ConjoinedPredictorWrapper)
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.pipelines.imu import (
        ImuConditionedFlowGenerator)
    from counterfactualworldmodels_tpu_torch.pipelines.movability import (
        ImuConditionedMovabilityPredictor)
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    raft_cpu = weights.init_raft(traft.RAFT(iters=2, device='cpu'),
                                 torch.Generator().manual_seed(31))
    rng = np.random.RandomState(14)
    x = rng.rand(1, 3, 64, 64).astype(np.float32)
    n0 = 64
    active = np.ones((1, 2 * n0, 4), dtype=bool)
    active[:, :n0] = False
    for i in range(4):
        active[0, n0 + rng.choice(n0, 2, replace=False), i] = False
    mov_kw = dict(initialize_from_keypoints=False, num_initial_samples=2,
                  num_samples_per_iteration=2, sample_batch_size=2,
                  num_iters=1)
    runs = {}
    for dev in ('cpu', 'cuda'):
        (imu, imu_sd), (f2i, f2i_sd) = small_imu_models(torch, dev)
        raft = raft_cpu
        if dev == 'cuda':
            raft = traft.RAFT(iters=2, device=dev)
            raft.load_state_dict(raft_cpu.state_dict(), strict=True)
        common = dict(
            predictor=ConjoinedPredictorWrapper(
                imu, params=imu_sd, main_input='rgb01', context_input='imu'),
            head_motion_predictor=ConjoinedPredictorWrapper(
                f2i, params=f2i_sd, main_input='flowback_rgb01',
                main_input_kwargs={'iters': 2, 'flow_model': raft},
                context_input='imu'),
            flow_model=raft, raft_iters=2, imagenet_normalize_inputs=True,
            device=dev)
        out = {}
        for engine in ('fast', 'exact'):
            gen = fixed_draws(torch, ImuConditionedFlowGenerator(
                engine=engine, **common), 9)
            port.kernels.reset_launches()
            y, f = gen.predict_counterfactual_videos_and_flows(
                x, active, num_samples=4, sample_batch_size=2)
            out[engine] = ([y.cpu(), f.cpu()], engine_launches(port))
        gen = fixed_draws(torch, ImuConditionedMovabilityPredictor(
            engine='fast', **common, **mov_kw), 10)
        port.kernels.reset_launches()
        m = gen(x, do_filter=False)
        out['movability'] = (
            [m.cpu(), *[v.cpu() for v in gen.movability_maps],
             *[v.cpu() for v in gen.active_patches_per_iter],
             *[v.cpu() for v in gen.passive_patches_per_iter]],
            engine_launches(port))
        runs[dev] = out
    want = {
        'fast': imu_launches(imu, f2i, 2, 1, 2, 1),
        'exact': imu_launches(imu, f2i, 2, 1, 0, 0, exact_chunks=2),
        'movability': imu_launches(imu, f2i, 2, 2, 2, 1)}
    failures = []
    for case, (cvals, lc) in runs['cpu'].items():
        gvals, lg = runs['cuda'][case]
        floats = [(a, b) for a, b in zip(cvals, gvals)
                  if a.dtype != torch.bool]
        bools = [(a, b) for a, b in zip(cvals, gvals)
                 if a.dtype == torch.bool]
        expect = dict({k: 0 for k in lg}, **want[case])
        r = dict(case=f'imu small {case}', max_err=max(
            max_err(a, b) for a, b in floats),
            masks_equal=all(torch.equal(a, b) for a, b in bools),
            launches_cpu=lc, launches_gpu=lg, expected_gpu=expect, tol=1e-3)
        rec['phase4'].append(r)
        log('4 small imu', json.dumps(r))
        if not (r['max_err'] <= 1e-3 and r['masks_equal']
                and not any(lc.values()) and lg == expect):
            failures.append(str(r))
    if failures:
        raise AssertionError('; '.join(failures))


def timed_runs(torch, port, fn, check, reps=4):
    """fn() reps times (the first a warm-up), each from launch counts of 0
    and ending in a synchronize; check(i, launches, out) after each.
    Returns (median ms of the timed runs, their ms)."""
    times = []
    for i in range(reps):
        port.kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(i, engine_launches(port), out)
        if i:
            times.append(ms)
    return float(np.median(times)), times


def generator_phase(torch, port, rec, smi, ctx):
    """FlowGenerator at full width through the calls a user makes, on
    phase 5's weights, at the default rung: (a) a cold scene's motion map,
    (b) the same scene again, (c) a per-click predict on the warm scene,
    (d) the exact engine on 4 prompts, (e) the multi-scene dispatch over 4
    scenes' stacked prefix caches. Each with its launch counts and LRU
    hits, timed (median of 3 after a warm-up) before any profiler use; (a)
    held against the direct dispatch on the same prompts and draws."""
    import dataclasses
    from counterfactualworldmodels_tpu_torch.models import fast_vmae
    from counterfactualworldmodels_tpu_torch.pipelines import segmentation
    dev = torch.device('cuda')
    cfg = dataclasses.replace(ctx['model'], dtype=torch.bfloat16)
    n, n0 = cfg.num_patches, cfg.num_patches_per_frame
    n1 = n - n0
    raft, sd = ctx['raft'], ctx['sd']
    depth = cfg.encoder_depth + cfg.decoder_depth
    zeros = {name: 0 for name in engine_launches(port)}
    t0 = time.perf_counter()
    gen = segmentation.FlowGenerator(
        predictor=cfg, params=sd, flow_model=raft, raft_iters=24,
        imagenet_normalize_inputs=True, seed=0, engine='fast', device=dev)
    rng = np.random.RandomState(11)
    scenes = [torch.from_numpy(rng.rand(1, 3, 224, 224).astype(np.float32))
              .to(dev) for _ in range(4)]
    out = {'config': 'large_4x4patch_2frames_1tube bf16 + RAFT-24 bf16',
           'rung': list(gen._pool_config(224, 224)), 'card': smi}
    failures = []

    def expect(name, want, got, extra=True):
        if got != dict(zeros, **want) or not extra:
            failures.append(f'{name}: launches {got}, want {want}')

    # K2 of a suffix pass over a shared prefix: 24 encoder blocks (packed)
    # and 12 decoder blocks
    k2 = suffix_k2(cfg.encoder_depth, cfg.decoder_depth, packed=True)
    # (a) a cold scene per run: 36 K1 (the prefix), 36 K2, 24 lookups, one
    # LRU miss. The warm-up run is held against the direct dispatch.
    seen = {}
    real_chunk = gen._counterfactual_chunk

    def chunk_spy(*args):
        y, fl, m = real_chunk(*args)
        seen.update(args=args, y=y, fl=fl, m=m)
        return y, fl, m

    def run_a(i):
        if i == 0:
            gen._counterfactual_chunk = chunk_spy
        misses = gen._prefix_lru.misses if gen._prefix_lru else 0
        res = gen.sample_counterfactual_motion_map(
            scenes[i], num_active_patches=1, num_samples=S_FULL,
            sample_batch_size=S_FULL)
        if i == 0:
            del gen._counterfactual_chunk
        return res, gen._prefix_lru.misses - misses

    def check_a(i, launches, res):
        (flows, act, pas), new_misses = res
        expect('(a)', dict(flash_attention=depth, **k2,
                           window_lookup=24), launches,
               new_misses == 1 and tuple(flows.shape) == (1, 2, 224, 224,
                                                          S_FULL)
               and bool(torch.isfinite(flows).all()))

    out['a_cold_scene'] = ms_a = timed_runs(torch, port, run_a, check_a)
    x, passive, active, shifts, noise, n_vis, iters, _ = seen['args']
    pad = fast_vmae.sfx_bucket(n_vis - n0, n1)

    def direct(cache=None):
        return segmentation.counterfactual_videos_and_flows_fast(
            cfg, ctx['fp'], raft, x, passive, active, shifts, noise, pad,
            True, 24, True, cache, *ctx['default'], n_vis=n_vis)

    y_d, f_d, m_d = direct()
    agree = dict(masks_bitwise=bool(torch.equal(m_d, seen['m'])),
                 video_max_abs_diff=max_err(y_d, seen['y']),
                 flow_max_abs_diff=max_err(f_d, seen['fl']),
                 flow_max_abs=float(f_d.float().abs().max()),
                 video_tol=REL_BF16 * float(y_d.float().abs().max()))
    out['a_vs_direct'] = agree
    log('5b generator', 'a vs direct ' + json.dumps(agree))
    if not (agree['masks_bitwise']
            and agree['video_max_abs_diff'] <= agree['video_tol']):
        failures.append(f'(a) against the direct dispatch: {agree}')
    cache0, _ = gen._prefix_lru.get(scenes[0][0:1])
    out['direct_cold_ms'] = timed_runs(torch, port, lambda i: direct(),
                                       lambda *a: None)[0]
    out['direct_warm_ms'] = timed_runs(torch, port, lambda i: direct(cache0),
                                       lambda *a: None)[0]
    del y_d, f_d, m_d, seen

    # (b) the same scene again: the LRU hits, no K1
    def run_b(i):
        hits = gen._prefix_lru.hits
        res = gen.sample_counterfactual_motion_map(
            scenes[3], num_active_patches=1, num_samples=S_FULL,
            sample_batch_size=S_FULL)
        return res, gen._prefix_lru.hits - hits

    def check_b(i, launches, res):
        expect('(b)', dict(k2, window_lookup=24), launches, res[1] == 1)

    out['b_warm_scene'] = timed_runs(torch, port, run_b, check_b)

    # (c) a per-click predict on the warm scene: the suffix pass only
    x2 = torch.cat([scenes[3][:, None],
                    torch.from_numpy(rng.rand(1, 1, 3, 224, 224).astype(
                        np.float32)).to(dev)], 1)
    mask = np.ones((1, n), dtype=bool)
    mask[0, :n0] = False
    mask[0, n0 + rng.choice(n1, 33, replace=False)] = False
    mask = torch.from_numpy(mask).to(dev)

    def run_c(i):
        hits = gen._prefix_lru.hits
        return gen.predict(x2, mask, frame=None), gen._prefix_lru.hits - hits

    def check_c(i, launches, res):
        vid, hit = res
        expect('(c)', k2, launches,
               hit == 1 and tuple(vid.shape) == (1, 2, 3, 224, 224)
               and bool(torch.isfinite(vid).all()))

    out['c_click_predict'] = timed_runs(torch, port, run_c, check_c)

    # (d) the exact engine on 4 prompts: apply_vmae (K1 in every block)
    exact = segmentation.FlowGenerator(
        predictor=cfg, params=sd, flow_model=raft, raft_iters=24,
        imagenet_normalize_inputs=True, seed=0, engine='exact', device=dev)
    act4 = active[..., :4]

    def run_d(i):
        return exact.predict_counterfactual_videos_and_flows(
            scenes[3], act4, num_samples=4, sample_batch_size=4)

    def check_d(i, launches, res):
        y, f = res
        expect('(d)', dict(flash_attention=depth, window_lookup=24),
               launches, tuple(f.shape) == (4, 1, 2, 224, 224)
               and bool(torch.isfinite(f).all()) and exact._prefix_lru is None)

    out['d_exact_engine'] = timed_runs(torch, port, run_d, check_d)
    del exact

    # (e) one prompt on each of 4 scenes, their cached prefixes stacked:
    # K2 reads per-sample prefix panels (s0 = S)
    hits = gen._prefix_lru.hits
    stacked = fast_vmae.stack_prefix_caches(
        [gen._prefix_lru.get(sc[0:1])[0] for sc in scenes])
    if gen._prefix_lru.hits - hits != 4:
        failures.append('(e): the 4 scenes are not all in the LRU')
    xs = torch.cat([sc[:, None].expand(1, 2, 3, 224, 224) for sc in scenes])
    pas_e = torch.ones(4, n, dtype=torch.bool, device=dev)
    pas_e[:, :n0] = False
    act_e = pas_e.clone()
    act_e[torch.arange(4, device=dev), n0 + torch.from_numpy(
        rng.choice(n1, 4)).to(dev)] = False
    sh_e = torch.from_numpy(rng.randint(-3, 4, (4, 2))).to(dev)
    noise_e = torch.rand(4, n1, generator=torch.Generator(dev).manual_seed(5),
                         device=dev) * 0.999
    s0_seen = []
    real_k2 = fast_vmae.flash_attention_prefix

    def k2_spy(q, k0, *a, **k):
        s0_seen.append(k0.shape[0])
        return real_k2(q, k0, *a, **k)

    def run_e(i):
        if i == 0:
            fast_vmae.flash_attention_prefix = k2_spy
        try:
            return segmentation.counterfactual_videos_and_flows_fast_multi(
                cfg, gen._fast_params, raft, xs, pas_e, act_e, sh_e,
                fast_vmae.sfx_bucket(1, n1), True, 24, True, noise_e,
                stacked, n_vis=n0 + 1, device=dev)
        finally:
            fast_vmae.flash_attention_prefix = real_k2

    def check_e(i, launches, res):
        y, f, m = res
        expect('(e)', dict(suffix_k2(cfg.encoder_depth, cfg.decoder_depth),
                           window_lookup=24), launches,
               tuple(f.shape) == (4, 1, 2, 224, 224)
               and bool(torch.isfinite(f).all()))

    out['e_multi_scene'] = timed_runs(torch, port, run_e, check_e)
    out['e_k2_prefix_batch'] = s0_seen
    if s0_seen != [4] * (cfg.encoder_depth + cfg.decoder_depth):
        failures.append(f'(e): K2 prefix batch dims {s0_seen}')

    # the LRU key: sha1 over frame 0 copied from the card
    key_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fast_vmae.HashLru._key(scenes[0][0:1])
        key_ms.append((time.perf_counter() - t1) * 1e3)
    out['lru_key_ms'] = float(np.median(key_ms))

    # (a) split within each call, on 3 more cold scenes (last: they evict
    # the scenes above from the LRU): the sampler, the chunk (the LRU
    # lookup with the prefix passes on a miss, then the dispatch) and the
    # filter, each between synchronizations; the rest is the generator's
    # own host work. Two runs' medians differ by more than the overhead,
    # one call's split does not.
    split = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + (time.perf_counter() - t1) * 1e3
            return res
        return wrapper

    filt = gen.flow_sample_filter
    gen.sample_patches_from_energy = timed('sampler',
                                           gen.sample_patches_from_energy)
    gen._counterfactual_chunk = timed('chunk', gen._counterfactual_chunk)
    gen.flow_sample_filter = timed('filter', filt)
    splits = []
    try:
        for _ in range(3):
            scene = torch.from_numpy(rng.rand(1, 3, 224, 224).astype(
                np.float32)).to(dev)
            split.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gen.sample_counterfactual_motion_map(
                scene, num_active_patches=1, num_samples=S_FULL,
                sample_batch_size=S_FULL)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t1) * 1e3
            splits.append(dict(split, total=total,
                               rest=total - sum(split.values())))
    finally:
        del gen.sample_patches_from_energy, gen._counterfactual_chunk
        gen.flow_sample_filter = filt
    out['a_split_ms'] = splits
    out['lru'] = dict(hits=gen._prefix_lru.hits, misses=gen._prefix_lru.misses)
    out['overhead_ms'] = dict(
        a_over_direct_cold=ms_a[0] - out['direct_cold_ms'],
        b_over_direct_warm=out['b_warm_scene'][0] - out['direct_warm_ms'],
        a_over_phase5_default=ms_a[0] - ctx['default_ms'],
        a_outside_chunk_median=float(np.median(
            [s['total'] - s['chunk'] for s in splits])))
    out['seconds'] = time.perf_counter() - t0
    rec['phase5b'] = out
    log('5b generator', json.dumps(out))
    log('5b generator', 'overhead over the direct dispatch (ms): '
        + json.dumps(out['overhead_ms']))
    if failures:
        raise AssertionError('; '.join(failures))
    return out


def movability_phase(torch, port, rec, smi, ctx):
    """MovabilityPredictor at full width through its entry point,
    ``MovabilityPredictor(...)(x)``, as the demo calls it: phase 5's VMAE
    (bf16, the default rung) and RAFT-24, a seeded RAFT-24 keypoint
    predictor (``output_dim=1``, bf16) and the library defaults (keypoint
    initialisation, 16 initial samples, 2 iterations of 16, chunks of 4).
    One warm-up call, then 3 timed calls, each on a new seeded image (a
    cold prefix LRU); the keypoint predictor's time within each call,
    synchronized around it; the launches per call held to the counts the
    code gives; the outputs checked; flow_to_rgb on the card against the
    CPU; one more cold call split into its parts; one timed call without
    the flow-sample filter, whose later iterations sample from a real
    map."""
    import dataclasses
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.ops.flow_viz import flow_to_rgb
    from counterfactualworldmodels_tpu_torch.pipelines.movability import (
        MovabilityPredictor)
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    cfg = dataclasses.replace(ctx['model'], dtype=torch.bfloat16)
    t0 = time.perf_counter()
    kp_raft = weights.init_raft(
        traft.RAFT(iters=24, output_dim=1, dtype=torch.bfloat16, device=dev),
        torch.Generator(device=dev).manual_seed(7))
    gen = MovabilityPredictor(
        predictor=cfg, params=ctx['sd'], flow_model=ctx['raft'],
        raft_iters=24, keypoint_predictor=traft.RaftKeypointPredictor(kp_raft),
        imagenet_normalize_inputs=True, seed=0, engine='fast', device=dev)
    settings = dict(initialize_from_keypoints=gen.initialize_from_keypoints,
                    num_initial_samples=gen.num_initial_samples,
                    num_samples_per_iteration=gen.num_samples_per_iteration,
                    num_iters=gen.num_iters,
                    sample_batch_size=gen.sample_batch_size)
    # the counts the code gives: the keypoint RAFT once (24 lookups); three
    # motion maps of 16 samples in chunks of 4, each chunk a suffix pass (K2
    # in every encoder block, packed, and every decoder block) and a
    # RAFT-24 (24 lookups); the scene's prefix (K1 in every block) on the
    # first chunk only, an LRU miss
    chunks = (1 + gen.num_iters) * (gen.num_initial_samples
                                    // gen.sample_batch_size)
    want = dict({k: 0 for k in engine_launches(port)},
                flash_attention=cfg.encoder_depth + cfg.decoder_depth,
                **suffix_k2(cfg.encoder_depth, cfg.decoder_depth, chunks,
                            packed=True),
                window_lookup=24 * (chunks + 1))
    kp_ms = []
    real_kp = gen.keypoint_predictor

    def timed_kp(x):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real_kp(x)
        torch.cuda.synchronize()
        kp_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    gen.keypoint_predictor = timed_kp
    rng = np.random.RandomState(21)
    failures, checks = [], []

    def run(i):
        x = torch.from_numpy(rng.rand(1, 3, 224, 224).astype(np.float32))
        misses = gen._prefix_lru.misses if gen._prefix_lru else 0
        out = gen(x.to(dev))
        return out, gen._prefix_lru.misses - misses

    def check(i, launches, res):
        out, new_misses = res
        kd = gen.keypoints_distribution
        ok = dict(
            launches=launches == want, lru_misses=new_misses,
            shape=tuple(out.shape) == (1, 1, 224, 224),
            finite=bool(torch.isfinite(out).all()) and all(
                bool(torch.isfinite(f).all())
                for f in gen.flow_samples_per_iter),
            in_unit=bool((out >= 0).all() and (out <= 1).all()),
            maps=len(gen.flow_samples_per_iter) == 1 + gen.num_iters,
            keypoints=(tuple(kd.shape) == (1, 1, 224, 224)
                       and float(kd.max()) == 1.0 and float(kd.min()) == 0.0),
            map_max=float(out.max()),
            flow_abs_max=max(float(f.abs().max())
                             for f in gen.flow_samples_per_iter))
        checks.append(ok)
        if not (ok['launches'] and new_misses == 1 and ok['shape']
                and ok['finite'] and ok['in_unit'] and ok['maps']
                and ok['keypoints']):
            failures.append(f'call {i}: {ok}, launches {launches}')

    ms, runs = timed_runs(torch, port, run, check)
    gen.keypoint_predictor = real_kp

    # one more cold call, split: each part between synchronizations (the
    # keypoint predictor, the samplers, the 12 chunks, the filters); the
    # rest is the generator's own host work
    split = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            split[name] = (split.get(name, 0.0)
                           + (time.perf_counter() - t1) * 1e3)
            return res
        return wrapper

    filt = gen.flow_sample_filter
    gen.keypoint_predictor = timed('keypoints', real_kp)
    gen.sample_patches_from_energy = timed('sampler',
                                           gen.sample_patches_from_energy)
    gen._counterfactual_chunk = timed('chunks', gen._counterfactual_chunk)
    gen.flow_sample_filter = timed('filter', filt)
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run(4)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t1) * 1e3
    finally:
        del gen.sample_patches_from_energy, gen._counterfactual_chunk
        gen.flow_sample_filter = filt
        gen.keypoint_predictor = real_kp
    split = dict(split, total=total, rest=total - sum(split.values()))

    flows = gen.flow_samples_per_iter[0][..., 0]
    rgb = flow_to_rgb(flows, max_speed=4.0)
    rgb_err = max_err(rgb.cpu(), flow_to_rgb(flows.cpu(), max_speed=4.0))

    # the filter rejects every sample of these random weights, so the maps
    # above are zeros and iterations 1-2 sample uniformly; unfiltered, the
    # same path gives a real map, from which iterations 1-2 sample
    x_u = torch.from_numpy(rng.rand(1, 3, 224, 224).astype(np.float32)).to(dev)
    port.kernels.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m_u = gen(x_u, do_filter=False)
    torch.cuda.synchronize()
    unfiltered = dict(
        ms=(time.perf_counter() - t1) * 1e3,
        launches=engine_launches(port), map_max=float(m_u.max()),
        map_min=float(m_u.min()), finite=bool(torch.isfinite(m_u).all()),
        flow_abs_max=max(float(f.abs().max())
                         for f in gen.flow_samples_per_iter))
    if not (unfiltered['launches'] == want and unfiltered['finite']
            and unfiltered['flow_abs_max'] > 0
            and abs(unfiltered['map_max'] - 1) < 1e-6
            and unfiltered['map_min'] == 0.0):
        failures.append(f'unfiltered call: {unfiltered}')
    out = dict(config='large_4x4patch_2frames_1tube bf16 + RAFT-24 bf16 + '
                      'keypoint RAFT-24 bf16', rung=list(gen._pool_config(
                          224, 224)), settings=settings,
               ms_per_call=ms, ms_runs=runs, keypoint_ms=kp_ms[1:],
               keypoint_ms_median=float(np.median(kp_ms[1:])),
               launches_per_call=want, checks=checks, split_ms=split,
               unfiltered=unfiltered,
               flow_to_rgb_err=rgb_err, tol_flow_to_rgb=1e-6,
               seconds=time.perf_counter() - t0, card=smi)
    rec['phase5c'] = out
    log('5c movability', json.dumps(out))
    if rgb_err > 1e-6:
        failures.append(f'flow_to_rgb card vs CPU: {rgb_err}')
    if failures:
        raise AssertionError('; '.join(failures))
    return out


def imu_phase(torch, port, rec, smi, ctx):
    """The IMU-conditioned path at full width through its entry points:
    the IMU-conditioned ViT-B 4x4 predictor
    (``imu400_base_4x4patch_2frames_1tube``) and flow2imu
    (``imu400_8x8patch_2frames_1tube_flowbackrgb01``) in bf16 from seeded
    weights, with phase 5's RAFT-24 (bf16) as both flow2imu's flow
    preprocessor and the probe. ImuConditionedFlowGenerator: (a) a cold
    motion map (a new image: flow2imu on the static scene, the prefix, one
    chunk of S = 16), (b) the same scene again (an LRU hit), (c) the exact
    engine on 4 prompts; ImuConditionedMovabilityPredictor(...)(x) at the
    library defaults with a RAFT-24 keypoint predictor (d), a new image
    each call, and one unfiltered call. Each timed as the median of 3 after
    a warm-up, launches per call asserted, peak memory."""
    from counterfactualworldmodels_tpu_torch.models import conjoined as C
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.pipelines.imu import (
        ImuConditionedFlowGenerator)
    from counterfactualworldmodels_tpu_torch.pipelines.movability import (
        ImuConditionedMovabilityPredictor)
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(11)
    imu = C.imu400_base_4x4patch_2frames_1tube(dtype=torch.bfloat16,
                                               device=dev)
    f2i = C.imu400_8x8patch_2frames_1tube_flowbackrgb01(dtype=torch.bfloat16,
                                                        device=dev)
    raft = ctx['raft']
    common = dict(
        predictor=C.ConjoinedPredictorWrapper(
            imu, params=weights.init_conjoined_state_dict(imu, g),
            main_input='rgb01', context_input='imu'),
        head_motion_predictor=C.ConjoinedPredictorWrapper(
            f2i, params=weights.init_conjoined_state_dict(f2i, g),
            main_input='flowback_rgb01',
            main_input_kwargs={'iters': 24, 'flow_model': raft},
            context_input='imu'),
        flow_model=raft, raft_iters=24, imagenet_normalize_inputs=True,
        seed=0, device=dev)
    gen = ImuConditionedFlowGenerator(engine='fast', **common)
    # the models, for phase 5e's IMU service
    ctx['imu'] = dict(common, models=(imu, f2i))
    torch.cuda.synchronize()
    log('5d imu', f'weights ready in {time.perf_counter() - t0:.1f}s')
    zero = {k: 0 for k in engine_launches(port)}
    want = dict(
        a=dict(zero, **imu_launches(imu, f2i, 24, 1, 1, 1, packed=True)),
        b=dict(zero, **imu_launches(imu, f2i, 24, 1, 1, 0, packed=True)),
        c=dict(zero, **imu_launches(imu, f2i, 24, 1, 0, 0, exact_chunks=1)))
    rng = np.random.RandomState(41)
    failures, out = [], dict(
        config='imu400_base_4x4patch_2frames_1tube bf16 + '
               'imu400_8x8patch_2frames_1tube_flowbackrgb01 bf16 + '
               'RAFT-24 bf16', card=smi)
    lru = lambda: gen._conj_prefix_lru                         # noqa: E731
    state = {}

    def image():
        return torch.from_numpy(rng.rand(1, 3, 224, 224).astype(
            np.float32)).to(dev)

    def motion_map(x):
        before = (lru().misses, lru().hits) if lru() else (0, 0)
        flows, act, _ = gen.sample_counterfactual_motion_map(
            x, num_samples=S_FULL, sample_batch_size=S_FULL)
        return flows, act, (lru().misses - before[0], lru().hits - before[1])

    def check(case, lru_delta):
        def fn(i, launches, res):
            flows, act, delta = res
            ok = dict(launches=launches == want[case], lru=delta,
                      shape=tuple(flows.shape) == (1, 2, 224, 224, S_FULL),
                      finite=bool(torch.isfinite(flows).all()),
                      imu=tuple(gen._x_context.shape) == (1, 6, 400)
                      and bool(torch.isfinite(gen._x_context).all()))
            state.setdefault(case, []).append(ok)
            if not (ok['launches'] and delta == lru_delta and ok['shape']
                    and ok['finite'] and ok['imu']):
                failures.append(f'({case}) call {i}: {ok}, {launches}')
        return fn

    torch.cuda.reset_peak_memory_stats()
    scenes = []

    def run_a(i):
        scenes.append(image())
        return motion_map(scenes[-1])

    ms, runs = timed_runs(torch, port, run_a, check('a', (1, 0)))
    out['a'] = dict(ms=ms, ms_runs=runs, launches=want['a'],
                    checks=state['a'],
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    ms, runs = timed_runs(torch, port, lambda i: motion_map(scenes[-1]),
                          check('b', (0, 1)))
    out['b'] = dict(ms=ms, ms_runs=runs, launches=want['b'],
                    checks=state['b'])

    # one more cold motion map, split: each part between synchronizations
    # (flow2imu on the static scene, the sampler, the chunk with its
    # prefix pass, the filter); the rest is the generator's own host work
    split = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            split[name] = (split.get(name, 0.0)
                           + (time.perf_counter() - t1) * 1e3)
            return res
        return wrapper

    filt = gen.flow_sample_filter
    gen.predict_imu_from_video = timed('flow2imu', gen.predict_imu_from_video)
    gen.sample_patches_from_energy = timed('sampler',
                                           gen.sample_patches_from_energy)
    gen._counterfactual_chunk = timed('chunk', gen._counterfactual_chunk)
    gen.flow_sample_filter = timed('filter', filt)
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        motion_map(image())
        torch.cuda.synchronize()
        total = (time.perf_counter() - t1) * 1e3
    finally:
        del (gen.predict_imu_from_video, gen.sample_patches_from_energy,
             gen._counterfactual_chunk)
        gen.flow_sample_filter = filt
    out['a_split_ms'] = dict(split, total=total,
                             rest=total - sum(split.values()))

    exact = ImuConditionedFlowGenerator(engine='exact', **common)
    n0 = imu.main.num_patches // 2
    active = np.ones((1, 2 * n0, 4), dtype=bool)
    active[:, :n0] = False
    for i in range(4):
        active[0, n0 + rng.randint(n0), i] = False
    active = torch.from_numpy(active).to(dev)

    def run_c(i):
        y, f = exact.predict_counterfactual_videos_and_flows(
            scenes[-1], active, num_samples=4, sample_batch_size=4)
        return f.reshape(1, 4, 2, 224, 224).movedim(1, -1), y, (0, 0)

    def check_c(i, launches, res):
        f, y, _ = res
        ok = dict(launches=launches == want['c'],
                  shape=tuple(y.shape) == (4, 2, 3, 224, 224),
                  finite=bool(torch.isfinite(f).all()
                              and torch.isfinite(y).all()),
                  lru=exact._conj_prefix_lru is None)
        state.setdefault('c', []).append(ok)
        if not all(ok.values()):
            failures.append(f'(c) call {i}: {ok}, {launches}')

    ms, runs = timed_runs(torch, port, run_c, check_c)
    out['c'] = dict(ms=ms, ms_runs=runs, launches=want['c'],
                    checks=state['c'],
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del exact

    # (d) movability at the library defaults with a RAFT-24 keypoint
    # predictor: the keypoint RAFT once; three motion maps, each flow2imu
    # on the static scene and 4 chunks of 4; the prefix on the first chunk
    # (the IMU of maps 2 and 3 is the same embedding: LRU hits)
    kp_raft = weights.init_raft(
        traft.RAFT(iters=24, output_dim=1, dtype=torch.bfloat16, device=dev),
        torch.Generator(device=dev).manual_seed(12))
    mov = ImuConditionedMovabilityPredictor(
        keypoint_predictor=traft.RaftKeypointPredictor(kp_raft),
        engine='fast', **common)
    maps = 1 + mov.num_iters
    chunks = maps * (mov.num_initial_samples // mov.sample_batch_size)
    want['d'] = dict(zero, **imu_launches(imu, f2i, 24, maps, chunks, 1,
                                          packed=True))
    want['d']['window_lookup'] += 24        # the keypoint RAFT-24

    def run_d(i, **kw):
        misses = mov._conj_prefix_lru.misses if mov._conj_prefix_lru else 0
        m = mov(image(), **kw)
        return m, mov._conj_prefix_lru.misses - misses

    def check_d(i, launches, res):
        m, misses = res
        ok = dict(launches=launches == want['d'], lru_misses=misses,
                  shape=tuple(m.shape) == (1, 1, 224, 224),
                  finite=bool(torch.isfinite(m).all()) and all(
                      bool(torch.isfinite(f).all())
                      for f in mov.flow_samples_per_iter),
                  in_unit=bool((m >= 0).all() and (m <= 1).all()),
                  maps=len(mov.flow_samples_per_iter) == maps)
        state.setdefault('d', []).append(ok)
        if not (ok['launches'] and misses == 1 and ok['shape']
                and ok['finite'] and ok['in_unit'] and ok['maps']):
            failures.append(f'(d) call {i}: {ok}, {launches}')

    ms, runs = timed_runs(torch, port, run_d, check_d)
    port.kernels.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m_u, _ = run_d(4, do_filter=False)
    torch.cuda.synchronize()
    unfiltered = dict(
        ms=(time.perf_counter() - t1) * 1e3,
        launches=engine_launches(port), map_max=float(m_u.max()),
        map_min=float(m_u.min()), finite=bool(torch.isfinite(m_u).all()),
        flow_abs_max=max(float(f.abs().max())
                         for f in mov.flow_samples_per_iter))
    if not (unfiltered['launches'] == want['d'] and unfiltered['finite']
            and unfiltered['flow_abs_max'] > 0):
        failures.append(f'(d) unfiltered call: {unfiltered}')
    settings = {k: getattr(mov, k) for k in (
        'initialize_from_keypoints', 'num_initial_samples',
        'num_samples_per_iteration', 'num_iters', 'sample_batch_size')}
    out['d'] = dict(ms=ms, ms_runs=runs, launches=want['d'],
                    settings=settings,
                    checks=state['d'], unfiltered=unfiltered,
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out['seconds'] = time.perf_counter() - t0
    rec['phase5d'] = out
    log('5d imu', json.dumps(out))
    if failures:
        raise AssertionError('; '.join(failures))
    return out


# ---------------------------------------------------------------------------
# phase 5e: the HTTP server and the interactive interface at full width
# ---------------------------------------------------------------------------

def png_decode(data):
    """A PNG written by the port's server (8-bit grey or RGB, no interlace,
    every row filter 0) as a uint8 array, decoded here with zlib alone:
    the chunks' CRCs checked, the IDAT stream inflated, the filter byte of
    each row checked and dropped."""
    import struct
    import zlib
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError('not a PNG')
    pos, idat, header = 8, b'', None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xffffffff != crc:
            raise ValueError(f'bad CRC in {kind}')
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat += body
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in (0, 2) or interlace:
        raise ValueError(f'unexpected PNG header {header}')
    ch = 3 if colour == 2 else 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    if raw[:, 0].any():
        raise ValueError('a row uses a filter other than 0')
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


class _StubAxes:
    """What the interface draws through (no matplotlib on this machine):
    images, titles and texts recorded."""

    def __init__(self):
        import types
        self.images, self.titles, self.texts = [], [], []
        self.figure = types.SimpleNamespace(canvas=types.SimpleNamespace(
            mpl_connect=lambda name, fn: len(name)))

    def imshow(self, img, **kwargs):
        self.images.append(np.asarray(img).shape)

    def text(self, *args, **kwargs):
        texts = self.texts

        class Text:
            def set_text(self, s):
                texts.append(s)
        return Text()

    def set_title(self, title, **kwargs):
        self.titles.append(title)

    def set_xticks(self, ticks):
        pass

    def set_yticks(self, ticks):
        pass


def serving_phase(torch, port, rec, smi, ctx):
    """The port's HTTP server and interactive interface at full width, on
    phase 5's ViT-L 4x4 + RAFT-24 bf16 weights and phase 5d's IMU models:
    CwmService (engine fast, 5 ms window, 64 samples per dispatch, 8 per
    mixed-scene dispatch) behind a ThreadingHTTPServer after warmup;
    /health, /predict, a cold and a warm /counterfactual of 16 samples, 4
    concurrent same-scene requests in one dispatch, 4 concurrent requests
    on new scenes in one mixed-scene dispatch (K2 with s0 = 4), /stats;
    each route timed over HTTP (median of 3 after a warm-up) and one
    request split into host and device parts; ImuCwmService's
    /counterfactual (cold, warm) and /movability; the interface's click,
    'f', 'b' and 'x' through a stub axes object; the PNG writer against
    the decoder above. Every launch count asserted."""
    import argparse
    import base64
    import dataclasses
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from counterfactualworldmodels_tpu_torch import serve
    from counterfactualworldmodels_tpu_torch.interface import (
        CounterfactualPredictionInterface)
    from counterfactualworldmodels_tpu_torch.pipelines import segmentation
    dev = torch.device('cuda')
    cfg = dataclasses.replace(ctx['model'], dtype=torch.bfloat16)
    raft, sd = ctx['raft'], ctx['sd']
    depth = cfg.encoder_depth + cfg.decoder_depth
    # K2 of one suffix pass over a shared prefix (the encoder's packed) and
    # over stacked prefixes (s0 = S: none packed)
    k2 = suffix_k2(cfg.encoder_depth, cfg.decoder_depth, packed=True)
    k2_stacked = suffix_k2(cfg.encoder_depth, cfg.decoder_depth)
    zero = {k: 0 for k in engine_launches(port)}
    failures = []
    out = {'config': 'large_4x4patch_2frames_1tube bf16 + RAFT-24 bf16; '
                     'IMU: imu400_base_4x4patch_2frames_1tube + '
                     'imu400_8x8patch_2frames_1tube_flowbackrgb01 bf16',
           'card': smi}
    rng = np.random.RandomState(51)

    def image():
        return rng.rand(224, 224, 3).round(3).tolist()

    def expect(name, got, **want):
        if got != dict(zero, **want):
            failures.append(f'{name}: launches {got}, want {want}')

    # the PNG writer against this decoder, bitwise
    for shape in ((224, 224, 3), (224, 224), (7, 13, 3)):
        a = rng.randint(0, 256, shape).astype(np.uint8)
        if not np.array_equal(png_decode(serve.encode_png(a)), a):
            failures.append(f'PNG round trip {shape}')
    out['png_roundtrip_bitwise'] = not failures

    t0 = time.perf_counter()
    gen = segmentation.FlowGenerator(
        predictor=cfg, params=sd, flow_model=raft, raft_iters=24,
        imagenet_normalize_inputs=True, seed=0, engine='fast', device=dev)
    svc = serve.CwmService(gen, 224, engine='fast', batch_window_ms=5.0,
                           max_batch_samples=64, max_scene_batch=8)
    warmed = svc.warmup(buckets=(1, 4, 16), log=None)
    out['warmup'] = dict(seconds=time.perf_counter() - t0,
                         dispatches=[list(w) for w in warmed])
    log('5e serving', f'warmup: {len(warmed)} dispatches in '
                      f'{out["warmup"]["seconds"]:.1f}s (with the weights)')
    servers = []

    def start(service):
        httpd = ThreadingHTTPServer(('127.0.0.1', 0), serve.make_handler(
            service, service.device.type))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers.append((httpd, th))
        return f'http://127.0.0.1:{httpd.server_address[1]}'

    def call(base, path, body=None):
        """(status, JSON, client ms) of one request; body: encoded JSON."""
        req = urllib.request.Request(
            base + path, body,
            {'Content-Type': 'application/json'} if body else {})
        t1 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, payload = r.status, json.loads(r.read())
        return status, payload, (time.perf_counter() - t1) * 1e3

    def counted(fn):
        """fn() from launch counts of 0; (its result, the counts)."""
        port.kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        return res, engine_launches(port)

    def concurrent(base, service, bodies):
        """POST the bodies from threads, each sent once the previous one
        has joined the batcher's open batch (so all share one batch)."""
        res = [None] * len(bodies)
        threads = []
        batcher = service._batcher
        for i, body in enumerate(bodies):
            th = threading.Thread(target=lambda i=i, body=body: res.__setitem__(
                i, call(base, '/counterfactual', body)))
            th.start()
            threads.append(th)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with batcher._lock:
                    n = sum(len(b['entries'])
                            for b in batcher._pending.values())
                if n == i + 1:
                    break
                time.sleep(0.001)
            else:
                raise AssertionError('a request did not reach the batcher')
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError('a request did not return')
        return res

    def check_cf(name, resp, **flags):
        status, payload, _ = resp
        keys = {'simulation', 'flow_rgb', 'segment', 'segment_raw',
                'engine', 'batched_samples'}
        ok = status == 200 and keys <= set(payload)
        if ok:
            seg = np.asarray(payload['segment_raw'])
            ok = (seg.shape == (224, 224) and bool(np.isfinite(seg).all())
                  and all(png_decode(base64.b64decode(payload[k])).shape
                          == (224, 224, 3)
                          for k in ('simulation', 'flow_rgb', 'segment'))
                  and all(payload.get(k) == v for k, v in flags.items()))
        if not ok:
            failures.append(f'{name}: {status} '
                            f'{ {k: payload.get(k) for k in flags} }')

    def stats(base):
        return call(base, '/stats')[1]

    def enc(payload):
        return json.dumps(payload).encode()

    launches = {}
    try:
        base = start(svc)
        status, health, _ = call(base, '/health')
        if (status, health) != (200, {'status': 'ok', 'backend': 'cuda'}):
            failures.append(f'/health: {status} {health}')
        scene = image()
        active = [[20, 30]]
        (resp, l_) = counted(lambda: call(base, '/predict', enc(
            {'image': scene, 'active': active})))
        launches['predict'] = l_
        expect('/predict (cold)', l_, flash_attention=depth, **k2)
        if not (resp[0] == 200 and png_decode(base64.b64decode(
                resp[1]['prediction'])).shape == (224, 224, 3)):
            failures.append('/predict response')
        cf = {'image': scene, 'active': active, 'passive': [[40, 12]],
              'shift': [0, 2], 'num_samples': S_FULL}
        before = stats(base)
        (resp, l_) = counted(lambda: call(base, '/counterfactual', enc(cf)))
        launches['counterfactual_cold'] = l_
        expect('/counterfactual (cold)', l_, flash_attention=depth, **k2,
               window_lookup=24)
        check_cf('/counterfactual (cold)', resp, prefix_cache_hit=False,
                 engine='fast', batched_samples=S_FULL)
        (resp, l_) = counted(lambda: call(base, '/counterfactual', enc(cf)))
        launches['counterfactual_warm'] = l_
        expect('/counterfactual (warm)', l_, **k2, window_lookup=24)
        check_cf('/counterfactual (warm)', resp, prefix_cache_hit=True)
        after = stats(base)
        if (after['prefix_cache']['misses'] - before['prefix_cache']['misses'],
                after['prefix_cache']['hits'] - before['prefix_cache']['hits']
                ) != (1, 1):
            failures.append(f'service LRU: {before} -> {after}')

        # concurrent requests: the window is widened so that four 1.5 MB
        # JSON bodies, parsed one after another under the GIL, join one
        # batch (the ordered sends make the batch deterministic)
        svc._batcher.window_s = 0.5
        same = [enc(dict(cf, num_samples=4, shift=[i - 2, 1]))
                for i in range(4)]
        before = stats(base)
        (res, l_) = counted(lambda: concurrent(base, svc, same))
        launches['same_scene_batch'] = l_
        after = stats(base)
        mb0, mb1 = before['micro_batching'], after['micro_batching']
        expect('4 same-scene requests', l_, **k2, window_lookup=24)
        for r in res:
            check_cf('same-scene batch', r, prefix_cache_hit=True,
                     batched_samples=S_FULL)
        if (mb1['dispatches'] - mb0['dispatches'],
                mb1['requests_batched'] - mb0['requests_batched']) != (1, 4):
            failures.append(f'same-scene batching: {mb0} -> {mb1}')
        new_scenes = [image() for _ in range(4)]
        mixed = [enc({'image': im, 'active': active, 'shift': [1, 1],
                      'num_samples': 1}) for im in new_scenes]
        before = stats(base)
        (res, l_) = counted(lambda: concurrent(base, svc, mixed))
        launches['mixed_scene_batch'] = l_
        after = stats(base)
        mb0, mb1 = before['micro_batching'], after['micro_batching']
        expect('4 mixed-scene requests', l_, flash_attention=4 * depth,
               **k2_stacked, window_lookup=24)
        for r in res:
            check_cf('mixed-scene batch', r, prefix_cache_hit=False,
                     batched_samples=4, scene_batched=4)
        if (mb1['scene_batches'] - mb0['scene_batches'],
                mb1['dispatches'] - mb0['dispatches'],
                after['prefix_cache']['misses']
                - before['prefix_cache']['misses']) != (1, 1, 4):
            failures.append(f'mixed-scene batching: {before} -> {after}')
        out['stats'] = after

        # each route over HTTP, median of 3 after a warm-up (single
        # requests at the 5 ms window, the batches of 4 with the 0.5 s
        # window above; the dispatch is timed inside the server too)
        dispatch_ms = []
        real_dispatch = svc._dispatch_cf_batch

        def timed_dispatch(key, items):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = real_dispatch(key, items)
            torch.cuda.synchronize()
            dispatch_ms.append((time.perf_counter() - t1) * 1e3)
            return r
        svc._batcher.dispatch = timed_dispatch

        def route(fn):
            ms = []
            for i in range(4):
                dispatch_ms.clear()
                t1 = time.perf_counter()
                fn()
                ms.append(((time.perf_counter() - t1) * 1e3,
                           sum(dispatch_ms)))
            runs = ms[1:]
            return dict(ms=float(np.median([r[0] for r in runs])),
                        ms_runs=[r[0] for r in runs],
                        dispatch_ms_runs=[r[1] for r in runs])

        timing = {}
        svc._batcher.window_s = 0.005
        timing['predict'] = route(lambda: call(base, '/predict', enc(
            {'image': image(), 'active': active})))
        timing['counterfactual_cold'] = route(lambda: call(
            base, '/counterfactual', enc(dict(cf, image=image()))))
        warm_body = enc(cf)
        timing['counterfactual_warm'] = route(lambda: call(
            base, '/counterfactual', warm_body))
        svc._batcher.window_s = 0.5
        timing['same_scene_batch_of_4'] = route(
            lambda: concurrent(base, svc, same))
        timing['mixed_scene_batch_of_4'] = route(lambda: concurrent(
            base, svc, [enc({'image': image(), 'active': active,
                             'shift': [1, 1], 'num_samples': 1})
                        for _ in range(4)]))
        svc._batcher.window_s = 0.005
        out['route_ms'] = timing

        # one warm request of 16 samples split: the JSON body's encode and
        # parse (the same body, in this process), the image parse and
        # upload, the dispatch between synchronizations (of it, the engine:
        # prompts, VMAE, RAFT-24), the response's PNGs and the rest (HTTP,
        # the response JSON)
        split = {}
        t1 = time.perf_counter()
        body = enc(cf)
        split['client_json_encode'] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        json.loads(body)
        split['json_parse'] = (time.perf_counter() - t1) * 1e3

        def timed(name, fn, sync=False):
            def wrapper(*a, **k):
                if sync:
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                r = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                split[name] = split.get(name, 0.0) + (
                    time.perf_counter() - t2) * 1e3
                return r
            return wrapper

        svc._parse_cf_request = timed('parse_image', svc._parse_cf_request,
                                      sync=True)
        svc._cf_response = timed('response_pngs', svc._cf_response)
        engine = serve.counterfactual_videos_and_flows_fast
        serve.counterfactual_videos_and_flows_fast = timed('engine', engine,
                                                           sync=True)
        try:
            dispatch_ms.clear()
            status, payload, total = call(base, '/counterfactual', body)
        finally:
            serve.counterfactual_videos_and_flows_fast = engine
            del svc._parse_cf_request, svc._cf_response
        split['dispatch'] = sum(dispatch_ms) - split['response_pngs']
        # the dispatch's own host work around the engine: the noise, the
        # LRU key, the motion map, the copies to the host
        split['dispatch_rest'] = split['dispatch'] - split['engine']
        split['total_http'] = total
        split['body_mb'] = len(body) / 2 ** 20
        split['rest'] = total - sum(split[k] for k in (
            'json_parse', 'parse_image', 'dispatch', 'response_pngs'))
        split['host_share'] = 1 - split['dispatch'] / total
        out['split_warm_counterfactual_ms'] = split
        svc._batcher.dispatch = real_dispatch
        if status != 200:
            failures.append(f'split request: {status}')

        # the IMU-conditioned service on phase 5d's models
        imu_ctx = ctx['imu']
        args = argparse.Namespace(raft_iters=24, seed=0, engine='fast',
                                  prefix_cache_size=4, movability_samples=16,
                                  movability_iters=2)
        ig = serve.imu_movability_generator(
            imu_ctx['predictor'], imu_ctx['head_motion_predictor'], raft,
            args, dev)
        isvc = serve.ImuCwmService(ig, 224, engine='fast',
                                   batch_window_ms=5.0)
        ibase = start(isvc)
        imu, f2i = imu_ctx['models']
        f2i_blocks = (f2i.main.encoder_depth + f2i.main.decoder_depth
                      + f2i.context.encoder_depth + f2i.context.decoder_depth)
        prefix = imu.main.encoder_depth + imu.main.decoder_depth
        ik2 = suffix_k2(imu.main.encoder_depth, imu.main.decoder_depth,
                        packed=True)
        imu_out = {}
        maps = 1 + args.movability_iters
        icf = dict(cf, image=image())
        # each route: a warm-up request (the first one also builds the
        # conjoined engine's weights), then 3 timed, launches asserted on
        # every one; cold requests and /movability on new images
        for name, path, body, want in (
                ('counterfactual_cold', '/counterfactual',
                 lambda: enc(dict(cf, image=image())),
                 dict(flash_attention=f2i_blocks + prefix, **ik2,
                      window_lookup=3 * 24)),
                ('counterfactual_warm', '/counterfactual',
                 lambda: enc(icf), dict(ik2, window_lookup=24)),
                # flow2imu once (the service's static IMU, cached: the
                # loop's maps take it as head_motion), the prefix once,
                # one chunk of 16 per map
                ('movability', '/movability',
                 lambda: enc({'image': image()}),
                 dict(flash_attention=f2i_blocks + prefix,
                      **suffix_k2(imu.main.encoder_depth,
                                  imu.main.decoder_depth, maps, packed=True),
                      window_lookup=2 * 24 + maps * 24))):
            runs = []
            for i in range(4):
                payload = body()
                (resp, l_) = counted(lambda: call(ibase, path, payload))
                if i:
                    runs.append(resp[2])
                    expect(f'IMU {path} ({name})', l_, **want)
                    launches[f'imu_{name}'] = l_
                if path == '/counterfactual':
                    check_cf(f'IMU {path} ({name})', resp,
                             imu_conditioned=True, engine='fast',
                             batched_samples=S_FULL)
                    continue
                status, payload_out, _ = resp
                m = np.asarray(payload_out.get('movability_raw', []))
                if not (status == 200 and m.shape == (224, 224)
                        and bool(np.isfinite(m).all())
                        and png_decode(base64.b64decode(
                            payload_out['movability'])).shape
                        == (224, 224, 3)):
                    failures.append(f'IMU /movability: {status}')
            imu_out[name] = dict(ms=float(np.median(runs)), ms_runs=runs,
                                 launches=launches[f'imu_{name}'])
        imu_out['stats'] = stats(ibase)
        out['imu'] = imu_out
    finally:
        for httpd, th in servers:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)

    # the interactive interface on a fresh ViT-L generator, stub axes
    ui_gen = segmentation.FlowGenerator(
        predictor=cfg, params=sd, flow_model=raft, raft_iters=24,
        imagenet_normalize_inputs=True, seed=0, engine='fast', device=dev)
    axes = [_StubAxes() for _ in range(4)]
    x = np.asarray(image(), np.float32).transpose(2, 0, 1)[None]
    ui = CounterfactualPredictionInterface(axes, ui_gen, x=x,
                                           size=(224, 224))

    class Event:
        def __init__(self, key=None):
            self.xdata, self.ydata = 101.0, 77.0
            self.key, self.button, self.dblclick = key, 1, False

    ui_out = {}
    for key, want, n_flows in (
            (None, {}, 0),
            ('f', dict(flash_attention=depth, **k2, window_lookup=24), 1),
            ('b', dict(k2, window_lookup=24), 1 + ui.sample_batch_size),
            ('x', {}, 1 + ui.sample_batch_size)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (_, l_) = counted(lambda: ui(Event(key)))
        ms = (time.perf_counter() - t1) * 1e3
        name = key or 'click'
        launches[f'interface_{name}'] = l_
        expect(f"interface '{name}'", l_, **want)
        if len(ui.flow_samples_list) != n_flows:
            failures.append(f"interface '{name}': "
                            f'{len(ui.flow_samples_list)} flow samples')
        ui_out[name] = dict(ms=ms, launches=l_,
                            flow_samples=len(ui.flow_samples_list))
    if not (ui._flow_corrs is not None
            and bool(torch.isfinite(ui._flow_corrs).all())
            and int((~ui.active_patches).sum()) == ui_gen.predictor
            .num_patches_per_frame + 1):
        failures.append('interface state after the events')
    ui_out['drawn'] = [len(a.images) for a in axes]
    out['interface'] = ui_out
    out['launches'] = launches
    rec['phase5e'] = out
    log('5e serving', json.dumps(out))
    if failures:
        raise AssertionError('; '.join(failures))
    return out


def profile_default(torch, rec, ctx):
    """The default dispatch under torch.profiler, after every timed run of
    phases 5 and 5b (its after-cost would move them)."""
    rec['phase5'][0]['profile'] = profile_dispatch(torch, ctx['dispatch'])
    log('5 profile', json.dumps(rec['phase5'][0]['profile']))


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


# ---------------------------------------------------------------------------
# the ChannelMAE and conjoined trainers (phases 4, 6b and 6c)
# ---------------------------------------------------------------------------

def _card_vs_cpu_steps(torch, port, make, batches, step_of):
    """Three train steps of the model ``make(dev)`` builds (f32, flash
    attention) from the same weights on the CPU and the card: per device
    the [loss, grad norm] of each step and the launches of the run."""
    init = make('cpu').state_dict()
    runs = {}
    for dev in ('cpu', 'cuda'):
        model = make(dev)
        model.load_state_dict(init, strict=True)
        state, step = step_of(model)
        port.kernels.reset_launches()
        metrics = []
        for batch in batches:
            state, m = step(state, *batch)
            metrics.append([float(m['loss']), float(m['grad_norm'])])
        runs[dev] = (metrics, dict(port.kernels.LAUNCHES), model)
    return runs


def _rel(mc, mg):
    return max(abs(g / c - 1) for rc, rg in zip(mc, mg)
               for c, g in zip(rc, rg))


def small_cmae_train(torch, port, rec):
    """Three remat train steps of train_cmae's tiny ChannelMAE (64 px,
    16 px patches, partition (1, 2), encoder head dim 48: the padded
    route), card against CPU from the same weights and masks; then
    channel_mae_predict_image (K1) on both."""
    from counterfactualworldmodels_tpu_torch.models import cmae
    from counterfactualworldmodels_tpu_torch.training import train as T
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(image_size=(64, 64), patch_size=(16, 16), in_channels=3,
              channel_partition=(1, 2), encoder_embed_dim=96,
              encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=64,
              decoder_depth=1, decoder_num_heads=2, mlp_ratio=2.0,
              attn_impl='flash')

    def make(dev):
        return cmae.ChannelMae(device=dev, **kw)

    ref = make('cpu')
    T.init_cmae_train_state(ref, T.make_optimizer(), seed=3)
    gen = torch.Generator().manual_seed(6)
    rng = np.random.RandomState(6)
    batches = []
    for _ in range(3):
        mask, counts = cmae.group_uniform_mask(gen, ref.mask_size, 0.75, 4)
        x = torch.from_numpy(rng.rand(4, 3, 64, 64).astype(np.float32))
        batches.append((x, mask))
    n_vis = ref.num_patches - sum(counts)
    opt = T.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    init = ref.state_dict()

    def make_loaded(dev):
        m = make(dev)
        m.load_state_dict(init, strict=True)
        return m

    def step_of(model):
        state = T.TrainState(0, model, opt.init(model.parameters()))
        return state, T.make_cmae_train_step(model, opt, n_vis, counts,
                                             remat=True)

    runs = _card_vs_cpu_steps(torch, port, make_loaded, batches, step_of)
    (mc, lc, cpu), (mg, lg, gpu) = runs['cpu'], runs['cuda']
    blocks = 3
    expect = dict(lc, flash_attention_lse=3 * 2 * blocks,
                  flash_attention_bwd=3 * blocks)
    x, mask = batches[0]
    with torch.no_grad():
        img_c = cmae.channel_mae_predict_image(cpu, x, mask, n_vis, counts)
        port.kernels.reset_launches()
        img_g = cmae.channel_mae_predict_image(gpu, x.cuda(), mask.cuda(),
                                               n_vis, counts)
        lp = dict(port.kernels.LAUNCHES)
    r = dict(config='tiny ChannelMAE, 64 px, encoder D 48 (padded), f32, '
             'remat', steps=3, cpu=mc, cuda=mg, max_rel_diff=_rel(mc, mg),
             tol_rel=1e-4, launches_cpu=lc, launches_gpu=lg,
             predict_image_err=max_err(img_c, img_g.cpu()),
             predict_image_launches=lp, tol_image=1e-4)
    rec['phase4'].append(r)
    log('4 small cmae train', json.dumps(r))
    if not (r['max_rel_diff'] <= 1e-4 and not any(lc.values())
            and lg == expect and r['predict_image_err'] <= 1e-4
            and lp == dict(lc, flash_attention=blocks)):
        raise AssertionError(f'small ChannelMAE card vs CPU: {r}')
    return lp


def small_conjoined_train(torch, port, rec):
    """Three remat train steps of train_conjoined's default 'small' model
    (112 px; head dims 24, 16, 16 and 8: the main encoder and the IMU
    decoder run padded), card against CPU from the same weights, masks and
    IMU."""
    import argparse
    from counterfactualworldmodels_tpu_torch.models import conjoined as C
    from counterfactualworldmodels_tpu_torch.training import train as T
    from counterfactualworldmodels_tpu_torch.training import train_conjoined
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = train_conjoined.build_model(
        argparse.Namespace(model='small', img_size=112), torch.device('cpu'))

    def make(dev):                   # f32 flash attention on both
        return C.ConjoinedVMAE(
            main=spec.main, context=spec.context,
            conjoin_encoder_layers=spec.conjoin_encoder_layers,
            conjoin_decoder_layers=spec.conjoin_decoder_layers,
            attn_impl='flash', device=dev)

    ref = make('cpu')
    ref.load_state_dict(weights.init_conjoined_state_dict(
        ref, torch.Generator().manual_seed(4)), strict=True)
    init = ref.state_dict()
    n = ref.main.num_patches
    n_vis = max(1, int(round(n * 0.1)))
    n_vis_c = ref.context.num_patches
    masks = train_conjoined.mask_sampler(ref, n_vis)
    gen = torch.Generator().manual_seed(8)
    rng = np.random.RandomState(8)
    batches = []
    for _ in range(3):
        mask, mc = masks(gen, 2)
        x = torch.from_numpy(rng.rand(2, 3, 2, 112, 112).astype(np.float32))
        imu = torch.from_numpy((rng.randn(2, 6, 400, 1, 1) * 0.1)
                               .astype(np.float32))
        batches.append((x, mask, imu, mc))
    opt = T.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)

    def make_loaded(dev):
        m = make(dev)
        m.load_state_dict(init, strict=True)
        return m

    def step_of(model):
        state = T.TrainState(0, model, opt.init(model.parameters()))
        return state, T.make_conjoined_train_step(model, opt, n_vis,
                                                  n_vis_c, remat=True)

    runs = _card_vs_cpu_steps(torch, port, make_loaded, batches, step_of)
    (mc_, lc, _), (mg, lg, _) = runs['cpu'], runs['cuda']
    blocks = (ref.main.encoder_depth + ref.main.decoder_depth
              + ref.context.encoder_depth + ref.context.decoder_depth)
    expect = dict(lc, flash_attention_lse=3 * 2 * blocks,
                  flash_attention_bwd=3 * blocks)
    heads = sorted({m.head_dim for m in ref.modules()
                    if hasattr(m, 'head_dim') and hasattr(m, 'qkv')})
    r = dict(config='train_conjoined small, 112 px, f32, remat',
             head_dims=heads, steps=3, cpu=mc_, cuda=mg,
             max_rel_diff=_rel(mc_, mg), tol_rel=1e-4, launches_cpu=lc,
             launches_gpu=lg)
    rec['phase4'].append(r)
    log('4 small conjoined train', json.dumps(r))
    if not (r['max_rel_diff'] <= 1e-4 and not any(lc.values())
            and lg == expect):
        raise AssertionError(f'small conjoined card vs CPU: {r}')
    return lg


class _LoopSpy:
    """Wraps training.loop.run while a trainer's main runs: the launches
    made before the loop (a teacher's), each step's launches (counts set to
    0 just before the step, read just after), its seconds, the peak memory
    after the warm-up step, the loader the run opened and, with
    ``profile_last``, the last step's device profile (``profile_fn``)."""

    def __init__(self, torch, port, profile_last=False, profile_fn=None):
        from counterfactualworldmodels_tpu_torch.training import loop
        self.torch, self.port, self.loop = torch, port, loop
        self.profile_last = profile_last
        self.profile_fn = profile_fn or profile_dispatch
        self.steps, self.loaders, self.profile = [], [], None
        self.before_loop = None

    def __enter__(self):
        loop, torch, port = self.loop, self.torch, self.port
        self._run, self._shard_loader = loop.run, loop.shard_loader

        def run(args, state, ckpt, start, step_fn, rate_key):
            torch.cuda.synchronize()
            self.before_loop = dict(port.kernels.LAUNCHES)

            def counted(state, step):
                if step == start + 1:
                    torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                port.kernels.reset_launches()
                t0 = time.perf_counter()
                if self.profile_last and step == args.steps - 1:
                    box = []
                    self.profile = self.profile_fn(
                        torch, lambda: box.append(step_fn(state, step)))
                    out = box[0]
                else:
                    out = step_fn(state, step)
                torch.cuda.synchronize()
                self.steps.append(dict(
                    step=step + 1, seconds=time.perf_counter() - t0,
                    launches=dict(port.kernels.LAUNCHES)))
                return out
            return self._run(args, state, ckpt, start, counted, rate_key)

        def shard_loader(*a, **k):
            ld = self._shard_loader(*a, **k)
            self.loaders.append(ld)
            return ld

        loop.run, loop.shard_loader = run, shard_loader
        return self

    def __exit__(self, *exc):
        self.loop.run, self.loop.shard_loader = self._run, self._shard_loader


def _train_main(torch, port, main, argv, profile_last=False,
                profile_fn=None):
    """(records, spy) of one trainer's main(argv) on the card."""
    with _LoopSpy(torch, port, profile_last, profile_fn) as spy:
        records = main(argv)
    return records, spy


def full_trainers(torch, port, rec, smi):
    """The ChannelMAE and conjoined trainers at full width through their
    entry points: train_cmae at the script's defaults (ViT-B, 224 px, 32 px
    patches, batch 32), the same with --with-flow (RAFT-12 on every batch),
    and train_conjoined --model imu400 (batch 8); one warm-up, three
    timed steps and one profiled step each (the device's busy time and
    idle share), with every step's launches asserted."""
    from counterfactualworldmodels_tpu_torch.training import (
        train_cmae, train_conjoined)
    zeros = {name: 0 for name in port.kernels.LAUNCHES}
    runs = (
        ('train_cmae', train_cmae.main, ['--synthetic', '--steps', '5'],
         dict(zeros, flash_attention_lse=2 * 16, flash_attention_bwd=16), 32),
        ('train_cmae --with-flow', train_cmae.main,
         ['--synthetic', '--steps', '5', '--with-flow'],
         dict(zeros, flash_attention_lse=2 * 16, flash_attention_bwd=16,
              window_lookup=12), 32),
        ('train_conjoined imu400', train_conjoined.main,
         ['--synthetic', '--steps', '5', '--model', 'imu400',
          '--img-size', '224', '--batch-size', '8'],
         dict(zeros, flash_attention_lse=2 * 32, flash_attention_bwd=32), 8))
    out, bad = {}, []
    for name, main, argv, expect, batch in runs:
        t0 = time.perf_counter()
        records, spy = _train_main(torch, port, main, argv,
                                   profile_last=True)
        times = [s['seconds'] for s in spy.steps[1:4]]
        sec = float(np.median(times))
        r = dict(argv=argv, batch=batch,
                 losses=[x['loss'] for x in records],
                 grad_norms=[x['grad_norm'] for x in records],
                 sec_per_step_runs=times, sec_per_step=sec,
                 samples_per_s=batch / sec,
                 logged_sec_per_step=[x['sec_per_step'] for x in records],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches_per_step=[s['launches'] for s in spy.steps],
                 expected_launches=expect, profile=spy.profile,
                 wall_s=time.perf_counter() - t0, card=smi)
        finite = all(math.isfinite(v) for v in r['losses'] + r['grad_norms'])
        r['ok'] = (finite and len(records) == 5
                   and all(s['launches'] == expect for s in spy.steps))
        out[name] = r
        log('6b trainers', f'{name}: ' + json.dumps(r))
        if not r['ok']:
            bad.append(name)
        del spy
        torch.cuda.empty_cache()
    rec['phase6b'] = out
    if bad:
        raise AssertionError(f'full-width trainers failed: {bad}')
    return out


def shard_resume(torch, port, rec, smi):
    """A seeded shard (64 clips of 2x224x224x3 uint8) with an IMU sidecar;
    the native loader built from the port's copy of clip_loader.cpp;
    train_vmae --shard --input-mode u8 at its defaults for 4 steps with a
    checkpoint every 2, then resumed from step 2 in a new state: steps 3-4
    bitwise the uninterrupted run's losses; the same for train_conjoined
    --shard on the sidecar (2 steps, resumed from step 1)."""
    import shutil as sh
    import tempfile
    from counterfactualworldmodels_tpu_torch.data import shards
    from counterfactualworldmodels_tpu_torch.training import (
        train_conjoined, train_vmae)
    tmp = tempfile.mkdtemp(prefix='cwm_shard_')
    build_dir = shards.BUILD_DIR
    # build the loader afresh in this run, from the port's source
    shards.BUILD_DIR = os.path.join(tmp, 'build')
    try:
        rng = np.random.RandomState(11)
        path = os.path.join(tmp, 'clips.shard')
        shards.write_shard(path, rng.randint(0, 256, (64, 2, 224, 224, 3),
                                             dtype=np.uint8))
        shards.write_imu_sidecar(path, (rng.randn(64, 6, 400) * 0.1)
                                 .astype(np.float32))
        t0 = time.perf_counter()
        lib = shards.build_native()
        build_s = time.perf_counter() - t0
        src_ok = (os.path.dirname(shards.SRC) == os.path.join(
            HERE, 'counterfactualworldmodels_tpu_torch', 'data', 'native')
            and lib == shards.native_library_path())
        out = dict(shard_mb=os.path.getsize(path) / 2 ** 20, library=lib,
                   built_from=shards.SRC, build_s=build_s, card=smi)
        log('6c shards', f'native loader built in {build_s:.1f}s: {lib}')

        def run(main, argv, ckpt_dir, steps):
            records, spy = _train_main(
                torch, port, main, ['--shard', path, '--steps', str(steps),
                                    '--checkpoint-dir', ckpt_dir] + argv)
            loaders = [type(ld).__name__ + ':' + getattr(ld, 'library', '')
                       for ld in spy.loaders]
            return {x['step']: x['loss'] for x in records}, loaders

        bad = []
        for name, main, argv, steps, at in (
                ('train_vmae', train_vmae.main,
                 ['--input-mode', 'u8', '--checkpoint-every', '2'], 4, 2),
                ('train_conjoined', train_conjoined.main,
                 ['--checkpoint-every', '1'], 2, 1)):
            full_dir = os.path.join(tmp, name + '_full')
            full, loaders = run(main, argv, full_dir, steps)
            resumed_dir = os.path.join(tmp, name + '_resumed')
            os.makedirs(resumed_dir)
            sh.copytree(os.path.join(full_dir, f'step_{at:09d}'),
                        os.path.join(resumed_dir, f'step_{at:09d}'))
            resumed, loaders2 = run(main, argv, resumed_dir, steps)
            later = range(at + 1, steps + 1)
            diff = max(abs(resumed[s] / full[s] - 1) for s in later)
            r = dict(full=full, resumed=resumed, resumed_from=at,
                     bitwise=all(resumed[s] == full[s] for s in later),
                     max_rel_diff=diff, loaders=loaders + loaders2)
            r['ok'] = (sorted(resumed) == list(later) and r['bitwise']
                       and all(math.isfinite(v) for v in full.values())
                       and all(ld == f'NativeClipLoader:{lib}'
                               for ld in r['loaders']))
            out[name] = r
            log('6c shards', f'{name}: ' + json.dumps(r))
            if not r['ok']:
                bad.append(name)
        out['native_from_the_port'] = src_ok
        rec['phase6c'] = out
        if bad or not src_ok:
            raise AssertionError(f'shard and resume: {bad}, port loader '
                                 f'{src_ok}')
        return out
    finally:
        shards.BUILD_DIR = build_dir
        sh.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: RAFT training and data-parallel work
# ---------------------------------------------------------------------------

LOOKUP_RANGE = 'cwm_gather_lookup'


def _dev_us(e):
    us = getattr(e, 'device_time_total', None)
    return us if us is not None else getattr(e, 'cuda_time_total', 0)


def profile_raft_step(torch, fn):
    """profile_dispatch's record of one RAFT train step, plus the device time
    of its gather lookups: the forward, the kernels launched inside each
    lookup call (a record_function range marks the call; remat runs the
    forward twice), and the backward, the autograd nodes of the first
    forward's lookup ops (matched by sequence number and forward thread:
    remat's recomputation rebuilds the saved tensors, and the backward runs
    the first forward's nodes). A measurement: 'not measured' when the
    trace cannot give it."""
    from torch.profiler import record_function
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    real = traft.lookup_pyramid

    def marked(*a):
        with record_function(LOOKUP_RANGE):
            return real(*a)

    traft.lookup_pyramid = marked
    try:
        prof, wall_ms = _profiled(torch, fn)
    except Exception as e:  # the trace is optional; report why it is absent
        return f'not measured ({type(e).__name__}: {e})'
    finally:
        traft.lookup_pyramid = real
    out = _summary(prof, wall_ms)
    if not isinstance(out, dict):
        return out
    try:
        events = prof.events()
        # the host-side ranges (a device-side annotation of the same name
        # spans the gaps between kernels too)
        ranges = [e for e in events if e.name == LOOKUP_RANGE
                  and str(e.device_type).endswith('CPU')]
        first = min(e.thread for e in ranges)
        fwd_ops, stack = set(), [e for e in ranges if e.thread == first]
        while stack:
            e = stack.pop()
            if getattr(e, 'sequence_nr', -1) >= 0:
                fwd_ops.add((e.sequence_nr, e.thread))
            stack.extend(e.cpu_children)
        bwd = [e for e in events if getattr(e, 'fwd_thread', None) is not None
               and (getattr(e, 'sequence_nr', -1), e.fwd_thread) in fwd_ops
               and not e.name.startswith(('aten::', 'autograd::'))]
        fwd_ms = sum(_dev_us(e) for e in ranges) / 1e3
        bwd_ms = sum(_dev_us(e) for e in bwd) / 1e3
        out['gather_lookup'] = dict(
            calls=len(ranges), forward_ms=fwd_ms, backward_ms=bwd_ms,
            backward_nodes=sorted({e.name for e in bwd}),
            share_of_busy=(fwd_ms + bwd_ms) / out['device_busy_ms'])
    except Exception as e:  # the attribution is a measurement only
        out['gather_lookup'] = f'not measured ({type(e).__name__}: {e})'
    return out


def gather_lookup_ms(torch, corr, b, h8, iters, remat):
    """The gather lookup alone at a train step's shapes (bf16 output for
    convc1, f32 sums, radius 4, four levels): one forward and one forward
    + backward, each as CUDA-event ms around back-to-back calls (host
    launches included) and as the device time of its kernels (profiled),
    and the device ms over a step (``iters`` calls, each forward run twice
    with remat)."""
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(4)
    c = torch.randn(b, h8, h8, h8, h8, device=dev, generator=g)
    pyr = [lv.detach().requires_grad_() for lv in corr.build_pyramid(c, 4)]
    coords = (torch.rand(b, h8, h8, 2, device=dev, generator=g) * h8
              ).requires_grad_()
    cot = torch.randn(b, h8, h8, 4 * 81, device=dev, generator=g,
                      dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            corr.lookup_pyramid(pyr, coords, 4, torch.bfloat16, 'gather')

    def fwd_bwd():
        out = corr.lookup_pyramid(pyr, coords, 4, torch.bfloat16, 'gather')
        out.backward(cot)

    f_dev = sum(kernel_device_us(torch, fwd).values()) / 1e3
    fb_dev = sum(kernel_device_us(torch, fwd_bwd).values()) / 1e3
    return dict(shapes=dict(batch=b, grid=h8, levels=4, radius=4),
                forward_ms=time_ms(torch, fwd),
                forward_backward_ms=time_ms(torch, fwd_bwd),
                forward_device_ms=f_dev, forward_backward_device_ms=fb_dev,
                per_step_device_ms=iters * ((2 if remat else 1) * f_dev
                                            + (fb_dev - f_dev)))


def raft_trainer(torch, port, rec, smi):
    """(a) train_raft --mode flow at the script's defaults (large RAFT,
    224 px, batch 8, 12 iterations, remat, bf16, --synthetic) through
    main(argv): one warm-up, three timed steps and one profiled step (busy
    share, the gather lookup's device ms forward and backward), no lookup
    kernel launched in any step; (b) train_raft --mode keypoint --teacher
    movability --teacher-model tiny for 2 steps: the teacher's K1, K2 and
    lookup launches before the loop, none in a step."""
    from counterfactualworldmodels_tpu_torch.models.raft import corr
    from counterfactualworldmodels_tpu_torch.training import train_raft
    zeros = {name: 0 for name in port.kernels.LAUNCHES}
    out = {}
    t0 = time.perf_counter()
    records, spy = _train_main(torch, port, train_raft.main,
                               ['--synthetic', '--steps', '5'],
                               profile_last=True,
                               profile_fn=profile_raft_step)
    times = [s['seconds'] for s in spy.steps[1:4]]
    sec = float(np.median(times))
    a = dict(argv='--synthetic --steps 5 (defaults: large, 224 px, batch 8, '
                  '12 iterations, remat, bf16)',
             losses=[x['loss'] for x in records],
             epes=[x['epe'] for x in records],
             grad_norms=[x['grad_norm'] for x in records],
             sec_per_step_runs=times, sec_per_step=sec, pairs_per_s=8 / sec,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches_per_step=[s['launches'] for s in spy.steps],
             profile=spy.profile, wall_s=time.perf_counter() - t0, card=smi)
    a['lookup_alone'] = gather_lookup_ms(torch, corr, 8, 28, 12, True)
    a['ok'] = (len(records) == 5 and all(
        math.isfinite(v) for v in a['losses'] + a['epes'] + a['grad_norms'])
        and all(s['launches'] == zeros for s in spy.steps))
    out['flow'] = a
    log('8 raft', 'flow: ' + json.dumps(a))
    del spy
    torch.cuda.empty_cache()

    port.kernels.reset_launches()
    records, spy = _train_main(
        torch, port, train_raft.main,
        ['--mode', 'keypoint', '--synthetic', '--teacher', 'movability',
         '--teacher-model', 'tiny', '--steps', '2'])
    teacher = spy.before_loop
    b = dict(losses=[x['loss'] for x in records],
             teacher_launches=teacher,
             launches_per_step=[s['launches'] for s in spy.steps],
             sec_per_step_runs=[s['seconds'] for s in spy.steps], card=smi)
    b['ok'] = (len(records) == 2
               and all(math.isfinite(x) for x in b['losses'])
               and teacher['flash_attention'] > 0
               and teacher['flash_attention_prefix'] > 0
               and teacher['window_lookup'] > 0
               and teacher['window_lookup'] % 12 == 0
               and all(s['launches'] == zeros for s in spy.steps))
    out['keypoint'] = b
    log('8 raft', 'keypoint: ' + json.dumps(b))
    rec['phase8_trainer'] = out
    if not (a['ok'] and b['ok']):
        raise AssertionError('train_raft on the card failed')
    return out


def small_raft_train(torch, port, rec):
    """(c) three steps of make_raft_train_step and of
    make_keypoint_distill_step on the small RAFT (f32, TF32 off, 2
    iterations, 64x64), card against CPU from the same weights and
    batches: losses and gradient norms within 1e-4 (phase 4's bar), the
    gather lookup on the card with no kernel launch."""
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.training import raft as TR
    from counterfactualworldmodels_tpu_torch.training import train as T
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(13)
    g = torch.Generator().manual_seed(13)
    flow = [TR.synthetic_flow_batch(torch.from_numpy(
        (rng.rand(2, 3, 64, 64) * 255).astype(np.float32)), max_mag=3.0,
        generator=g) for _ in range(3)]
    kp = [(torch.from_numpy((rng.rand(2, 3, 64, 64) * 255).astype(
        np.float32)), torch.from_numpy(rng.rand(2, 1, 64, 64).astype(
            np.float32))) for _ in range(3)]
    opt = T.make_optimizer(learning_rate=1e-4, warmup_steps=1,
                           total_steps=10)
    out, bad = {}, []
    for name, keypoint, batches in (('flow', False, flow),
                                    ('keypoint', True, kp)):
        runs = {}
        for dev in ('cpu', 'cuda'):
            model = RAFT(small=True, iters=2, device=dev,
                         output_dim=1 if keypoint else None)
            state = TR.init_raft_train_state(model, opt, seed=5)
            step = (TR.make_keypoint_distill_step(model, opt, remat=True)
                    if keypoint else
                    TR.make_raft_train_step(model, opt, remat=True))
            port.kernels.reset_launches()
            metrics = []
            for batch in batches:
                state, m = step(state, *batch)
                metrics.append([float(v) for _, v in sorted(m.items())])
            runs[dev] = (metrics, dict(port.kernels.LAUNCHES))
        (mc, _), (mg, lg) = runs['cpu'], runs['cuda']
        r = dict(case=f'small RAFT {name}, 3 steps, 64x64, 2 iterations',
                 cpu=mc, card=mg, max_rel_diff=_rel(mc, mg),
                 launches_card=lg, tol=1e-4)
        r['ok'] = (r['max_rel_diff'] <= 1e-4 and not any(lg.values())
                   and all(math.isfinite(v) for row in mg for v in row))
        out[name] = r
        rec['phase4'].append(r)
        log('8 small raft train', json.dumps(r))
        if not r['ok']:
            bad.append(name)
    if bad:
        raise AssertionError(f'small RAFT train steps card vs CPU: {bad}')
    return out


def _vmae_steps(torch, T, cfg, opt, make_step, clips, port):
    """Three keyed steps from seed-0 weights: losses, norms, launches."""
    dev = torch.device('cuda')
    state = T.init_train_state(cfg, opt, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step, state = make_step(state)
    losses, norms, launches = [], [], []
    for x in clips:
        port.kernels.reset_launches()
        state, m = step(state, x, gen)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
        torch.cuda.synchronize()
        launches.append(dict(port.kernels.LAUNCHES))
    return losses, norms, launches


def world_one(torch, port, rec, smi, ctx):
    """(d) a process group of one rank over NCCL: make_sharded_train_step
    at phase 6's configuration (ViT-L 4x4 @224, bf16, batch 4, remat),
    three steps with losses bitwise make_train_step's on the same batches
    and masks and K5 72 / K6 36 a step; sharded_counterfactuals_fast on
    phase 5's weights, prompts and draws at the default rung (S = 16): the
    direct dispatch's launches (K1 36, K2 36, lookup 24) and its outputs."""
    import tempfile
    import torch.distributed as dist
    from counterfactualworldmodels_tpu_torch import parallel
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        counterfactual_videos_and_flows_fast)
    from counterfactualworldmodels_tpu_torch.training import train as T
    dev = torch.device('cuda')
    tmp = tempfile.mkdtemp(prefix='cwm_pg_')
    parallel.initialize_distributed(
        init_method='file://' + os.path.join(tmp, 'store'), world_size=1,
        rank=0, device=dev, timeout_s=300)
    try:
        out = {'backend': dist.get_backend()}
        cfg = vmae.large_4x4patch_2frames_1tube(dtype=torch.bfloat16,
                                                attn_impl='flash')
        opt = T.make_optimizer(learning_rate=1.5e-4, warmup_steps=1,
                               total_steps=100)
        _, n_vis = T.make_batch_masks(None, cfg, B_TRAIN, MASK_RATIO)

        def mask_fn(g, b):
            return T.make_batch_masks(g, cfg, b, MASK_RATIO)[0]

        rng = np.random.RandomState(0)
        base = rng.rand(B_TRAIN, 1, 3, 224, 224).astype(np.float32)
        clips = [torch.from_numpy(np.concatenate(
            [base, np.roll(base, tuple(rng.randint(-8, 9, 2)),
                           axis=(-2, -1))], 1)).to(dev) for _ in range(3)]
        mesh = parallel.make_mesh({'dp': 1})

        def plain(state):
            return T.make_train_step(cfg, opt, n_vis, remat=True,
                                     mask_fn=mask_fn, device=dev), state

        def sharded(state):
            step, shard_state, _ = T.make_sharded_train_step(
                cfg, opt, mesh, n_vis, remat=True, mask_fn=mask_fn,
                device=dev)
            return step, shard_state(state)

        runs = {name: _vmae_steps(torch, T, cfg, opt, make, clips, port)
                for name, make in (('make_train_step', plain),
                                   ('make_sharded_train_step', sharded))}
        torch.cuda.empty_cache()
        depth = cfg.encoder_depth + cfg.decoder_depth
        want = dict({k: 0 for k in port.kernels.LAUNCHES},
                    flash_attention_lse=2 * depth, flash_attention_bwd=depth)
        (lp, np_, _), (ls, ns, launches) = (runs['make_train_step'],
                                           runs['make_sharded_train_step'])
        t_ok = (ls == lp and ns == np_ and all(x == want for x in launches))
        out['train'] = dict(losses=ls, plain_losses=lp, grad_norms=ns,
                            plain_grad_norms=np_, launches_per_step=launches,
                            bitwise=ls == lp and ns == np_, ok=t_ok)
        log('8 world 1', 'train: ' + json.dumps(out['train']))

        model, fp, raft = ctx['model'], ctx['fp'], ctx['raft']
        x, p, a, shifts, noise, n_vis_cf = (ctx['inputs'][k] for k in (
            'x', 'p', 'a', 'shifts', 'noise', 'n_vis'))
        rung = ctx['default']
        smesh = parallel.sample_parallel_mesh()
        ref = counterfactual_videos_and_flows_fast(
            model, fp, raft, x, p, a, shifts, noise, ctx['pad'], True, 24,
            True, None, *rung, n_vis=n_vis_cf)
        torch.cuda.synchronize()
        port.kernels.reset_launches()
        t1 = time.perf_counter()
        got = parallel.sharded_counterfactuals_fast(
            smesh, model, fp, raft, x, p, a, shifts, noise, n_vis_cf, True,
            24, None, *rung)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launches = engine_launches(port)
        want = dict({k: 0 for k in engine_launches(port)},
                    flash_attention=model.encoder_depth + model.decoder_depth,
                    **suffix_k2(model.encoder_depth, model.decoder_depth,
                                packed=True),
                    window_lookup=24)
        # phase 5b's bar for another route to the same dispatch: masks
        # bitwise, videos within REL_BF16 of their largest magnitude
        errs = [max_err(g_, r_) for g_, r_ in zip(got[:2], ref[:2])]
        tol = REL_BF16 * float(ref[0].float().abs().max())
        d_ok = (launches == want and torch.equal(got[2], ref[2])
                and errs[0] <= tol)
        out['dispatch'] = dict(samples=S_FULL, rung=list(rung),
                               launches=launches, ms=ms,
                               video_max_err=errs[0], video_tol=tol,
                               flow_max_err=errs[1],
                               bitwise=errs == [0.0, 0.0], ok=d_ok, card=smi)
        log('8 world 1', 'dispatch: ' + json.dumps(out['dispatch']))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rec['phase8_world1'] = out
    if not (t_ok and d_ok):
        raise AssertionError('world size 1 over NCCL failed')
    return out


# the two ranks of phase 8 (e): spawned, so these run in fresh processes

def _two_rank_checks(rank, tmp):
    """One of two gloo ranks sharing the card: three dp steps of the small
    VMAE (f32, flash, TF32 off) and sharded_counterfactuals_fast on a tiny
    ViT and the small RAFT; results saved for the parent."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from counterfactualworldmodels_tpu_torch import parallel
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        parallel.initialize_distributed(
            init_method='file://' + os.path.join(tmp, 'store'),
            world_size=2, rank=rank, backend='gloo', device='cuda',
            timeout_s=300)
        inputs = torch.load(os.path.join(tmp, 'inputs.pt'),
                            weights_only=False)
        res = _small_parallel_work(torch, inputs,
                                   parallel.make_mesh({'dp': 2}),
                                   parallel.sample_parallel_mesh())
        torch.save(res, os.path.join(tmp, f'rank{rank}.pt'))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def _small_parallel_work(torch, inputs, mesh=None, smesh=None):
    """The small VMAE's three steps (the dp step on this rank's rows with a
    mesh, else the single-process step on the global batch) and the tiny
    fast dispatch (sample-sharded with smesh, else direct), on the card."""
    from counterfactualworldmodels_tpu_torch import parallel
    from counterfactualworldmodels_tpu_torch.models import fast_vmae, vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        counterfactual_videos_and_flows_fast)
    from counterfactualworldmodels_tpu_torch.training import train as T
    dev = torch.device('cuda')
    cfg = vmae.PretrainVisionTransformer(**SMALL_VMAE, attn_impl='flash')
    module = vmae.PretrainVisionTransformerModule(cfg, device=dev)
    module.load_state_dict(inputs['vmae_sd'], strict=True)
    opt = T.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10)
    state = T.TrainState(0, module, opt.init(module.parameters()))
    _, n_vis = T.make_batch_masks(None, cfg, 4, MASK_RATIO)

    def mask_fn(g, b):
        return T.make_batch_masks(g, cfg, b, MASK_RATIO)[0]

    kw = dict(remat=False, mask_fn=mask_fn, device=dev)
    if mesh is None:
        step = T.make_train_step(cfg, opt, n_vis, **kw)
    else:
        step, shard_state, dp = T.make_sharded_train_step(cfg, opt, mesh,
                                                          n_vis, **kw)
        state = shard_state(state)
    metrics = []
    for i, x in enumerate(inputs['clips']):
        x = x.to(dev) if mesh is None else dp.local(x.to(dev))
        state, m = step(state, x, torch.Generator(device=dev).manual_seed(i))
        metrics.append([float(m['loss']), float(m['grad_norm'])])
    params = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    tiny = vmae.PretrainVisionTransformer(**TINY_VMAE)
    fp = fast_vmae.stack_vmae_params(tiny, inputs['tiny_sd'],
                                     dtype=torch.float32, device=dev)
    raft = RAFT(iters=2, small=True, device=dev)
    raft.load_state_dict(inputs['raft_sd'], strict=True)
    d = {k: v.to(dev) for k, v in inputs['dispatch'].items()}
    n = tiny.num_patches
    n0 = tiny.num_patches_per_frame
    n_vis_cf = inputs['n_vis']
    if smesh is None:
        out = counterfactual_videos_and_flows_fast(
            tiny, fp, raft, d['x'], d['p'], d['a'], d['shifts'], d['noise'],
            fast_vmae.sfx_bucket(n_vis_cf - n0, n - n0), True, 2, True,
            n_vis=n_vis_cf)
    else:
        out = parallel.sharded_counterfactuals_fast(
            smesh, tiny, fp, raft, d['x'], d['p'], d['a'], d['shifts'],
            d['noise'], n_vis_cf, True, 2)
    return dict(metrics=metrics, params=params,
                dispatch=[o.cpu() for o in out])


# the tests' tiny ViT (tests/torch_port_common.TINY)
TINY_VMAE = dict(img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
                 encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
                 decoder_depth=1, decoder_num_heads=2, num_frames=2,
                 qkv_bias=True)


def two_ranks(torch, port, rec, smi):
    """(e) two gloo ranks on the one card (NCCL refuses two ranks on one
    device): three dp steps of the small VMAE against the single-process
    step on the global batch (rtol 1e-4, parameters atol 1e-4, every
    rank's bitwise equal), and sharded_counterfactuals_fast against the
    direct dispatch (videos 1e-5, flows 1e-4, masks equal). gloo takes the
    CUDA tensors of every collective the port uses (broadcast, all_reduce,
    all_gather); a rank's traceback names the one that failed."""
    import multiprocessing
    import tempfile
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix='cwm_ranks_')
    try:
        g = torch.Generator().manual_seed
        rng = np.random.RandomState(17)
        tiny = vmae.PretrainVisionTransformer(**TINY_VMAE)
        n, n0 = tiny.num_patches, tiny.num_patches_per_frame
        p, a, shifts, n_vis = prompts(rng, n, 4, 8)
        frame = rng.rand(3, 32, 32).astype(np.float32)
        inputs = dict(
            vmae_sd=weights.init_vmae_state_dict(
                vmae.PretrainVisionTransformer(**SMALL_VMAE), g(0)),
            tiny_sd=weights.init_vmae_state_dict(tiny, g(1)),
            raft_sd=weights.init_raft(RAFT(iters=2, small=True,
                                           device='cpu'), g(2)).state_dict(),
            clips=[torch.from_numpy(rng.rand(4, 2, 3, 32, 32).astype(
                np.float32)) for _ in range(3)],
            n_vis=n_vis, dispatch=dict(
                x=torch.from_numpy(np.broadcast_to(
                    frame, (1, 2, 3, 32, 32)).copy()),
                p=torch.from_numpy(np.asarray(p)),
                a=torch.from_numpy(np.asarray(a)),
                shifts=torch.from_numpy(np.asarray(shifts)),
                noise=torch.from_numpy(rng.rand(4, n - n0).astype(
                    np.float32) * 0.999)))
        torch.save(inputs, os.path.join(tmp, 'inputs.pt'))
        ctx = multiprocessing.get_context('spawn')
        procs = [ctx.Process(target=_two_rank_checks, args=(r, tmp))
                 for r in range(2)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        ref = _small_parallel_work(torch, inputs)
        for pr in procs:
            pr.join(300)
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        errs = []
        for r in range(2):
            path = os.path.join(tmp, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f.read())
        if alive or errs or any(pr.exitcode for pr in procs):
            raise AssertionError('the gloo ranks failed: alive '
                                 f'{len(alive)}\n' + '\n'.join(errs))
        ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                            weights_only=False) for r in range(2)]
        out = dict(seconds=time.perf_counter() - t0, card=smi)
        rel = max(_rel(ref['metrics'], rk['metrics']) for rk in ranks)
        perr = max(max_err(rk['params'][k], ref['params'][k])
                   for rk in ranks for k in ref['params'])
        same = all(torch.equal(ranks[0]['params'][k], ranks[1]['params'][k])
                   for k in ref['params'])
        derr = [max(max_err(rk['dispatch'][i], ref['dispatch'][i])
                    for rk in ranks) for i in range(2)]
        masks = all(torch.equal(rk['dispatch'][2], ref['dispatch'][2])
                    for rk in ranks)
        out.update(dp_metrics=[rk['metrics'] for rk in ranks],
                   single_metrics=ref['metrics'], max_rel_diff=rel,
                   params_max_err=perr, ranks_bitwise=same,
                   video_max_err=derr[0], flow_max_err=derr[1],
                   masks_equal=masks)
        out['ok'] = (rel <= 1e-4 and perr <= 1e-4 and same
                     and derr[0] <= 1e-5 and derr[1] <= 1e-4 and masks)
        rec['phase8_two_ranks'] = out
        log('8 two ranks', json.dumps(out))
        if not out['ok']:
            raise AssertionError(f'two gloo ranks on one card: {out}')
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: model sharding (tensor, sequence and pipeline parallelism)
# ---------------------------------------------------------------------------

# the tp steps of phase 9 (b): ViT-L 4x4 @224 widths, depth cut to fit
TP_DEPTH = dict(encoder_depth=2, decoder_depth=1)
# phase 9 (c): the encoder stacks at ViT-L widths over the 3136-token prefix
STACK_DEPTH = 4
STACK_TOKENS = 3136
# the ChannelMAE and conjoined models of tests/test_parallel.py's dp x tp
# steps (tests/torch_model_parallel_ranks.py)
TP_CMAE = dict(image_size=(32, 32), patch_size=(16, 16), in_channels=3,
               channel_partition=(3,), encoder_embed_dim=64, encoder_depth=2,
               encoder_num_heads=4, decoder_embed_dim=48, decoder_depth=1,
               decoder_num_heads=4, mlp_ratio=2.0)
TP_CONJ = dict(
    main=dict(img_size=(32, 32), patch_size=(8, 8), in_chans=3, num_frames=2,
              encoder_embed_dim=48, encoder_depth=2, encoder_num_heads=4,
              decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=4,
              mlp_ratio=2.0),
    context=dict(is_imu=True, in_chans=6, sequence_length=32, imu_tubelet=8,
                 encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=4,
                 decoder_embed_dim=24, decoder_depth=1, decoder_num_heads=4,
                 decoder_num_classes=48, mlp_ratio=2.0,
                 concat_dummy_token=True))
# phase 9 (d): train_vmae through main(argv), ViT-B at batch 4
TP_TRAINER = ['--synthetic', '--model', 'base', '--batch-size', '4',
              '--checkpoint-every', '2']
TOL_TP = 1e-5


class _ShapeSpy:
    """Within the block, the [B, H, Nq, Nk, D] of every K1, K5 and K6
    launch: each wrapper is wrapped, and a call's shapes are kept when the
    wrapper's own count went up (the counts stay the wrappers')."""
    NAMES = {'flash_attention': 'flash_attention',
             '_flash_forward_lse': 'flash_attention_lse',
             '_flash_backward': 'flash_attention_bwd'}

    def __init__(self, port):
        from counterfactualworldmodels_tpu_torch.ops import flash_attention
        self.fa, self.launches = flash_attention, port.kernels.LAUNCHES
        self.shapes = {k: [] for k in self.NAMES.values()}

    def __enter__(self):
        self.saved = {fn: getattr(self.fa, fn) for fn in self.NAMES}
        for fn, key in self.NAMES.items():
            setattr(self.fa, fn, self._spy(self.saved[fn], key))
        return self

    def _spy(self, fn, key):
        def spied(q, k, *args):
            before = self.launches[key]
            out = fn(q, k, *args)
            if self.launches[key] > before:
                self.shapes[key].append(list(q.shape[:3]) +
                                        [k.shape[2], q.shape[3]])
            return out
        return spied

    def __exit__(self, *exc):
        for fn, f in self.saved.items():
            setattr(self.fa, fn, f)

    def counted(self):
        """{kernel: {shape as text: launches}}."""
        out = {}
        for key, shapes in self.shapes.items():
            for s in shapes:
                d = out.setdefault(key, {})
                d[str(s)] = d.get(str(s), 0) + 1
        return out


def _rel_err(got, ref):
    """max |got - ref| over every tensor, over the largest |ref|."""
    err = max(max_err(got[k], ref[k]) for k in ref)
    return err / max(float(v.float().abs().max()) for v in ref.values())


def tp_world_one(torch, port, rec, smi):
    """(a) a process group of one rank over NCCL, mesh {'dp': 1, 'tp': 1}:
    make_sharded_train_step at phase 6's configuration through the tensor-
    parallel modules (the two Functions at size 1, the tp-aware clip),
    three steps bitwise make_train_step's, K5 72 / K6 36 a step."""
    import tempfile
    import torch.distributed as dist
    from counterfactualworldmodels_tpu_torch import parallel
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.parallel import tensor
    from counterfactualworldmodels_tpu_torch.training import train as T
    dev = torch.device('cuda')
    tmp = tempfile.mkdtemp(prefix='cwm_tp_')
    parallel.initialize_distributed(
        init_method='file://' + os.path.join(tmp, 'store'), world_size=1,
        rank=0, device=dev, timeout_s=300)
    try:
        cfg = vmae.large_4x4patch_2frames_1tube(dtype=torch.bfloat16,
                                                attn_impl='flash')
        opt = T.make_optimizer(learning_rate=1.5e-4, warmup_steps=1,
                               total_steps=100)
        _, n_vis = T.make_batch_masks(None, cfg, B_TRAIN, MASK_RATIO)

        def mask_fn(g, b):
            return T.make_batch_masks(g, cfg, b, MASK_RATIO)[0]

        rng = np.random.RandomState(0)
        base = rng.rand(B_TRAIN, 1, 3, 224, 224).astype(np.float32)
        clips = [torch.from_numpy(np.concatenate(
            [base, np.roll(base, tuple(rng.randint(-8, 9, 2)),
                           axis=(-2, -1))], 1)).to(dev) for _ in range(3)]
        mesh = parallel.make_mesh({'dp': 1, 'tp': 1})
        units = []

        def plain(state):
            return T.make_train_step(cfg, opt, n_vis, remat=True,
                                     mask_fn=mask_fn, device=dev), state

        def sharded(state):
            step, shard_state, _ = T.make_sharded_train_step(
                cfg, opt, mesh, n_vis, remat=True, mask_fn=mask_fn,
                device=dev)
            state = shard_state(state)
            units.extend(type(m).__name__ for m in state.model.modules()
                         if type(m) in tensor.TP_CLASSES.values())
            return step, state

        runs = {name: _vmae_steps(torch, T, cfg, opt, make, clips, port)
                for name, make in (('make_train_step', plain),
                                   ('make_sharded_train_step tp', sharded))}
        torch.cuda.empty_cache()
        depth = cfg.encoder_depth + cfg.decoder_depth
        want = dict({k: 0 for k in port.kernels.LAUNCHES},
                    flash_attention_lse=2 * depth, flash_attention_bwd=depth)
        (lp, np_, _), (ls, ns, launches) = (runs['make_train_step'],
                                           runs['make_sharded_train_step tp'])
        out = dict(backend=dist.get_backend(), losses=ls, plain_losses=lp,
                   grad_norms=ns, plain_grad_norms=np_,
                   launches_per_step=launches, tp_modules=len(units),
                   bitwise=ls == lp and ns == np_, card=smi)
        out['ok'] = (out['bitwise'] and all(x == want for x in launches)
                     and len(units) == 2 * depth)
        log('9a tp world 1', json.dumps(out))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rec['phase9_world1'] = out
    if not out['ok']:
        raise AssertionError('tp = 1 over NCCL is not make_train_step')
    return out


def _tp_vmae(torch, port, dtype, steps, mesh=None):
    """The depth-cut ViT-L VMAE step (TP_DEPTH, batch 4, remat) from
    seed-0 weights for ``steps`` steps, tensor-parallel over ``mesh`` or
    single-process: per-step [loss, grad_norm], launches and kernel shapes,
    sec/step of all but the first step, and the gathered parameters."""
    import dataclasses
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.parallel import tensor
    from counterfactualworldmodels_tpu_torch.training import train as T
    dev = torch.device('cuda')
    cfg = dataclasses.replace(vmae.large_4x4patch_2frames_1tube(
        dtype=dtype, attn_impl='flash'), **TP_DEPTH)
    opt = T.make_optimizer(learning_rate=1.5e-4, warmup_steps=1,
                           total_steps=100)
    state = T.init_train_state(cfg, opt, seed=0, device=dev)
    _, n_vis = T.make_batch_masks(None, cfg, B_TRAIN, MASK_RATIO)
    if mesh is None:
        step = T.make_train_step(cfg, opt, n_vis, remat=True, device=dev)
    else:
        step, shard_state, _ = T.make_sharded_train_step(
            cfg, opt, mesh, n_vis, remat=True, device=dev)
        state = shard_state(state)
    rng = np.random.RandomState(0)
    base = rng.rand(B_TRAIN, 1, 3, 224, 224).astype(np.float32)
    metrics, launches, shapes, times = [], [], [], []
    for i in range(steps):
        x = torch.from_numpy(np.concatenate(
            [base, np.roll(base, tuple(rng.randint(-8, 9, 2)),
                           axis=(-2, -1))], 1)).to(dev)
        mask = T.make_batch_masks(torch.Generator().manual_seed(i), cfg,
                                  B_TRAIN, MASK_RATIO)[0]
        torch.cuda.synchronize()
        port.kernels.reset_launches()
        t0 = time.perf_counter()
        with _ShapeSpy(port) as spy:
            state, m = step(state, x, mask)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append([float(m['loss']), float(m['grad_norm'])])
        launches.append(dict(port.kernels.LAUNCHES))
        shapes.append(spy.counted())
    params = {k: v.detach().cpu() for k, v in
              tensor.full_state_dict(state.model).items()}
    return dict(metrics=metrics, launches=launches, shapes=shapes,
                sec_per_step=float(np.mean(times[1:])) if steps > 1 else None,
                params=params, state=state, step=step, cfg=cfg)


def _allreduce_share(torch, run):
    """One more step with every dist.all_reduce timed between
    synchronizations: the share of the (instrumented) step spent in
    them."""
    import torch.distributed as dist
    from counterfactualworldmodels_tpu_torch.training import train as T
    dev = torch.device('cuda')
    spent = [0.0, 0]
    real = dist.all_reduce

    def timed(t, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    cfg = run['cfg']
    x = torch.rand(B_TRAIN, 2, 3, 224, 224, device=dev)
    mask = T.make_batch_masks(torch.Generator().manual_seed(99), cfg,
                              B_TRAIN, MASK_RATIO)[0]
    torch.cuda.synchronize()
    dist.all_reduce = timed
    try:
        t0 = time.perf_counter()
        run['step'](run['state'], x, mask)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        dist.all_reduce = real
    return dict(step_s=total, all_reduce_s=spent[0], all_reduces=spent[1],
                share=spent[0] / total)


def _tp_small(torch, mesh=None):
    """Three f32 steps of the ChannelMAE and conjoined models of
    tests/test_parallel.py on the card (tensor-parallel over ``mesh`` or
    single-process): per-step [loss, grad_norm] and the gathered
    parameters."""
    from counterfactualworldmodels_tpu_torch.models import cmae, conjoined
    from counterfactualworldmodels_tpu_torch.parallel import tensor
    from counterfactualworldmodels_tpu_torch.training import train as T
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    rng = np.random.RandomState(2)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    out = {}
    opt = T.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    model = cmae.ChannelMae(**TP_CMAE, attn_impl='flash', device=dev)
    state = T.init_cmae_train_state(model, opt, seed=1)
    mask = np.ones((4, 4), bool)
    mask[:, :2] = False
    args = (t(rng.rand(4, 3, 32, 32).astype(np.float32)), t(mask))
    if mesh is None:
        step = T.make_cmae_train_step(model, opt, 2, (2,), remat=False)
    else:
        step, shard_state, _ = T.make_sharded_cmae_train_step(
            model, opt, mesh, 2, (2,), remat=False)
        state = shard_state(state)
    runs = [('cmae', state, step, args)]
    model = conjoined.ConjoinedVMAE(
        main=conjoined.StreamSpec(**TP_CONJ['main']),
        context=conjoined.StreamSpec(**TP_CONJ['context']),
        conjoin_encoder_layers=((0, 0), (1, 1)),
        conjoin_decoder_layers=((0, 0),), attn_impl='flash', device=dev)
    model.load_state_dict(weights.init_conjoined_state_dict(
        model, torch.Generator(device=dev).manual_seed(2)), strict=True)
    state = T.TrainState(0, model, opt.init(model.parameters()))
    mask = np.ones((4, 32), bool)
    mask[:, :18] = False
    args = (t(rng.rand(4, 3, 2, 32, 32).astype(np.float32)), t(mask),
            t(rng.randn(4, 6, 32, 1, 1).astype(np.float32)),
            t(np.zeros((4, 4), bool)))
    if mesh is None:
        step = T.make_conjoined_train_step(model, opt, 18, 4, remat=False)
    else:
        step, shard_state, _ = T.make_sharded_conjoined_train_step(
            model, opt, mesh, 18, 4, remat=False)
        state = shard_state(state)
    runs.append(('conjoined', state, step, args))
    for name, state, step, args in runs:
        metrics = []
        for _ in range(3):
            state, m = step(state, *args)
            metrics.append([float(m['loss']), float(m['grad_norm'])])
        out[name] = dict(metrics=metrics, params={
            k: v.detach().cpu() for k, v in
            tensor.full_state_dict(state.model).items()})
    return out


def _stack_inputs(torch, dtype):
    """ViT-L encoder blocks (STACK_DEPTH) from seed 3, stacked, and the
    tokens: [1, 3136, 1024] for tp and sp, [2, 3136, 1024] for pp."""
    import dataclasses
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.parallel import tensor
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    cfg = dataclasses.replace(vmae.large_4x4patch_2frames_1tube(
        dtype=dtype, attn_impl='flash'), encoder_depth=STACK_DEPTH,
        decoder_depth=0)
    sd = weights.init_vmae_state_dict(
        cfg, torch.Generator(device=dev).manual_seed(3))
    enc = {k[len('encoder.'):]: v for k, v in sd.items()
           if k.startswith('encoder.')}
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, STACK_TOKENS, cfg.encoder_embed_dim, generator=g,
                    device=dev).to(dtype)
    return cfg, enc, tensor.stack_block_params(enc, STACK_DEPTH), x


def _stacks(torch, port, meshes=None):
    """The tp, sp and pp forwards (or, without meshes, the sequential
    stack: models/layers.Block one layer after another on the card) in f32
    and bf16, with each run's launches and shapes and the bf16 ms."""
    from counterfactualworldmodels_tpu_torch import parallel
    from counterfactualworldmodels_tpu_torch.parallel import tensor
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split('.')[1]
        cfg, enc, stacked, x = _stack_inputs(torch, dtype)
        if meshes is None:
            block = tensor.template_block(stacked, cfg.encoder_embed_dim,
                                          cfg.encoder_num_heads, None, dtype)
            runs = {'tp': lambda: tensor.run_layers(block, stacked, x[:1]),
                    'pp': lambda: tensor.run_layers(block, stacked, x)}
            runs['sp'] = runs['tp']
        else:
            runs = {}
            for how, make, kw in (
                    ('tp', parallel.make_tp_encoder_forward, {}),
                    ('sp', parallel.make_sp_encoder_forward, {}),
                    ('pp', parallel.make_pp_encoder_forward,
                     dict(num_microbatches=2))):
                fwd, shard = make(cfg, meshes[how], **kw)
                p = shard(enc)
                xin = x if how == 'pp' else x[:1]
                runs[how] = (lambda fwd=fwd, p=p, xin=xin: fwd(p, xin))
        for how, fn in runs.items():
            with torch.no_grad():
                fn()                                  # warm-up
                torch.cuda.synchronize()
                port.kernels.reset_launches()
                t0 = time.perf_counter()
                with _ShapeSpy(port) as spy:
                    y = fn()
                    torch.cuda.synchronize()
            out[f'{how} {dn}'] = dict(
                out=y.float().cpu(), ms=(time.perf_counter() - t0) * 1e3,
                launches=dict(port.kernels.LAUNCHES), shapes=spy.counted())
        del stacked, enc, x
        torch.cuda.empty_cache()
    return out


def _tp_ranks_work(rank, tmp):
    """One of two gloo ranks sharing the card: (b) the tp = 2 VMAE step at
    ViT-L widths (f32 check, bf16 times, the all-reduce share) and the
    small ChannelMAE and conjoined steps, (c) the tp, sp and pp stacks,
    (d) train_vmae --tp 2 with a checkpoint; results saved for the
    parent."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    import counterfactualworldmodels_tpu_torch as port
    from counterfactualworldmodels_tpu_torch import parallel
    from counterfactualworldmodels_tpu_torch.training import train_vmae
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        parallel.initialize_distributed(
            init_method='file://' + os.path.join(tmp, 'store'),
            world_size=2, rank=rank, backend='gloo', device='cuda',
            timeout_s=600)
        mesh = parallel.make_mesh({'dp': 1, 'tp': 2})
        res = {'f32': _tp_vmae(torch, port, torch.float32, 2, mesh)}
        bf = _tp_vmae(torch, port, torch.bfloat16, 4, mesh)
        bf['all_reduce'] = _allreduce_share(torch, bf)
        res['bf16'] = bf
        for r in ('f32', 'bf16'):
            for k in ('state', 'step', 'cfg'):
                res[r].pop(k)
        res['bf16'].pop('params')
        torch.cuda.empty_cache()
        res['small'] = _tp_small(torch, mesh)
        res['stacks'] = _stacks(torch, port, {
            how: parallel.make_mesh({how: 2}) for how in ('tp', 'sp', 'pp')})
        t0 = time.perf_counter()
        res['trainer'] = train_vmae.main(TP_TRAINER + [
            '--tp', '2', '--steps', '2', '--checkpoint-dir',
            os.path.join(tmp, 'ck')])
        res['trainer_s'] = time.perf_counter() - t0
        torch.save(res, os.path.join(tmp, f'rank{rank}.pt'))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def model_sharding(torch, port, rec, smi):
    """(b)-(d) over two gloo ranks sharing the card (NCCL refuses two
    ranks on one device), against the single-process paths on the card
    computed first: (b) the VMAE step at ViT-L 4x4 @224 widths (TP_DEPTH
    blocks), two f32 steps (TF32 off) within TOL_TP of the single-process
    step (losses, grad_norm, the gathered parameters over their largest
    magnitude), four bf16 steps (sec/step of the last three, the share of
    a step spent in the gloo all-reduces), K5/K6 at the halved heads; the
    small ChannelMAE and conjoined steps (f32, three steps, 1e-4); (c) the
    tp, sp and pp encoder forwards (STACK_DEPTH ViT-L blocks, the
    3136-token prefix; pp 2 stages x 2 microbatches) against the
    sequential stack (f32 within TOL_TP, bf16 within REL_BF16 of the
    largest magnitude), K1 at [1,8,3136,3136,64] for tp and
    [1,16,1568,3136,64] for sp; (d) train_vmae --tp 2 for two steps with a
    checkpoint, resumed here at tp = 1: the third loss within 1e-5 of an
    uninterrupted tp = 1 run's."""
    import multiprocessing
    import tempfile
    from counterfactualworldmodels_tpu_torch.training import train_vmae
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix='cwm_tp2_')
    try:
        t0 = time.perf_counter()
        ref = _tp_vmae(torch, port, torch.float32, 2)
        for k in ('state', 'step'):
            ref.pop(k)
        torch.cuda.empty_cache()
        ref_small = _tp_small(torch)
        ref_stacks = _stacks(torch, port)
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0
        ctx = multiprocessing.get_context('spawn')
        procs = [ctx.Process(target=_tp_ranks_work, args=(r, tmp))
                 for r in range(2)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(900)
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        errs = []
        for r in range(2):
            path = os.path.join(tmp, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f.read())
        if alive or errs or any(pr.exitcode for pr in procs):
            raise AssertionError('the gloo ranks failed: alive '
                                 f'{len(alive)}\n' + '\n'.join(errs))
        ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                            weights_only=False) for r in range(2)]
        out = dict(card=smi, depth=TP_DEPTH, stack_depth=STACK_DEPTH,
                   references_s=ref_s, ranks_s=time.perf_counter() - t0)
        # (b) the f32 check and the bf16 run
        zeros = {k: 0 for k in port.kernels.LAUNCHES}
        depth = TP_DEPTH['encoder_depth'] + TP_DEPTH['decoder_depth']
        want = dict(zeros, flash_attention_lse=2 * depth,
                    flash_attention_bwd=depth)
        n_enc = int(TP_DEPTH['encoder_depth'])
        want_shapes = {
            'flash_attention_lse': {f'[{B_TRAIN}, 8, 3450, 3450, 64]':
                                    2 * n_enc,
                                    f'[{B_TRAIN}, 4, 6272, 6272, 64]':
                                    2 * (depth - n_enc)},
            'flash_attention_bwd': {f'[{B_TRAIN}, 8, 3450, 3450, 64]': n_enc,
                                    f'[{B_TRAIN}, 4, 6272, 6272, 64]':
                                    depth - n_enc}}
        b = {}
        for r, rk in enumerate(ranks):
            f32, bf = rk['f32'], rk['bf16']
            rel = max(abs(a - c) / abs(c) for g, h in
                      zip(f32['metrics'], ref['metrics'])
                      for a, c in zip(g, h))
            b[f'rank{r}'] = dict(
                f32_metrics=f32['metrics'], metrics_rel_err=rel,
                params_rel_err=_rel_err(f32['params'], ref['params']),
                bf16_metrics=bf['metrics'], sec_per_step=bf['sec_per_step'],
                all_reduce=bf['all_reduce'], launches=bf['launches'][-1],
                shapes=bf['shapes'][-1])
        b['single_f32_metrics'] = ref['metrics']
        b['ok'] = all(
            b[f'rank{r}']['metrics_rel_err'] <= TOL_TP
            and b[f'rank{r}']['params_rel_err'] <= TOL_TP
            and all(x == want for x in ranks[r]['bf16']['launches'])
            and all(s == want_shapes for s in ranks[r]['bf16']['shapes'])
            and all(math.isfinite(v) for m in ranks[r]['bf16']['metrics']
                    for v in m) for r in range(2))
        log('9 tp=2 step', json.dumps(b))
        small = {}
        for name in ('cmae', 'conjoined'):
            rf = ref_small[name]
            small[name] = dict(
                metrics=ranks[0]['small'][name]['metrics'],
                single_metrics=rf['metrics'],
                metrics_rel_err=max(
                    abs(a - c) / abs(c) for rk in ranks for g, h in
                    zip(rk['small'][name]['metrics'], rf['metrics'])
                    for a, c in zip(g, h)),
                params_max_err=max(
                    max_err(rk['small'][name]['params'][k], v)
                    for rk in ranks for k, v in rf['params'].items()))
            small[name]['ok'] = (small[name]['metrics_rel_err'] <= 1e-4
                                 and small[name]['params_max_err'] <= 1e-4)
        log('9 tp=2 small', json.dumps(small))
        # (c) the stacks
        c = {}
        want_k1 = {'tp': {'[1, 8, 3136, 3136, 64]': STACK_DEPTH},
                   'sp': {'[1, 16, 1568, 3136, 64]': STACK_DEPTH},
                   'pp': {'[1, 16, 3136, 3136, 64]': STACK_DEPTH}}
        for key, rr in ref_stacks.items():
            how, dn = key.split()
            tol = TOL_TP if dn == 'float32' else REL_BF16
            scale = float(rr['out'].abs().max())
            errs_ = [max_err(rk['stacks'][key]['out'], rr['out'])
                     for rk in ranks]
            got = ranks[0]['stacks'][key]
            c[key] = dict(max_abs_err=max(errs_), tol=tol * scale,
                          ms=got['ms'], sequential_ms=rr['ms'],
                          launches=got['launches'], shapes=got['shapes'])
            shapes_ok = all(
                rk['stacks'][key]['shapes'].get('flash_attention')
                == want_k1[how] for rk in ranks)
            c[key]['ok'] = max(errs_) <= tol * scale and shapes_ok
        log('9 stacks', json.dumps(c))
        # (d) the tp = 2 checkpoint resumed at tp = 1
        d = dict(tp2=ranks[0]['trainer'], tp2_s=ranks[0]['trainer_s'])
        d['tp1'] = train_vmae.main(TP_TRAINER + ['--steps', '3'])
        d['resumed_tp1'] = train_vmae.main(TP_TRAINER + [
            '--steps', '3', '--checkpoint-dir', os.path.join(tmp, 'ck')])
        loss3, ref3 = d['resumed_tp1'][-1]['loss'], d['tp1'][-1]['loss']
        d['rel_err'] = abs(loss3 - ref3) / abs(ref3)
        d['ok'] = ([r['step'] for r in d['resumed_tp1']] == [3]
                   and d['rel_err'] <= 1e-5)
        log('9 trainer', json.dumps(d))
        out.update(b=b, small=small, c=c, d=d)
        out['ok'] = (b['ok'] and all(v['ok'] for v in small.values())
                     and all(v['ok'] for v in c.values()) and d['ok'])
        rec['phase9'] = out
        if not out['ok']:
            raise AssertionError('model sharding on two gloo ranks failed')
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the remaining entry points (scripts/) at full width
# ---------------------------------------------------------------------------

def _varies(img):
    """Whether a decoded image holds more than one colour (a constant RGB
    map still differs between its channels)."""
    px = img.reshape(img.shape[0] * img.shape[1], -1)
    return bool((px != px[0]).any())


def _launch_delta(port, fn):
    """(fn(), the kernel launches it made)."""
    port.kernels.reset_launches()
    result = fn()
    return result, engine_launches(port)


def structure_phase(torch, port, rec, smi):
    """(a) Structure extraction (scripts/extract_structure) at --model
    paper (the Soft ChannelMAE: ViT-B encoder 12 blocks, decoder 4, 224 px,
    32 px patches, f32): 100 Adam steps of ``extract_structure`` timed, K5
    and K6 counted per step (16 each: the gradient reaches the logits
    through every attention layer, f32 routes), the visibility falling and
    the losses finite; then ``main(argv)`` at the same defaults (both PNGs,
    decoded here, and the JSON); the tiny configuration for 10 steps on
    the card and on the CPU, per-step losses within 1e-4 relative."""
    from counterfactualworldmodels_tpu_torch.scripts import (
        extract_structure as es)
    from counterfactualworldmodels_tpu_torch.utils import weights
    dev = torch.device('cuda')
    steps = 100
    model = es.build_model('paper', 224, 32, dev)
    model.load_state_dict(weights.init_channel_mae_state_dict(
        model, torch.Generator(device=dev).manual_seed(0)), strict=True)
    model.eval()
    x = torch.from_numpy(es.synthetic_image(224)).to(dev)
    es.extract_structure(model, x, 2, 0.1, 0.5)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (logits, hist), launches = _launch_delta(
        port, lambda: es.extract_structure(model, x, steps, 0.1, 0.5))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    depth = len(model.encoder.blocks) + len(model.decoder.blocks)
    want = {k: 0 for k in engine_launches(port)}
    want.update(flash_attention_lse=depth * steps,
                flash_attention_bwd=depth * steps)
    a = dict(config='SoftInputChannelMae paper (768d x 12 / 384d x 4), '
                    '224 px, 32 px patches, f32', steps=steps,
             steps_per_s=steps / sec, ms_per_step=sec * 1e3 / steps,
             launches_per_step={k: v / steps for k, v in launches.items()},
             initial=hist[0], final=hist[-1], card=smi)
    a['ok'] = bool(launches == want and hist[-1][2] < hist[0][2]
               and all(math.isfinite(v) for h in hist for v in h))
    log('10a structure', json.dumps(a))

    tmp = tempfile.mkdtemp(prefix='cwm_structure_')
    try:
        report, main_launches = _launch_delta(port, lambda: es.main(
            ['--model', 'paper', '--out', tmp]))
        with open(os.path.join(tmp, 'structure_mask.png'), 'rb') as f:
            mask = png_decode(f.read())
        with open(os.path.join(tmp, 'structure_recon.png'), 'rb') as f:
            recon = png_decode(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_main = dict(want, flash_attention=depth)  # + the render's forward
    a['main'] = dict(report=report, launches=main_launches,
                     mask_shape=list(mask.shape),
                     recon_shape=list(recon.shape),
                     mask_levels=int(np.unique(mask).size),
                     recon_varies=_varies(recon))
    # not constant where this run's own maps, quantised, are not
    vis_img, recon_arr = es.render(model, x, logits)
    q_vis, q_recon = ((np.clip(v, 0, 1) * 255).astype(np.uint8)
                      for v in (vis_img, recon_arr))
    a['main']['ok'] = bool(main_launches == want_main
                       and mask.shape == (224, 224)
                       and recon.shape == (224, 224, 3)
                       and (not _varies(q_vis) or _varies(mask))
                       and (not _varies(q_recon) or _varies(recon))
                       and report['final']['visibility']
                       < report['initial']['visibility'])

    tiny_c = es.build_model('tiny', 224, 32, 'cpu')
    sd = weights.init_channel_mae_state_dict(tiny_c,
                                             torch.Generator().manual_seed(0))
    tiny_c.load_state_dict(sd, strict=True)
    tiny_g = es.build_model('tiny', 224, 32, dev)
    tiny_g.load_state_dict(sd, strict=True)
    _, hc = es.extract_structure(tiny_c, x.cpu(), 10, 0.1, 0.5)
    _, hg = es.extract_structure(tiny_g, x, 10, 0.1, 0.5)
    rel = float(np.max(np.abs(np.asarray(hg) - np.asarray(hc))
                       / np.abs(np.asarray(hc))))
    a['tiny_card_vs_cpu'] = dict(steps=10, max_rel=rel, ok=bool(rel <= 1e-4))
    log('10a structure', json.dumps({k: a[k] for k in
                                     ('main', 'tiny_card_vs_cpu')}))
    rec['phase10a'] = a
    if not (a['ok'] and a['main']['ok'] and a['tiny_card_vs_cpu']['ok']):
        raise AssertionError(f'structure extraction failed: {a}')
    return a


def shards_phase(torch, port, rec, smi):
    """(b) The shard writer (scripts/make_shards) through ``main(argv)``:
    a seeded uint8 .npy of 64 clips of 2x224x224x3 with a [6, 4000] IMU
    stream, --clips-per-shard 32: two shards and two sidecars, read back
    through ``data.shards.open_loader`` (the native loader) bitwise the
    clips the script samples (``sample_clips`` on the same draws), the
    sidecars the clips' IMU windows; clips written per second. Without cv2
    and PIL on this machine, a source that needs a resize raises
    SystemExit naming them."""
    from counterfactualworldmodels_tpu_torch.data import shards
    from counterfactualworldmodels_tpu_torch.scripts import make_shards as ms
    tmp = tempfile.mkdtemp(prefix='cwm_make_shards_')
    try:
        rng = np.random.RandomState(12)
        clips = rng.randint(0, 256, (64, 2, 224, 224, 3), dtype=np.uint8)
        imu = (rng.randn(6, 4000) * 0.1).astype(np.float32)
        src = os.path.join(tmp, 'clips.npy')
        np.save(src, clips)
        np.save(src + '.imu.npy', imu)
        out_dir = os.path.join(tmp, 'out')
        t0 = time.perf_counter()
        written = ms.main([src, '--out-dir', out_dir, '--size', '224',
                           '--clips-per-shard', '32', '--imu-suffix',
                           '.imu.npy'])
        sec = time.perf_counter() - t0
        # the clips and windows the script samples, on the same draws
        draws = np.random.RandomState(0)
        want_c, want_i = [], []
        for c in clips:
            cs, ws = ms.sample_clips(c, draws, num_frames=2, gap=4, size=224,
                                     k=16, imu=imu, imu_len=400, fps=30.0)
            want_c += cs
            want_i += ws
        want_c, want_i = np.stack(want_c), np.stack(want_i)
        got_c, got_i, loaders = [], [], []
        for path in written:
            loader = shards.open_loader(path, batch_size=32, shuffle=False,
                                        out_dtype='u8')
            loaders.append(type(loader).__name__)
            got_c.append(np.array(loader.next_batch()))
            loader.close()
            got_i.append(np.asarray(shards.read_imu_sidecar(path)))
        got_c, got_i = np.concatenate(got_c), np.concatenate(got_i)
        b = dict(shards=[os.path.basename(p) for p in written],
                 sidecars=[os.path.exists(shards.imu_sidecar_path(p))
                           for p in written],
                 loaders=loaders, seconds=sec, clips_per_s=64 / sec,
                 shard_mb=sum(os.path.getsize(p) for p in written) / 2 ** 20,
                 clips_bitwise=bool(np.array_equal(got_c, want_c)),
                 clips_are_the_source=bool(np.array_equal(got_c, clips)),
                 imu_bitwise=bool(np.array_equal(got_i, want_i)), card=smi)
        missing = []
        for name in ('cv2', 'PIL'):
            try:
                __import__(name)
            except ImportError:
                missing.append(name)
        b['missing_packages'] = missing
        if len(missing) == 2:
            odd = os.path.join(tmp, 'odd.npy')
            np.save(odd, clips[:1, :, :100, :120])
            try:
                ms.main([odd, '--out-dir', os.path.join(tmp, 'odd'),
                         '--size', '224'])
                b['resize_raises'] = False
            except SystemExit as e:
                b['resize_raises'] = 'cv2 or PIL' in str(e)
        b['ok'] = (len(written) == 2 and all(b['sidecars'])
                   and loaders == ['NativeClipLoader'] * 2
                   and b['clips_bitwise'] and b['clips_are_the_source']
                   and b['imu_bitwise'] and b.get('resize_raises', True))
        log('10b shards', json.dumps(b))
        rec['phase10b'] = b
        if not b['ok']:
            raise AssertionError(f'the shard writer failed: {b}')
        return b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fidelity_phase(torch, port, rec, smi):
    """(c) The engine fidelity report (scripts/fidelity_report) through
    ``main(argv)``: --model large --samples 8 --max-images 2 --raft-iters
    24 at the default rungs, bf16, the f32 decomposition on the first
    image and --conjoined flagship; the JSON copied under chiprun_out/.
    Each leg's ms and its K1 / K2 / lookup launches, asserted against the
    code's counts: an exact VMAE leg K1 36 / lookup 24, an engine leg K1
    36 / K2 36 (24 of them packed in bf16) / lookup 24 (phase 5's counts;
    S sits in the batch), the
    conjoined legs as phase 5d's code gives them with the IMU given."""
    from counterfactualworldmodels_tpu_torch.models import conjoined as C
    from counterfactualworldmodels_tpu_torch.scripts import (
        fidelity_report as fr)
    out_json = os.path.join(HERE, 'chiprun_out', 'fidelity_report.json')
    t0 = time.perf_counter()
    report, total = _launch_delta(port, lambda: fr.main(
        ['--model', 'large', '--samples', '8', '--max-images', '2',
         '--raft-iters', '24', '--conjoined', 'flagship', '--out',
         out_json]))
    sec = time.perf_counter() - t0
    zero = {k: 0 for k in engine_launches(port)}
    exact = dict(zero, flash_attention=36, window_lookup=24)
    # an engine leg: K2 in 24 encoder blocks (packed in bf16) and 12
    # decoder blocks
    fast = {dtype: dict(zero, flash_attention=36,
                        **suffix_k2(24, 12, packed=dtype == 'bf16'),
                        window_lookup=24) for dtype in ('bf16', 'f32')}
    imu = C.imu400_base_4x4patch_2frames_1tube(device='meta')
    want = {'exact': exact, 'exact f32': exact,
            'conjoined exact': dict(zero, **imu_launches(
                imu, imu, 24, 0, 0, 0, exact_chunks=1)),
            'conjoined fast': dict(zero, **imu_launches(imu, imu, 24, 0, 1,
                                                        1, packed=True))}
    bad = [g['name'] for g in report['legs']
           if strip_norm(g['launches']) != want.get(
               g['name'], fast['f32' if g['name'].endswith(' f32')
                               else 'bf16'])]
    summed = {k: sum(g['launches'][k] for g in report['legs'])
              for k in zero}
    rungs = [k for k in report['per_image'][0]
             if isinstance(report['per_image'][0][k], dict)
             and 'segment' in report['per_image'][0][k]]
    c = dict(seconds=sec, out=os.path.relpath(out_json, HERE),
             images=report['images'],
             **{k: report[k] for k in (
                 'min_flow_corr', 'min_video_corr', 'min_segment_spearman',
                 'min_movability_pearson', 'max_video_abs_err')},
             rungs={r: dict(
                 min_segment_spearman=min(p[r]['segment']['spearman']
                                          for p in report['per_image']),
                 min_movability_pearson=min(p[r]['movability']['pearson']
                                            for p in report['per_image']),
                 min_flow_corr=min(p[r]['flow_corr']
                                   for p in report['per_image']),
                 max_video_abs_err=max(p[r]['video_max_abs_err']
                                       for p in report['per_image']))
                 for r in rungs},
             decomposition={k: v['flow_mean_rel_dev'] for k, v in
                            report.get('bf16_vs_isolation_decomposition',
                                       {}).items()
                            if isinstance(v, dict)},
             conjoined={k: report['conjoined'][k]
                        for k in ('config', 'min_flow_corr',
                                  'min_video_corr')},
             legs=[dict(name=g['name'], ms=g['ms'], launches={
                 k: v for k, v in g['launches'].items() if v})
                 for g in report['legs']],
             launches_not_as_the_code_gives=bad, card=smi)
    numbers = [c[k] for k in ('min_flow_corr', 'min_video_corr',
                              'min_segment_spearman',
                              'min_movability_pearson', 'max_video_abs_err')]
    c['ok'] = (not bad and summed == total and report['backend'] == 'cuda'
               and len(report['per_image']) == 2
               and all(math.isfinite(v) for v in numbers)
               and len(c['decomposition']) > 4
               and len(report['conjoined']['per_image']) == 2)
    c['legs_of'] = {g['name']: g['launches'] for g in report['legs']}
    log('10c fidelity', json.dumps({k: v for k, v in c.items()
                                    if k != 'legs_of'}))
    rec['phase10c'] = c
    if not c['ok']:
        raise AssertionError(f'the fidelity report failed: {bad}')
    return c


def demo_phase(torch, port, rec, smi):
    """(d) The demo (scripts/demo_counterfactuals): ``build_generator`` and
    ``run_demo`` as its ``main`` calls them, --model base at its defaults
    (ViT-B 8x8, RAFT-12, S = 8), then --model large --movability; each
    step's ms and launches (asserted where the code fixes them: the
    factual prediction is a cold scene's prefix and suffix, the
    counterfactual and the motion map each a warm suffix and one RAFT-12;
    movability one new scene's prefix); every PNG decoded here: its shape,
    and not constant where its array is not."""
    from counterfactualworldmodels_tpu_torch.scripts import (
        demo_counterfactuals as dm)
    dev = torch.device('cuda')
    zero = {k: 0 for k in engine_launches(port)}
    out = dict(card=smi)
    tmp = tempfile.mkdtemp(prefix='cwm_demo_')
    try:
        for name, movability in (('base', False), ('large', True)):
            G = dm.build_generator(name, None, 12, dev)
            img = np.random.RandomState(0).rand(224, 224, 3).astype(
                np.float32)
            x = torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(dev)
            steps = []
            odir = os.path.join(tmp, name)
            t0 = time.perf_counter()
            arrays = dm.run_demo(G, x, odir, 8, movability, 12, log=steps)
            sec = time.perf_counter() - t0
            m = G.predictor
            prefix = m.encoder_depth + m.decoder_depth
            k2 = suffix_k2(m.encoder_depth, m.decoder_depth, packed=True)
            want = {'factual': dict(zero, flash_attention=prefix, **k2),
                    'counterfactual': dict(zero, **k2, window_lookup=12),
                    'motion map': dict(zero, **k2, window_lookup=12)}
            bad = [s['name'] for s in steps
                   if s['name'] in want
                   and strip_norm(s['launches']) != want[s['name']]]
            for s in steps:
                if s['name'] == 'movability':
                    lm = s['launches']
                    if not (lm['flash_attention'] == prefix
                            and lm['flash_attention_prefix'] % prefix == 0
                            and lm['window_lookup'] % 12 == 0
                            and lm['window_lookup'] > 0):
                        bad.append('movability')
            pngs = {}
            for stem, arr in arrays.items():
                if stem in ('flows', 'flow_samples'):
                    continue
                with open(os.path.join(odir, stem + '.png'), 'rb') as f:
                    img = png_decode(f.read())
                side = 56 if stem == 'motion_covariance_center' else 224
                # an RGB image varies in the PNG where it varies quantised;
                # a map's normalisation spreads any range over the colours
                varied = (_varies((np.clip(arr, 0, 1) * 255).astype(np.uint8))
                          if arr.ndim == 3 else bool(np.ptp(arr) > 0))
                pngs[stem] = dict(
                    shape=list(img.shape), finite=bool(np.isfinite(arr).all()),
                    array_range=float(np.ptp(arr)),
                    png_colours=int(np.unique(img.reshape(-1, 3),
                                              axis=0).shape[0]))
                pngs[stem]['ok'] = bool(
                    img.shape == (side, side, 3) and pngs[stem]['finite']
                    and varied == _varies(img))
            d = dict(seconds=sec, steps=[dict(
                name=s['name'], ms=s['ms'],
                launches={k: v for k, v in s['launches'].items() if v})
                for s in steps], launches_not_as_the_code_gives=bad,
                pngs=pngs, launches=dict(zero, **{
                    k: sum(s['launches'][k] for s in steps) for k in zero}))
            d['ok'] = (not bad and all(p['ok'] for p in pngs.values())
                       and len(pngs) == (6 if movability else 5))
            out[name] = d
            log('10d demo', f'{name}: ' + json.dumps(d))
            del G
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec['phase10d'] = out
    if not (out['base']['ok'] and out['large']['ok']):
        raise AssertionError('the demo failed')
    return out


# ---------------------------------------------------------------------------
# phase 11: the measurement entry points
# ---------------------------------------------------------------------------

# each cut of a script's default run, as the record lists it
PHASE11_REDUCTIONS = [
    'bench: CWM_BENCH_SBIG=64 (the S probe at 64 only; the script\'s '
    'default probes 64, 128 and 256)',
    'bench_sweep: --sizes 16 with CWM_BENCH_RUNGS=0 (one size, no ladder)',
    'latency_bench: --iters 20 (default 50)',
    'loadgen: --requests 32 (default 64)',
    'bench_train: CWM_TRAIN_BENCH_STEPS=2 (default 8)',
    'bench_loader: --clips 64 --seconds 0.5 --threads 1,4 (default 512 '
    'clips, 5 s a row, threads 1,2,4)',
]


def _run_script(torch, main, argv, env=()):
    """An entry point's ``main(argv)`` with ``env`` set for the call:
    (what it returned, the JSON lines it printed, seconds). The printed
    lines must parse."""
    import contextlib
    import gc
    import io
    env = dict(env)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
             if ln.startswith('{')]
    if not lines:
        raise AssertionError(f'{main.__module__} printed no JSON line')
    gc.collect()
    torch.cuda.empty_cache()
    return out, lines, secs


def _finite_tree(v):
    if isinstance(v, dict):
        return all(_finite_tree(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_finite_tree(x) for x in v)
    return not isinstance(v, float) or math.isfinite(v)


def measurement_phase(torch, port, rec, smi):
    """11. The measurement entry points (``scripts/bench*``, the latency,
    first-request and load probes) through their ``main(argv)`` on the
    card at full width: the bench at ViT-L 4x4 + RAFT-24, S = 16, with the
    S probe at 64 and the rung ladder (K1 36, K2 36, lookup 24 a dispatch,
    asserted); the sweep at S = 16 (a child process); latency_bench --model
    large (the cold prediction K1 36, the warm click K2 36, the imu400
    click K2 16); serve_latency to prompt 16 (the first request K1 36 / K2
    36 / lookup 24, the rest K2 36 / lookup 24); loadgen at base 224;
    bench_conjoined at imu400 on both engines (fast K2 16, lookup 24; exact
    K2 0, lookup 24); bench_train's ten families (K5 / K6 a step: ViT-L
    72 / 36, accum 2 twice that, no remat 36 / 36, ChannelMAE 32 / 16,
    imu400 64 / 32, none for RAFT); bench_loader; bench_attention at S =
    16 (K1 and K2 once a call, within 2e-2 of the plain f32 output's
    largest magnitude). Every JSON line parses, holds finite numbers and a
    positive headline; the reductions are listed in the record."""
    from counterfactualworldmodels_tpu_torch.scripts import (
        bench, bench_attention, bench_conjoined, bench_loader, bench_sweep,
        bench_train, latency_bench, loadgen, serve_latency)
    zero = {k: 0 for k in port.kernels.LAUNCHES}
    out = dict(card=smi, reductions=PHASE11_REDUCTIONS, seconds={})
    rec['phase11'] = out                 # filled in as the scripts run
    bad = []

    def check(name, ok, detail):
        if not ok:
            bad.append(f'{name}: {detail}')

    def run(name, main, argv, env=()):
        r, lines, secs = _run_script(torch, main, argv, env)
        out['seconds'][name] = secs
        check(name, all(_finite_tree(ln) for ln in lines),
              'a number that is not finite')
        log('11 measurement', f'{name} in {secs:.1f}s: '
                              + json.dumps(lines[-1])[:1500])
        return r, lines

    # the dispatch: the library-default rung at ViT-L
    b, _ = run('bench', bench.main, [], {'CWM_BENCH_SBIG': '64'})
    # K2: 24 encoder blocks (packed) and 12 decoder blocks a suffix pass
    k2 = suffix_k2(24, 12, packed=True)
    want = dict(zero, flash_attention=36, **k2, window_lookup=24,
                add_layer_norm=norm_launches(24, 12, True),
                qkv_heads=qkv_launches(24, 12, True))
    check('bench', b['value'] > 0 and b['launches_per_dispatch'] == want
          and b['config']['engine']
          == 'shared-prefix/default:pooled4+suffix4+tanh'
          and set(b['s_scaling']) == {'s16', 's64'}
          and b['mfu_executed'] > 0 and min(b['stages'].values()) > 0
          and {'exact-numerics', 'pooled2+suffix2+tanh', 'pooled4+suffix4',
               'pooled4+suffix4+tanh'} <= set(b['rungs']), json.dumps(b))
    out['bench'] = b

    sw, _ = run('bench_sweep', bench_sweep.main, ['--sizes', '16'],
                {'CWM_BENCH_RUNGS': '0'})
    check('bench_sweep', [r['s'] for r in sw['rows']] == [16]
          and sw['rows'][0]['sims_per_sec'] > 0, json.dumps(sw))
    out['bench_sweep'] = sw

    lat, _ = run('latency_bench', latency_bench.main,
                 ['--model', 'large', '--iters', '20'])
    check('latency_bench', lat['p50_ms'] > 0
          and lat['launches_per_call'] == dict(zero, flash_attention=36)
          and lat['warm_prefix']['launches_per_call']
          == dict(zero, **k2, add_layer_norm=norm_launches(24, 12, False),
                  qkv_heads=qkv_launches(24, 12, False))
          and lat['warm_prefix_imu']['launches_per_call'][
              'flash_attention_prefix'] == 12 + 4, json.dumps(lat))
    out['latency_bench'] = lat

    sl, _ = run('serve_latency', serve_latency.main, ['--max-prompt', '16'])
    s = sl['serve_first_request_by_prompt_size']
    warm = dict(zero, **k2, window_lookup=24,
                add_layer_norm=norm_launches(24, 12, False),
                qkv_heads=qkv_launches(24, 12, False))
    check('serve_latency', s['worst_first_request_sec'] > 0
          and s['launches_by_prompt_size'][1]
          == dict(warm, flash_attention=36,
                  add_layer_norm=norm_launches(24, 12, True),
                  qkv_heads=qkv_launches(24, 12, True))
          and all(s['launches_by_prompt_size'][k] == warm
                  for k in range(2, 17)), json.dumps(s))
    out['serve_latency'] = s

    lg, _ = run('loadgen', loadgen.main, ['--requests', '32'])
    tb = lg['trials']['batched']
    check('loadgen', lg['value'] > 0
          and tb['micro_batching']['requests_batched'] > 0
          and tb['launches']['flash_attention_prefix'] > 0
          and tb['launches']['window_lookup'] > 0, json.dumps(lg))
    out['loadgen'] = lg

    cj, _ = run('bench_conjoined', bench_conjoined.main, [])
    check('bench_conjoined', cj['value'] > 0 and cj['exact_sims_per_sec'] > 0
          and cj['config']['model'].startswith('imu400')
          and cj['launches_fast']['flash_attention_prefix'] == 12 + 4
          and cj['launches_fast']['window_lookup'] == 24
          and cj['launches_fast']['flash_attention'] > 0
          and cj['launches_exact']['flash_attention'] > 0
          and cj['launches_exact']['flash_attention_prefix'] == 0
          and cj['launches_exact']['window_lookup'] == 24, json.dumps(cj))
    out['bench_conjoined'] = cj

    (tr, head), _ = run('bench_train', bench_train.main, [],
                        {'CWM_TRAIN_BENCH_STEPS': '2'})
    pairs = {'vmae_large': (72, 36), 'vmae_large_accum2': (144, 72),
             'vmae_large_remat_off': (36, 36), 'cmae_base': (32, 16),
             'conjoined_imu': (64, 32), 'raft': (0, 0)}
    for r in tr['results']:
        ln = r.get('launches_per_step')
        if ln is None:                       # the loader-in-loop row
            check(r['family'], r['clips_per_sec'] > 0, json.dumps(r))
            continue
        k5, k6 = ln['flash_attention_lse'], ln['flash_attention_bwd']
        want = pairs.get(r['family'])
        ok = ((k5, k6) == want if want is not None
              else k5 >= k6 > 0)
        check(r['family'], ok and r['sec_per_step'] > 0
              and (r['mfu'] or 0) > 0, json.dumps(r))
    check('bench_train', head['value'] > 0 and len(tr['results']) == 10,
          json.dumps(head))
    out['bench_train'] = tr

    ld, _ = run('bench_loader', bench_loader.main,
                ['--clips', '64', '--seconds', '0.5', '--threads', '1,4'])
    check('bench_loader', ld['value'] > 0
          and len(ld['results']['loaders']) == 8, json.dumps(ld))
    out['bench_loader'] = ld

    at, _ = run('bench_attention', bench_attention.main, ['--s', '16'])
    rows = at['rows']
    check('bench_attention', rows['ours']['launches']
          == {'flash_attention': 1}
          and rows['ours-two-source']['launches']
          == {'flash_attention_prefix': 1}
          and not rows['sdpa']['launches'] and not rows['plain']['launches']
          and all(r['ms'] > 0 for r in rows.values()), json.dumps(rows))
    out['bench_attention'] = at

    out['not_as_expected'] = bad
    if bad:
        raise AssertionError('measurement entry points: ' + '; '.join(bad))
    return out


def _category(kernel_name):
    k = kernel_name.lower()
    for cat, keys in (('attention kernel (K1/K2/K5)', ('attention_fwd_tf32',
                                                       'attention_fwd_sm90')),
                      ('attention backward kernel (K6)', ('dkdv_tf32',
                                                          'dq_tf32',
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


def _profiled(torch, fn):
    """(profiler, wall ms) of one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _summary(prof, wall_ms):
    """Device busy time, idle share, time by kernel class and the top
    kernels of a profiled call; 'not measured' without device time."""
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


def profile_dispatch(torch, fn):
    """Device time by kernel of one dispatch (or train step) under
    torch.profiler, and the device's busy share of its wall time. A measurement, not a
    check: a profiler that records no device time gives 'not measured'."""
    try:
        return _summary(*_profiled(torch, fn))
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
                for d, v in itertools.product(HEAD_DIMS,
                                              SM90_VARIANTS.get(fn, ('',))):
                    found = [i for k, i in kernels.items()
                             if sm90_fragment(fn, d) + v in k]
                    what = f'{fn}<{d}{v and ", " + v}>'
                    if len(found) != 1:
                        raise AssertionError(f'{name}: {what} is not in '
                                             'the ptxas report once')
                    info = found[0]
                    if hgmma is not None and not info['hgmma']:
                        raise AssertionError(f'{name}: {what} has no HGMMA')
                    if d == 64 and (info.get('spill_stores')
                                    or info.get('spill_loads')):
                        raise AssertionError(f'{name}: {what} spills: {info}')

    phase('2 build', build)
    if not failed:
        phase('3 kernels', attention_cases, torch, F, fa, rec)
        phase('3 kernels', lookup_cases, torch, F, corr, rec)
        phase('3 kernels', training_kernel_cases, torch, F, fa, rec)
        phase('3 kernels', layer_norm_cases, torch, F, rec)
        phase('3 kernels', qkv_heads_cases, torch, F, rec)
        phase('4 small slice', small_slice, torch, port, rec)
        phase('4 small train', small_train, torch, port, rec)
        phase('4 small generator', small_generator, torch, port, rec)
        small_launches = phase('4 small raft', small_raft, torch, port, rec)
        phase('4 small movability', small_movability, torch, port, rec)
        phase('4 small imu', small_imu, torch, port, rec)
        cmae_predict = phase('4 small cmae train', small_cmae_train, torch,
                             port, rec)
        small_conj = phase('4 small conjoined train', small_conjoined_train,
                           torch, port, rec)
        torch.backends.cudnn.allow_tf32 = True
        full = phase('5 full width', full_width, torch, port, rec, smi)
        movability = imu = serving = ctx5 = None
        if full is not None:
            ctx5 = full[1]
            phase('5b generator', generator_phase, torch, port, rec, smi,
                  full[1])
            movability = phase('5c movability', movability_phase, torch,
                               port, rec, smi, full[1])
            imu = phase('5d imu', imu_phase, torch, port, rec, smi, full[1])
            if imu is not None:
                serving = phase('5e serving', serving_phase, torch, port,
                                rec, smi, full[1])
            phase('5 profile', profile_default, torch, rec, full[1])
            full = full[0]
            torch.cuda.empty_cache()
        train = phase('6 train', full_train, torch, port, rec, smi)
        torch.cuda.empty_cache()
        trainers = phase('6b trainers', full_trainers, torch, port, rec, smi)
        phase('6c shards', shard_resume, torch, port, rec, smi)
        torch.cuda.empty_cache()
        raft_train = phase('8 raft', raft_trainer, torch, port, rec, smi)
        phase('8 small raft train', small_raft_train, torch, port, rec)
        world1 = None
        if ctx5 is not None:
            world1 = phase('8 world 1', world_one, torch, port, rec, smi,
                           ctx5)
        phase('8 two ranks', two_ranks, torch, port, rec, smi)
        tp1 = phase('9a tp world 1', tp_world_one, torch, port, rec, smi)
        sharding = phase('9 model sharding', model_sharding, torch, port,
                         rec, smi)
        torch.cuda.empty_cache()
        structure = phase('10a structure', structure_phase, torch, port,
                          rec, smi)
        phase('10b shards', shards_phase, torch, port, rec, smi)
        fidelity = phase('10c fidelity', fidelity_phase, torch, port, rec,
                         smi)
        demo = phase('10d demo', demo_phase, torch, port, rec, smi)
        torch.cuda.empty_cache()
        measurement = phase('11 measurement', measurement_phase, torch, port,
                            rec, smi)
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

    # each row's launches on the path whose shapes it measures: one
    # default-rung dispatch (K1-K4 at ViT-L), one train step (K5, K6), one
    # small-RAFT call (the lookup at r = 3), one cold IMU-conditioned
    # motion map (phase 5d (a): K1 at the ViT-B and IMU shapes, K2 at the
    # conjoined suffix), the server's mixed-scene batch of 4 requests
    # (phase 5e: K2 with s0 = 4), one step of each full-width trainer of
    # phase 6b (K5, K6 at the ChannelMAE and imu400 shapes), phase 4's
    # three steps of the small conjoined trainer and the tiny ChannelMAE's
    # predict_image (the padded head dims); beside them, the kernel's
    # launches on every path, the phase 8 paths included: a RAFT train step
    # (none: the gather lookup), the keypoint teacher of train_raft, the dp
    # step and the sample-sharded dispatch at world size 1
    paths = dict(dispatch=full[0]['launches'],
                 movability_call=movability['launches_per_call'],
                 imu_motion_map=imu['a']['launches'],
                 imu_movability_call=imu['d']['launches'],
                 train_step=train['launches_per_step'][-1],
                 small_raft_call=small_launches,
                 serve_cold_counterfactual=serving['launches'][
                     'counterfactual_cold'],
                 serve_mixed_scene_batch=serving['launches'][
                     'mixed_scene_batch'],
                 serve_imu_movability=serving['launches']['imu_movability'],
                 cmae_train_step=trainers['train_cmae'][
                     'launches_per_step'][-1],
                 cmae_flow_train_step=trainers['train_cmae --with-flow'][
                     'launches_per_step'][-1],
                 imu400_train_step=trainers['train_conjoined imu400'][
                     'launches_per_step'][-1],
                 small_conjoined_3_steps=small_conj,
                 tiny_cmae_predict_image=cmae_predict,
                 raft_train_step=raft_train['flow']['launches_per_step'][-1],
                 raft_keypoint_teacher=raft_train['keypoint'][
                     'teacher_launches'],
                 dp_train_step_world1=world1['train']['launches_per_step'][
                     -1],
                 sample_sharded_dispatch_world1=world1['dispatch'][
                     'launches'],
                 tp_train_step_world1=tp1['launches_per_step'][-1],
                 tp2_train_step=sharding['b']['rank0']['launches'],
                 tp_stack_forward=sharding['c']['tp bfloat16']['launches'],
                 sp_stack_forward=sharding['c']['sp bfloat16']['launches'],
                 pp_stack_forward=sharding['c']['pp bfloat16']['launches'],
                 structure_step={k: int(v) for k, v in structure[
                     'launches_per_step'].items()},
                 fidelity_exact_leg=fidelity['legs_of']['exact'],
                 fidelity_exact_f32_leg=fidelity['legs_of']['exact f32'],
                 fidelity_fast_f32_leg=fidelity['legs_of']['fast f32'],
                 fidelity_pool4_leg=fidelity['legs_of'][
                     'pool4_suffix4_tanh'],
                 fidelity_pool4_f32_leg=fidelity['legs_of'][
                     'pool4_suffix4_tanh f32'],
                 demo_base=demo['base']['launches'],
                 demo_large_movability=demo['large']['launches'],
                 bench_dispatch=measurement['bench']['launches_per_dispatch'])
    table = []
    for kid, kernel, dtype, case, path, replaces in (
            ('K1', 'flash_attention', 'bfloat16', 'encoder prefix',
             'dispatch', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'bfloat16', 'ViT-B 4x4 prefix',
             'imu_motion_map', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'bfloat16', 'IMU context decoder, D 32',
             'imu_motion_map', REPLACES['flash_attention']),
            ('K2', 'flash_attention_prefix', 'bfloat16', 'pool4 rung',
             'dispatch', REPLACES['flash_attention_prefix']),
            # the encoder suffix: own-key lengths, 3 samples a block
            ('K2', 'flash_attention_prefix', 'bfloat16', 'cf encoder suffix',
             'dispatch', REPLACES['flash_attention_prefix']),
            ('K2', 'flash_attention_prefix', 'bfloat16',
             'conjoined decoder suffix', 'imu_motion_map',
             REPLACES['flash_attention_prefix']),
            ('K2', 'flash_attention_prefix', 'bfloat16',
             'imu encoder suffix', 'imu_motion_map',
             REPLACES['flash_attention_prefix']),
            # the server's mixed-scene micro-batch: 4 scenes' prefixes
            ('K2', 'flash_attention_prefix', 'bfloat16',
             'stacked prefixes s0=S', 'serve_mixed_scene_batch',
             REPLACES['flash_attention_prefix']),
            ('K3', 'window_lookup', 'float32', 'pyramid 28/14/7/3',
             'dispatch', REPLACES['window_lookup']),
            # K3 and K4 differ only in TPU layout: one kernel serves both
            ('K4', 'window_lookup', 'float32', 'pyramid 28/14/7/3',
             'dispatch', REPLACES_K4),
            ('K3', 'window_lookup', 'float32', 'pyramid 28/14/7/3, r 3',
             'small_raft_call', REPLACES['window_lookup']),
            ('K5', 'flash_attention_lse', 'bfloat16', 'encoder',
             'train_step', REPLACES['flash_attention_lse']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'encoder',
             'train_step', REPLACES['flash_attention_bwd']),
            # the ChannelMAE trainer (train_cmae's defaults, with and
            # without the flow group) and the imu400 conjoined trainer
            ('K5', 'flash_attention_lse', 'bfloat16', 'ChannelMAE encoder',
             'cmae_train_step', REPLACES['flash_attention_lse']),
            ('K5', 'flash_attention_lse', 'bfloat16', 'ChannelMAE decoder',
             'cmae_train_step', REPLACES['flash_attention_lse']),
            ('K5', 'flash_attention_lse', 'bfloat16',
             'ChannelMAE+flow decoder', 'cmae_flow_train_step',
             REPLACES['flash_attention_lse']),
            ('K5', 'flash_attention_lse', 'bfloat16', 'imu400 main decoder',
             'imu400_train_step', REPLACES['flash_attention_lse']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'ChannelMAE encoder',
             'cmae_train_step', REPLACES['flash_attention_bwd']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'ChannelMAE decoder',
             'cmae_train_step', REPLACES['flash_attention_bwd']),
            ('K6', 'flash_attention_bwd', 'bfloat16',
             'ChannelMAE+flow decoder', 'cmae_flow_train_step',
             REPLACES['flash_attention_bwd']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'imu400 main decoder',
             'imu400_train_step', REPLACES['flash_attention_bwd']),
            # head dims run padded: D 24 and 8 on the small conjoined
            # trainer (three steps), D 48 on the tiny ChannelMAE's
            # predict_image
            ('K1', 'flash_attention', 'bfloat16', 'padded D 48',
             'tiny_cmae_predict_image', REPLACES['flash_attention']),
            ('K5', 'flash_attention_lse', 'bfloat16', 'padded D 24',
             'small_conjoined_3_steps', REPLACES['flash_attention_lse']),
            ('K5', 'flash_attention_lse', 'bfloat16', 'padded D 8',
             'small_conjoined_3_steps', REPLACES['flash_attention_lse']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'padded D 24',
             'small_conjoined_3_steps', REPLACES['flash_attention_bwd']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'padded D 8',
             'small_conjoined_3_steps', REPLACES['flash_attention_bwd']),
            # model sharding: one rank's share of the work (phase 9)
            ('K5', 'flash_attention_lse', 'bfloat16', 'tp 2 encoder',
             'tp2_train_step', REPLACES['flash_attention_lse']),
            ('K5', 'flash_attention_lse', 'bfloat16', 'tp 2 decoder',
             'tp2_train_step', REPLACES['flash_attention_lse']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'tp 2 encoder',
             'tp2_train_step', REPLACES['flash_attention_bwd']),
            ('K6', 'flash_attention_bwd', 'bfloat16', 'tp 2 decoder',
             'tp2_train_step', REPLACES['flash_attention_bwd']),
            ('K1', 'flash_attention', 'bfloat16', 'tp 2 encoder prefix',
             'tp_stack_forward', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'bfloat16', 'sp 2 local queries',
             'sp_stack_forward', REPLACES['flash_attention']),
            # phase 10: structure extraction's f32 training pair, the
            # fidelity report's exact and engine legs (bf16, and f32 in
            # the decomposition), the demo's ViT-B 8x8
            ('K5', 'flash_attention_lse', 'float32', 'Soft ChannelMAE encoder',
             'structure_step', REPLACES['flash_attention_lse']),
            ('K5', 'flash_attention_lse', 'float32', 'Soft ChannelMAE decoder',
             'structure_step', REPLACES['flash_attention_lse']),
            ('K6', 'flash_attention_bwd', 'float32', 'Soft ChannelMAE encoder',
             'structure_step', REPLACES['flash_attention_bwd']),
            ('K6', 'flash_attention_bwd', 'float32', 'Soft ChannelMAE decoder',
             'structure_step', REPLACES['flash_attention_bwd']),
            ('K1', 'flash_attention', 'bfloat16', 'exact encoder S 8',
             'fidelity_exact_leg', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'bfloat16', 'exact decoder S 8',
             'fidelity_exact_leg', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'float32', 'exact encoder S 8',
             'fidelity_exact_f32_leg', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'float32', 'exact decoder S 8',
             'fidelity_exact_f32_leg', REPLACES['flash_attention']),
            ('K1', 'flash_attention', 'float32', 'encoder prefix',
             'fidelity_fast_f32_leg', REPLACES['flash_attention']),
            ('K2', 'flash_attention_prefix', 'float32', 'exact rung S 8',
             'fidelity_fast_f32_leg', REPLACES['flash_attention_prefix']),
            ('K2', 'flash_attention_prefix', 'bfloat16', 'pool4 rung S 8',
             'fidelity_pool4_leg', REPLACES['flash_attention_prefix']),
            ('K2', 'flash_attention_prefix', 'float32', 'pool4 rung S 8',
             'fidelity_pool4_f32_leg', REPLACES['flash_attention_prefix']),
            ('K1', 'flash_attention', 'bfloat16', 'ViT-B 8x8 encoder prefix',
             'demo_base', REPLACES['flash_attention']),
            ('K2', 'flash_attention_prefix', 'bfloat16', 'ViT-B 8x8 pool4 S 8',
             'demo_base', REPLACES['flash_attention_prefix'])):
        r = pick(kernel, dtype, case)
        row = dict(name=kernel, tpu_kernel=kid, case=case, dtype=dtype,
                   route='cuda', source=SOURCES[kernel], replaces=replaces,
                   path=path, launches=paths[path][kernel],
                   launches_per_path={k: v[kernel] for k, v in paths.items()},
                   max_abs_err=r['max_abs_err'], ms=r['ms'],
                   plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                   bound_by=r['bound_by'], library_ms=r['library_ms'])
        for key in ('bound_cuda_core_ms', 'graph_ms', 'library_graph_ms'):
            if key in r:
                row[key] = r[key]
        table.append(row)
    print(json.dumps({'kernels': table}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
