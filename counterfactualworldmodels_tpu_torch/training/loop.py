"""What the three training entry points (train_vmae, train_cmae,
train_conjoined) share: their common flags, the checkpoint resume, the
per-step mask generator, the shard loader and the logged step loop (the
loop of the JAX package's scripts/train_*.py on one card).

Resume is exact: a trainer restarted from a checkpoint at step s draws the
masks and reads the batches the uninterrupted run drew and read from step
s on. Each step's masks come from a generator seeded from (seed, step), and
the data stream starts at batch s.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import torch

from ..data.shards import NativeClipLoader, open_loader
from ..utils.checkpoint import CheckpointManager
from ..utils.profiling import MetricsLogger, StepTraceWindow


def add_common_args(ap: argparse.ArgumentParser, batch_size: int,
                    mask_ratio: float) -> None:
    ap.add_argument('--shard', default=None, help='CWMSHARD file path')
    ap.add_argument('--synthetic', action='store_true',
                    help='train on synthetic data (pipeline smoke)')
    ap.add_argument('--batch-size', type=int, default=batch_size)
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--warmup-steps', type=int, default=100)
    ap.add_argument('--lr', type=float, default=1.5e-4)
    ap.add_argument('--mask-ratio', type=float, default=mask_ratio)
    ap.add_argument('--checkpoint-dir', default=None)
    ap.add_argument('--checkpoint-every', type=int, default=500)
    ap.add_argument('--log-every', type=int, default=1,
                    help='print (and log) a JSON line every N steps')
    ap.add_argument('--metrics', default=None, help='JSONL metrics path')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--no-remat', action='store_true')
    ap.add_argument('--profile-dir', default=None,
                    help='torch.profiler trace of a 3-step window after '
                         '3 warm-up steps (Chrome trace, view in Perfetto)')
    ap.add_argument('--accum-steps', type=int, default=1,
                    help='gradient-accumulation microbatches per step')
    ap.add_argument('--dp', type=int, default=0,
                    help='data-parallel size: only 0 or 1 (one card) so far')
    ap.add_argument('--tp', type=int, default=1,
                    help='tensor-parallel size: only 1 (one card) so far')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (bf16, flash attention) or 'cpu' (f32, "
                         'the plain PyTorch path)')


def check_args(args) -> None:
    """Refuse what the port does not run yet, and a run without data."""
    if args.dp not in (0, 1) or args.tp != 1:
        raise SystemExit('--dp/--tp beyond one card need the parallel '
                         'package, not ported yet (ROADMAP.md, queue 1 '
                         'item 11)')
    if not args.synthetic and not args.shard:
        raise SystemExit('pass --shard PATH or --synthetic')


def dtype_and_attn(device: torch.device):
    """bf16 with the flash kernels on the card, f32 dense on the CPU."""
    if device.type == 'cuda':
        return torch.bfloat16, 'flash'
    return torch.float32, 'dense'


def step_generator(device: torch.device, seed: int,
                   step: int) -> torch.Generator:
    """The generator of step ``step``'s masks: seeded from (seed, step),
    so a resumed run draws what the uninterrupted one drew."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2 ** 63))


def resume(args, state):
    """(checkpoint manager or None, state, start step): the state restored
    from the latest checkpoint under --checkpoint-dir, if there is one."""
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore_latest(state)
        print(f'resumed from step {state.step}', flush=True)
    return ckpt, state, state.step


def shard_loader(args, crop, start_step: int, **kwargs):
    """The shard's loader, starting at batch ``start_step``; prints which
    loader runs."""
    loader = open_loader(args.shard, batch_size=args.batch_size,
                         crop_size=crop, seed=args.seed,
                         start_batch=start_step, **kwargs)
    where = (f' ({loader.library})' if isinstance(loader, NativeClipLoader)
             else '')
    print(f'loader={type(loader).__name__}{where}', flush=True)
    return loader


def run(args, state, ckpt: Optional[CheckpointManager], start_step: int,
        step_fn: Callable, rate_key: str) -> list:
    """The training loop: ``step_fn(state, step) -> (state, metrics)`` for
    each step from ``start_step`` to ``args.steps``; a JSON line (and a
    metrics record) every ``--log-every`` steps and at the last, with
    sec/step and ``rate_key`` (samples per second); checkpoints every
    ``--checkpoint-every`` steps and at the end; the profiler window.
    Returns the logged records."""
    metrics_log = MetricsLogger(args.metrics) if args.metrics else None
    tracer = StepTraceWindow(args.profile_dir, start_step)
    records = []
    t0, last = time.time(), start_step
    for step in range(start_step, args.steps):
        tracer.tick(step)
        state, metrics = step_fn(state, step)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics['loss'])             # host sync
            dt = (time.time() - t0) / (step + 1 - last)
            t0, last = time.time(), step + 1
            rec = {'step': step + 1, 'loss': loss,
                   'grad_norm': float(metrics['grad_norm']),
                   'sec_per_step': round(dt, 4),
                   rate_key: round(args.batch_size / dt, 2)}
            print(json.dumps(rec), flush=True)
            records.append(rec)
            if metrics_log:
                metrics_log.log(**rec)
        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, state)
    if ckpt is not None and state.step not in ckpt.all_steps():
        ckpt.save(state.step, state)
    tracer.close()
    print('done', flush=True)
    return records
