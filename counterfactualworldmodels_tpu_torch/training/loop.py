"""What the training entry points (train_vmae, train_cmae, train_conjoined,
train_raft) share: their common flags, data parallelism over processes,
the checkpoint resume, the per-step mask generator, the shard loader and
the logged step loop (the loop of the JAX package's scripts/train_*.py).

Resume is exact: a trainer restarted from a checkpoint at step s draws the
masks and reads the batches the uninterrupted run drew and read from step
s on. Each step's masks come from a generator seeded from (seed, step), and
the data stream starts at batch s.

``--dp D --tp T`` runs one process per card, D x T of them, launched by
torchrun:

    torchrun --nproc_per_node=N -m \\
        counterfactualworldmodels_tpu_torch.training.train_vmae --dp N ...
    torchrun --nproc_per_node=4 -m \\
        counterfactualworldmodels_tpu_torch.training.train_vmae --tp 2 ...

The ranks form the mesh {'dp': D, 'tp': T}, rank = dp coordinate * T + tp
coordinate. Each dp coordinate feeds its share of the global
``--batch-size`` from its own data stream (seeded ``seed + 100003 * dp
coordinate``, so the tp ranks of one dp group read the same batch); the
masks are drawn for the global batch from the shared seed and sliced by
dp coordinate; the sharded step averages the gradients over dp and splits
the model over tp. Rank 0 alone prints and logs metrics and writes
checkpoints, which hold the full (gathered) state; every rank restores
them, and a checkpoint resumes at any --tp.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..data.shards import NativeClipLoader, open_loader
from ..parallel.mesh import make_mesh
from ..parallel.multihost import (host_local_batch_to_global,
                                  initialize_distributed)
from ..utils.checkpoint import CheckpointManager, gathers_for_rank0
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
    add_device_args(ap)
    ap.add_argument('--tp', type=int, default=1,
                    help='tensor-parallel size: the heads and MLP hidden '
                         'units split over this many processes, one per '
                         'card (--dp x --tp of them, torchrun)')


def add_device_args(ap: argparse.ArgumentParser) -> None:
    """--dp and --device, which every trainer takes."""
    ap.add_argument('--dp', type=int, default=0,
                    help='data-parallel size, one process per card '
                         '(torchrun --nproc_per_node=N); 0 = every process')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (bf16, flash attention) or 'cpu' (f32, "
                         'the plain PyTorch path)')


def check_args(args) -> None:
    """Refuse a tp size below 1 and a run without data."""
    if args.tp < 1:
        raise SystemExit(f'--tp {args.tp}: the tensor-parallel size is at '
                         'least 1')
    if not args.synthetic and not args.shard:
        raise SystemExit('pass --shard PATH or --synthetic')


def is_main() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def say(*msg) -> None:
    """print on rank 0 only."""
    if is_main():
        print(*msg, flush=True)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A trainer's share of the work: ``mesh`` (a {'dp': size} mesh, or
    {'dp': size, 'tp': tp} with tensor parallelism; None on one process),
    this dp coordinate's ``batch_size`` of the global one and the seed of
    its data stream."""
    mesh: Optional[object]
    size: int
    batch_size: int
    data_seed: int
    tp: int = 1

    def put(self, x, device, global_size: int) -> torch.Tensor:
        """This rank's batch on ``device``, its global size checked."""
        if self.mesh is None:
            return torch.as_tensor(x).to(device)
        return host_local_batch_to_global(self.mesh, 'dp', x, device,
                                          global_size)


def data_parallel(args, device: torch.device) -> DataParallel:
    """Bring up the process group when torchrun started this process
    (parallel.initialize_distributed; the backend follows ``device``) and
    size the parallelism: ``--dp 0`` is every process over --tp, and --dp
    x --tp must equal the world size (one process per card); --dp must
    divide --batch-size. A trainer without --tp runs tp = 1."""
    initialize_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp = getattr(args, 'tp', 1)
    dp = args.dp or max(world // tp, 1)
    if dp * tp != world:
        raise SystemExit(f'--dp {dp} x --tp {tp} needs {dp * tp} processes, '
                         f'one per card, and this run has {world}: launch '
                         f'with torchrun --nproc_per_node={dp * tp}')
    if args.batch_size % dp:
        raise SystemExit(f'--dp {dp} must divide --batch-size '
                         f'{args.batch_size}')
    if tp > 1:
        mesh = make_mesh({'dp': dp, 'tp': tp})
    else:
        mesh = make_mesh({'dp': dp}) if dp > 1 else None
    return DataParallel(mesh, dp, args.batch_size // dp,
                        args.seed + 100003 * (rank // tp), tp)


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
        say(f'resumed from step {state.step}')
    return ckpt, state, state.step


def shard_loader(args, crop, start_step: int, batch_size: int, seed: int,
                 **kwargs):
    """The shard's loader of ``batch_size`` clips a batch from the stream
    ``seed``, starting at batch ``start_step``; prints which loader runs."""
    loader = open_loader(args.shard, batch_size=batch_size, crop_size=crop,
                         seed=seed, start_batch=start_step, **kwargs)
    where = (f' ({loader.library})' if isinstance(loader, NativeClipLoader)
             else '')
    say(f'loader={type(loader).__name__}{where}')
    return loader


def run(args, state, ckpt: Optional[CheckpointManager], start_step: int,
        step_fn: Callable, rate_key: str) -> list:
    """The training loop: ``step_fn(state, step) -> (state, metrics)`` for
    each step from ``start_step`` to ``args.steps``; a JSON line (and a
    metrics record) every ``--log-every`` steps and at the last, with
    sec/step and ``rate_key`` (samples of the global batch per second);
    checkpoints every ``--checkpoint-every`` steps and at the end; the
    profiler window. Every rank runs the steps; rank 0 alone prints, logs
    and saves (the other ranks of its tp group join the checkpoint's
    gather). Returns the logged records."""
    main = is_main()
    if not (main or gathers_for_rank0(state.model)):
        ckpt = None
    metrics_log = MetricsLogger(args.metrics) if args.metrics and main \
        else None
    tracer = StepTraceWindow(args.profile_dir if main else None, start_step)
    records = []
    # the last step with a checkpoint, alike on every rank that saves
    saved = (start_step if ckpt is not None
             and start_step in ckpt.all_steps() else None)
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
            if 'epe' in metrics:
                rec['epe'] = float(metrics['epe'])
            say(json.dumps(rec))
            records.append(rec)
            if metrics_log:
                metrics_log.log(**rec)
        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, state)
            saved = step + 1
    if ckpt is not None and state.step != saved:
        ckpt.save(state.step, state)
    tracer.close()
    if dist.is_initialized():
        # every rank returns with rank 0's last checkpoint on disk, so a
        # run started next resumes from it on every rank
        dist.barrier()
    say('done')
    return records
