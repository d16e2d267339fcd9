"""Train a VMAE with the temporally-factored masking policy.

Port of scripts/train_vmae.py: synthetic clips or a CWMSHARD file through
the native loader, rolling checkpoints with exact resume, JSONL metrics, a
profiler window, and data and tensor parallelism over processes
(training/loop.py).

    python -m counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --synthetic --model large --batch-size 4 --steps 10

    python -m counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --shard clips.shard --input-mode u8 --checkpoint-dir ckpt/vmae

    # the plain PyTorch path on the CPU (f32, dense attention)
    python -m counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --synthetic --model tiny --img-size 32 --batch-size 2 --steps 2 \\
        --device cpu

    # data-parallel over 4 cards, one process each
    torchrun --nproc_per_node=4 -m \\
        counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --synthetic --model large --batch-size 16 --dp 4

    # 2 x 2: the heads and MLP hidden units split over 2 cards, twice
    torchrun --nproc_per_node=4 -m \\
        counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --synthetic --model large --batch-size 8 --dp 2 --tp 2

On CUDA the model runs in bf16 with the flash attention kernels; on the
CPU in f32 with dense attention. Prints a JSON line per logged step.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..models import vmae
from . import loop
from . import train as T


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default='base',
                    choices=['tiny', 'base', 'large'])
    ap.add_argument('--img-size', type=int, default=224)
    ap.add_argument('--patch-size', type=int, default=8)
    ap.add_argument('--input-mode', default='u8', choices=['u8', 'f32'],
                    help='shard loader output: u8 ships raw uint8 THWC '
                         'batches and normalizes on the device (default); '
                         'f32 normalizes on the host')
    loop.add_common_args(ap, batch_size=32, mask_ratio=0.99)
    return ap.parse_args(argv)


def build_model(args, device: torch.device):
    """tiny / base / large; bf16 with flash attention on CUDA, f32 with
    dense attention on the CPU."""
    dtype, attn = loop.dtype_and_attn(device)
    if args.model == 'tiny':
        return vmae.PretrainVisionTransformer(
            img_size=(args.img_size, args.img_size),
            patch_size=(args.patch_size, args.patch_size),
            encoder_embed_dim=96, encoder_depth=2, encoder_num_heads=2,
            decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2,
            mlp_ratio=2.0, qkv_bias=True, num_frames=2, tubelet_size=1,
            dtype=dtype, attn_impl=attn)
    if args.model == 'base':
        return vmae.base_8x8patch_2frames_1tube(dtype=dtype, attn_impl=attn)
    return vmae.large_4x4patch_2frames_1tube(dtype=dtype, attn_impl=attn)


def make_data(args, start_step: int, batch_size: int, seed: int):
    """Yields [B, T=2, C, H, W] float32 clips in [0, 1] (synthetic: a random
    frame and the same frame shifted by up to 8 px), or the shard loader's
    batches (uint8 [B, T, H, W, C] with --input-mode u8), from step
    ``start_step`` on: ``batch_size`` clips a batch from the stream
    ``seed``."""
    if args.shard:
        crop = (args.img_size, args.img_size)
        yield from loop.shard_loader(args, crop, start_step, batch_size,
                                     seed, out_dtype=args.input_mode)
        return
    rng = np.random.RandomState(seed)
    base = rng.rand(batch_size, 1, 3, args.img_size,
                    args.img_size).astype(np.float32)
    for _ in range(start_step):
        rng.randint(-8, 9, 2)
    while True:
        shiftpx = rng.randint(-8, 9, 2)
        f1 = np.roll(base, tuple(shiftpx), axis=(-2, -1))
        yield np.concatenate([base, f1], 1)


def main(argv=None):
    args = parse_args(argv)
    loop.check_args(args)
    device = resolve_device(args.device)
    dp = loop.data_parallel(args, device)
    model = build_model(args, device)
    optimizer = T.make_optimizer(learning_rate=args.lr,
                                 warmup_steps=args.warmup_steps,
                                 total_steps=args.steps)
    _, n_vis = T.make_batch_masks(None, model, args.batch_size,
                                  args.mask_ratio)
    state = T.init_train_state(model, optimizer, args.seed, device)
    ckpt, state, start = loop.resume(args, state)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    loop.say(f'device={name} model={args.model} dtype={model.dtype} '
             f'attn={model.attn_impl} n_vis={n_vis} dp={dp.size} tp={dp.tp}')

    def mask_fn(g, b):
        return T.make_batch_masks(g, model, b, args.mask_ratio)[0]

    kw = dict(remat=not args.no_remat, mask_fn=mask_fn,
              accum_steps=args.accum_steps, device=device)
    if dp.mesh is None:
        train_step = T.make_train_step(model, optimizer, n_vis, **kw)
    else:
        train_step, shard_state, _ = T.make_sharded_train_step(
            model, optimizer, dp.mesh, n_vis, **kw)
        state = shard_state(state)
    data = make_data(args, start, dp.batch_size, dp.data_seed)

    def step_fn(state, step):
        batch = dp.put(np.asarray(next(data)), device, args.batch_size)
        return train_step(state, batch,
                          loop.step_generator(device, args.seed, step))

    return loop.run(args, state, ckpt, start, step_fn, 'clips_per_sec')


if __name__ == '__main__':
    main()
