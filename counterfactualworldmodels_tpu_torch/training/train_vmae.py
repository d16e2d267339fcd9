"""Train a VMAE with the temporally-factored masking policy on one card.

Port of scripts/train_vmae.py (synthetic clips so far; the shard loader,
checkpointing, multi-card meshes and profiling come with their modules).

    python -m counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --synthetic --model large --batch-size 4 --steps 10

    # the plain PyTorch path on the CPU (f32, dense attention)
    python -m counterfactualworldmodels_tpu_torch.training.train_vmae \\
        --synthetic --model tiny --img-size 32 --batch-size 2 --steps 2 \\
        --device cpu

On CUDA the model runs in bf16 with the flash attention kernels; on the
CPU in f32 with dense attention. Prints one JSON line per step.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..models import vmae
from . import train as T


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--synthetic', action='store_true',
                    help='train on synthetic noise clips (the only data '
                         'source ported so far)')
    ap.add_argument('--model', default='base',
                    choices=['tiny', 'base', 'large'])
    ap.add_argument('--img-size', type=int, default=224)
    ap.add_argument('--patch-size', type=int, default=8)
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--warmup-steps', type=int, default=100)
    ap.add_argument('--lr', type=float, default=1.5e-4)
    ap.add_argument('--mask-ratio', type=float, default=0.99)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--no-remat', action='store_true')
    ap.add_argument('--accum-steps', type=int, default=1,
                    help='gradient-accumulation microbatches per step')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def build_model(args, device: torch.device):
    """tiny / base / large; bf16 with flash attention on CUDA, f32 with
    dense attention on the CPU."""
    on_cuda = device.type == 'cuda'
    dtype = torch.bfloat16 if on_cuda else torch.float32
    attn = 'flash' if on_cuda else 'dense'
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


def make_data(args):
    """Yields [B, T=2, C, H, W] float32 clips in [0, 1]: a random frame and
    the same frame shifted by up to 8 px."""
    rng = np.random.RandomState(args.seed)
    base = rng.rand(args.batch_size, 1, 3, args.img_size,
                    args.img_size).astype(np.float32)
    while True:
        shiftpx = rng.randint(-8, 9, 2)
        f1 = np.roll(base, tuple(shiftpx), axis=(-2, -1))
        yield np.concatenate([base, f1], 1)


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit('pass --synthetic (the shard loader is not ported '
                         'yet)')
    device = resolve_device(args.device)
    model = build_model(args, device)
    optimizer = T.make_optimizer(learning_rate=args.lr,
                                 warmup_steps=args.warmup_steps,
                                 total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _, n_vis = T.make_batch_masks(gen, model, args.batch_size,
                                  args.mask_ratio)
    state = T.init_train_state(model, optimizer, args.seed, device)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'device={name} model={args.model} dtype={model.dtype} '
          f'attn={model.attn_impl} n_vis={n_vis}', flush=True)

    def mask_fn(g, b):
        return T.make_batch_masks(g, model, b, args.mask_ratio)[0]

    step_fn = T.make_train_step(model, optimizer, n_vis,
                                remat=not args.no_remat, mask_fn=mask_fn,
                                accum_steps=args.accum_steps, device=device)
    data = make_data(args)
    t0 = time.time()
    for step in range(args.steps):
        batch = torch.from_numpy(next(data)).to(device)
        state, metrics = step_fn(state, batch, gen)
        loss = float(metrics['loss'])  # host sync
        dt = time.time() - t0
        t0 = time.time()
        print(json.dumps({'step': step + 1, 'loss': loss,
                          'grad_norm': float(metrics['grad_norm']),
                          'sec_per_step': round(dt, 4),
                          'clips_per_sec': round(args.batch_size / dt, 2)}),
              flush=True)
    print('done')


if __name__ == '__main__':
    main()
