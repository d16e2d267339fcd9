"""Train a ChannelMAE (masked channel-group reconstruction).

Port of scripts/train_cmae.py: per-group uniform masking, the masked
patches' MSE summed over channel groups, AdamW with the cosine schedule,
rolling checkpoints with exact resume, JSONL metrics, and ``--dp`` and
``--tp`` over processes (training/loop.py).

Data: a clip shard (one frame per clip) or synthetic images (a coarse 8x8
noise image resized bilinearly). With ``--with-flow`` each clip's 2-frame
RAFT flow (the port's large RAFT, ``--raft-iters`` iterations, weights from
``--raft-params`` or seeded) joins the input as an extra 2-channel group.

    python -m counterfactualworldmodels_tpu_torch.training.train_cmae \\
        --synthetic --steps 10 --model tiny --img-size 64 --patch-size 16 \\
        --device cpu
    python -m counterfactualworldmodels_tpu_torch.training.train_cmae \\
        --shard clips.shard --model base --with-flow --raft-params raft.pth
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..models import cmae
from ..ops.resize import resize_bilinear
from . import loop
from . import train as T


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default='base', choices=['tiny', 'base'])
    ap.add_argument('--img-size', type=int, default=224)
    ap.add_argument('--patch-size', type=int, default=32,
                    help='ChannelMae default 32x32 patches')
    ap.add_argument('--partition', default='3',
                    help='comma-separated channel-group sizes of the image '
                         'channels (e.g. "3" or "1,1,1")')
    ap.add_argument('--with-flow', action='store_true',
                    help='append a 2-channel RAFT flow group computed from '
                         'each clip frame pair')
    ap.add_argument('--raft-params', default=None,
                    help='reference .pth checkpoint of the flow RAFT '
                         '(--with-flow; seeded weights otherwise)')
    ap.add_argument('--raft-iters', type=int, default=12)
    loop.add_common_args(ap, batch_size=32, mask_ratio=0.75)
    return ap.parse_args(argv)


def build_model(args, partition, device: torch.device) -> cmae.ChannelMae:
    """tiny or base (ViT-B); bf16 with flash attention on CUDA, f32 with
    dense attention on the CPU."""
    dtype, attn = loop.dtype_and_attn(device)
    kw = dict(image_size=(args.img_size, args.img_size),
              patch_size=(args.patch_size, args.patch_size),
              in_channels=sum(partition), channel_partition=partition,
              dtype=dtype, attn_impl=attn, device=device)
    if args.model == 'tiny':
        return cmae.ChannelMae(
            encoder_embed_dim=96, encoder_depth=2, encoder_num_heads=2,
            decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2,
            mlp_ratio=2.0, **kw)
    return cmae.ChannelMae(**kw)


def make_flow_fn(args, device: torch.device):
    """(frame0, frame1) [B, 3, H, W] in [0, 1] -> RAFT flow [B, 2, H, W]
    (f32), without gradients."""
    from ..models.raft.raft import RAFT
    from ..utils import weights
    dtype, _ = loop.dtype_and_attn(device)
    raft = RAFT(iters=args.raft_iters, dtype=dtype, device=device)
    if args.raft_params:
        from ..pipelines.prediction import load_raft_checkpoint
        raft.load_state_dict(load_raft_checkpoint(args.raft_params),
                             strict=True)
    else:
        print('WARNING: --with-flow without --raft-params uses a seeded '
              'random RAFT (smoke only)', file=sys.stderr)
        weights.init_raft(raft, torch.Generator(device=device).manual_seed(7))
    raft.eval()

    @torch.no_grad()
    def flow_fn(f0, f1):
        return raft(f0 * 255.0, f1 * 255.0, args.raft_iters)[1].float()
    return flow_fn


def make_data(args, device: torch.device, start_step: int, batch_size: int,
              seed: int):
    """Yields [B, C_total, H, W] f32 channel-group batches on ``device``:
    the image in [0, 1], then (--with-flow) the raw flow channels;
    ``batch_size`` images a batch from the stream ``seed``."""
    flow_fn = make_flow_fn(args, device) if args.with_flow else None
    sz = args.img_size

    def with_flow(img, f1):
        if flow_fn is None:
            return img
        return torch.cat([img, flow_fn(img, f1)], dim=1)

    if args.synthetic:
        rng = np.random.RandomState(seed + 1)
        for _ in range(start_step):
            rng.rand(batch_size, 3, 8, 8)
        while True:
            coarse = torch.from_numpy(
                rng.rand(batch_size, 3, 8, 8).astype(np.float32))
            img = resize_bilinear(coarse, (sz, sz)).to(device)
            yield with_flow(img, torch.roll(img, 2, dims=-1))
    loader = loop.shard_loader(args, (sz, sz), start_step, batch_size, seed)
    for clips in loader:                          # [B, T, C, H, W]
        clips = torch.from_numpy(clips).to(device)
        img = clips[:, 0]
        yield with_flow(img, clips[:, 1] if clips.shape[1] > 1 else img)


def main(argv=None):
    args = parse_args(argv)
    loop.check_args(args)
    device = resolve_device(args.device)
    dp = loop.data_parallel(args, device)
    partition = tuple(int(v) for v in args.partition.split(',') if v)
    if args.with_flow:
        partition = partition + (2,)
    model = build_model(args, partition, device)
    optimizer = T.make_optimizer(learning_rate=args.lr,
                                 warmup_steps=args.warmup_steps,
                                 total_steps=args.steps)
    _, counts = cmae.group_uniform_mask(torch.Generator(), model.mask_size,
                                        args.mask_ratio, 1)
    n_vis = model.num_patches - sum(counts)
    state = T.init_cmae_train_state(model, optimizer, args.seed)
    ckpt, state, start = loop.resume(args, state)
    loop.say(f'partition={partition} mask_size={model.mask_size} '
             f'n_vis={n_vis} device={device} dtype={model.dtype} '
             f'attn={model.attn_impl} dp={dp.size} tp={dp.tp}')

    def mask_fn(g, b):
        return cmae.group_uniform_mask(g, model.mask_size, args.mask_ratio,
                                       b)[0]

    kw = dict(remat=not args.no_remat, mask_fn=mask_fn,
              accum_steps=args.accum_steps)
    if dp.mesh is None:
        train_step = T.make_cmae_train_step(model, optimizer, n_vis, counts,
                                            **kw)
    else:
        train_step, shard_state, _ = T.make_sharded_cmae_train_step(
            model, optimizer, dp.mesh, n_vis, counts, **kw)
        state = shard_state(state)
    data = make_data(args, device, start, dp.batch_size, dp.data_seed)

    def step_fn(state, step):
        batch = dp.put(next(data), device, args.batch_size)
        return train_step(state, batch,
                          loop.step_generator(device, args.seed, step))

    return loop.run(args, state, ckpt, start, step_fn, 'imgs_per_sec')


if __name__ == '__main__':
    main()
