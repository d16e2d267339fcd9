"""Pretrain a conjoined (IMU-conditioned) VMAE.

Port of scripts/train_conjoined.py: masked-prediction MSE on the main (RGB)
stream with the IMU context fully visible
(training/train.conjoined_prediction_loss), synthetic or shard data,
rolling checkpoints with exact resume, JSONL metrics, and ``--dp`` and
``--tp`` over processes (training/loop.py; the cross blocks split by
parallel.CONJOINED_PARTITION_RULES). With a shard, the IMU comes from its sidecar
(``<shard>.imu``, data/shards.write_imu_sidecar), row by row with the
loader's clips; without one it is a seeded placeholder.

    python -m counterfactualworldmodels_tpu_torch.training.train_conjoined \\
        --synthetic --steps 100
    python -m counterfactualworldmodels_tpu_torch.training.train_conjoined \\
        --synthetic --model imu400 --img-size 224 --batch-size 8 --steps 10
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..data.shards import read_imu_sidecar
from ..models import conjoined as conj
from ..ops.resize import resize_bilinear
from ..utils import weights
from . import loop
from . import train as T


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default='small', choices=['small', 'imu400'],
                    help='imu400 = the released IMU-conditioned ViT-B/4x4 '
                         'configuration')
    ap.add_argument('--img-size', type=int, default=112)
    loop.add_common_args(ap, batch_size=8, mask_ratio=0.9)
    return ap.parse_args(argv)


def build_model(args, device: torch.device) -> conj.ConjoinedVMAE:
    """small or imu400; bf16 with flash attention on CUDA, f32 with dense
    attention on the CPU."""
    dtype, attn = loop.dtype_and_attn(device)
    if args.model == 'imu400':
        if args.img_size != 224:
            raise SystemExit('--model imu400 requires --img-size 224')
        return conj.imu400_base_4x4patch_2frames_1tube(
            dtype=dtype, attn_impl=attn, device=device)
    sz = args.img_size
    ctx = conj.StreamSpec(
        is_imu=True, in_chans=6, sequence_length=400, imu_tubelet=16,
        encoder_embed_dim=64, encoder_depth=4, encoder_num_heads=4,
        decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4,
        decoder_num_classes=96, mlp_ratio=2.0, concat_dummy_token=False,
        padded=True, max_padding_tokens=25)
    main = conj.StreamSpec(
        img_size=(sz, sz), patch_size=(8, 8), in_chans=3, num_frames=2,
        encoder_embed_dim=96, encoder_depth=4, encoder_num_heads=4,
        decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
        mlp_ratio=2.0, padded=True, max_padding_tokens=64)
    return conj.ConjoinedVMAE(
        main=main, context=ctx, conjoin_encoder_layers=((0, 0), (2, 2)),
        conjoin_decoder_layers=((0, 0), (1, 1)), dtype=dtype,
        attn_impl=attn, device=device)


def mask_sampler(model: conj.ConjoinedVMAE, n_vis: int):
    """``(generator, b) -> (mask, mask_context)``: n_vis visible main
    tokens per row (those of the lowest uniform scores), the IMU fully
    visible (the IMU-conditioned training regime)."""
    n = model.main.num_patches

    def make_masks(g, b):
        scores = torch.rand((b, n), generator=g, device=g.device)
        order = torch.argsort(scores, dim=-1, stable=True)
        mask = torch.ones((b, n), dtype=torch.bool, device=g.device)
        mask.scatter_(1, order[:, :n_vis], False)
        mask_c = torch.zeros((b, model.context.num_patches),
                             dtype=torch.bool, device=g.device)
        return mask, mask_c
    return make_masks


def make_data(args, model: conj.ConjoinedVMAE, device: torch.device,
              start_step: int, batch_size: int, seed: int):
    """Yields (video [B, C, T, H, W] f32 in [0, 1], imu [B, 6, L, 1, 1])
    on ``device``: ``batch_size`` clips a batch from the stream ``seed``."""
    sz = args.img_size
    L = model.context.sequence_length
    rng = np.random.RandomState(seed + 1)

    def placeholder(b):
        return (rng.randn(b, 6, L) * 0.1).astype(np.float32)

    def to_dev(video, imu):
        return (video.to(device),
                torch.from_numpy(np.asarray(imu, np.float32))[..., None,
                                                              None].to(device))

    if args.synthetic:
        for _ in range(start_step):
            rng.rand(batch_size, 3, 8, 8)
            rng.randint(1, 5)
            placeholder(batch_size)
        while True:
            coarse = torch.from_numpy(
                rng.rand(batch_size, 3, 8, 8).astype(np.float32))
            img = resize_bilinear(coarse, (sz, sz))
            f2 = torch.roll(img, int(rng.randint(1, 5)), dims=-1)
            yield to_dev(torch.stack([img, f2], dim=2),
                         placeholder(batch_size))
    sidecar = read_imu_sidecar(args.shard)
    if sidecar is not None:
        if sidecar.shape[2] != L:
            raise SystemExit(f'IMU sidecar length {sidecar.shape[2]} != the '
                             f'model context sequence_length {L}')
        loop.say(f'imu sidecar: {sidecar.shape[0]} clips x '
                 f'{sidecar.shape[1]}ch x {sidecar.shape[2]}')
    else:
        for _ in range(start_step):
            placeholder(batch_size)
    loader = loop.shard_loader(args, (sz, sz), start_step, batch_size, seed)
    for clips in loader:                               # [B, T, C, H, W]
        video = torch.from_numpy(clips).transpose(1, 2)
        imu = (sidecar[loader.last_indices] if sidecar is not None
               else placeholder(video.shape[0]))
        yield to_dev(video, imu)


def main(argv=None):
    args = parse_args(argv)
    loop.check_args(args)
    device = resolve_device(args.device)
    dp = loop.data_parallel(args, device)
    model = build_model(args, device)
    optimizer = T.make_optimizer(learning_rate=args.lr,
                                 warmup_steps=args.warmup_steps,
                                 total_steps=args.steps)
    n = model.main.num_patches
    n_vis = max(1, int(round(n * (1 - args.mask_ratio))))
    n_vis_c = model.context.num_patches + int(model.context.concat_dummy_token)
    loop.say(f'main tokens={n} n_vis={n_vis} ctx n_vis={n_vis_c} '
             f'device={device} dtype={model.dtype} attn={model.attn_impl} '
             f'dp={dp.size} tp={dp.tp}')
    model.load_state_dict(weights.init_conjoined_state_dict(
        model, torch.Generator(device=device).manual_seed(args.seed)),
        strict=True)
    state = T.TrainState(0, model, optimizer.init(model.parameters()))
    ckpt, state, start = loop.resume(args, state)
    kw = dict(remat=not args.no_remat, mask_fn=mask_sampler(model, n_vis),
              accum_steps=args.accum_steps)
    if dp.mesh is None:
        train_step = T.make_conjoined_train_step(model, optimizer, n_vis,
                                                 n_vis_c, **kw)
    else:
        train_step, shard_state, _ = T.make_sharded_conjoined_train_step(
            model, optimizer, dp.mesh, n_vis, n_vis_c, **kw)
        state = shard_state(state)
    data = make_data(args, model, device, start, dp.batch_size, dp.data_seed)

    def step_fn(state, step):
        video, imu = next(data)
        return train_step(state, dp.put(video, device, args.batch_size),
                          dp.put(imu, device, args.batch_size),
                          loop.step_generator(device, args.seed, step))

    return loop.run(args, state, ckpt, start, step_fn, 'clips_per_sec')


if __name__ == '__main__':
    main()
