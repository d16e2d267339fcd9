"""Train RAFT: supervised optical flow, or keypoint-head distillation.

Port of scripts/train_raft.py, the fourth family's trainer, with the same
flags and defaults. Two modes:

- ``--mode flow``: the gamma-weighted sequence L1 against the ground truth
  of smooth synthetic warps (training/raft.synthetic_flow_batch) of a pool
  of frames: ``--synthetic`` noise images, the first frames of a
  ``--shard`` or a directory of ``--images``;
- ``--mode keypoint``: BCE distillation of the output_dim=1 head against
  dense target maps, from an ``--targets`` .npz (``images`` [N, 3, H, W]
  in 0-255 and ``targets`` [N, 1, H, W] in 0-1) or made on the fly by the
  counterfactual movability teacher (``--teacher movability``: one
  MovabilityPredictor estimate per image; CWM_TEACHER_PARAMS and
  CWM_TEACHER_RAFT name reference ``.pth`` checkpoints of its predictor
  and its RAFT, loaded strictly, else seeded random weights).

The port's conventions (training/loop.py): ``--device`` (bf16 on the card,
f32 on the CPU), rolling checkpoints through utils/checkpoint with an exact
resume (each step's batch indices and warp draws come from a generator
seeded from (seed, step)), JSONL metrics, ``--profile-dir`` with
torch.profiler, and ``--dp`` over processes launched by torchrun.

    python -m counterfactualworldmodels_tpu_torch.training.train_raft \\
        --mode flow --synthetic --small --img-size 64 --steps 20 --device cpu
    python -m counterfactualworldmodels_tpu_torch.training.train_raft \\
        --mode flow --shard clips.shard --steps 100000 --checkpoint-dir ckpt
    python -m counterfactualworldmodels_tpu_torch.training.train_raft \\
        --mode keypoint --targets maps.npz --steps 5000
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from .._device import resolve_device
from ..models.raft.raft import RAFT
from . import loop
from . import raft as R
from . import train as T


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--mode', default='flow', choices=['flow', 'keypoint'])
    ap.add_argument('--shard', default=None, help='CWMSHARD file path')
    ap.add_argument('--images', default=None,
                    help='directory of .png/.jpg images to warp (flow) or '
                         'distill on (keypoint + --teacher); needs PIL')
    ap.add_argument('--synthetic', action='store_true',
                    help='train on synthetic noise images (pipeline smoke)')
    ap.add_argument('--targets', default=None,
                    help='npz with images/targets for keypoint mode')
    ap.add_argument('--teacher', default=None, choices=[None, 'movability'],
                    help='generate keypoint targets on the fly from the '
                         'counterfactual movability pipeline')
    ap.add_argument('--teacher-model', default='base',
                    choices=['tiny', 'base'],
                    help='movability-teacher predictor size (tiny = smoke)')
    ap.add_argument('--teacher-samples', type=int, default=8,
                    help='counterfactual samples per teacher estimate')
    ap.add_argument('--small', action='store_true')
    ap.add_argument('--iters', type=int, default=12,
                    help='GRU iterations during training (inference uses '
                         '24; RAFT training conventionally 12)')
    ap.add_argument('--img-size', type=int, default=224)
    ap.add_argument('--pool-size', type=int, default=256,
                    help='frames drawn from --shard into the warp pool')
    ap.add_argument('--batch-size', type=int, default=8)
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--warmup-steps', type=int, default=100)
    ap.add_argument('--lr', type=float, default=4e-4)
    ap.add_argument('--weight-decay', type=float, default=1e-4)
    ap.add_argument('--gamma', type=float, default=0.8)
    ap.add_argument('--max-mag', type=float, default=8.0,
                    help='max synthetic warp magnitude in pixels')
    ap.add_argument('--cells', type=int, default=4,
                    help='synthetic warp field resolution')
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
                    help='gradient-accumulation microbatches per step '
                         '(flow mode)')
    loop.add_device_args(ap)
    return ap.parse_args(argv)


def load_image_pool(args, batch_size: int, seed: int) -> np.ndarray:
    """[N, 3, H, W] float32 in [0, 255] from --synthetic, --shard or
    --images; ``batch_size`` and ``seed`` are this rank's."""
    size = args.img_size
    if args.synthetic:
        rng = np.random.RandomState(seed)
        return rng.rand(max(batch_size, 8), 3, size, size) \
            .astype(np.float32) * 255.0
    if args.shard:
        loader = loop.shard_loader(args, (size, size), 0, batch_size, seed)
        frames, n = [], 0
        for clips in loader:                     # [B, T, C, H, W] in [0, 1]
            frames.append(np.asarray(clips[:, 0], np.float32) * 255.0)
            n += frames[-1].shape[0]
            if n >= args.pool_size:
                break
        pool = np.concatenate(frames)[:args.pool_size]
        loop.say(f'warp pool: {pool.shape[0]} frames from {args.shard}')
        return pool
    if not args.images:
        raise SystemExit('pass --synthetic, --shard PATH or --images DIR')
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit('--images needs PIL (Pillow), which this '
                         'installation lacks: use --shard or --synthetic')
    paths = sorted(glob.glob(os.path.join(args.images, '*.png')) +
                   glob.glob(os.path.join(args.images, '*.jpg')))
    if not paths:
        raise SystemExit(f'no images under {args.images}')
    ims = [np.asarray(Image.open(p).convert('RGB').resize((size, size)),
                      np.float32).transpose(2, 0, 1) for p in paths]
    return np.stack(ims)


def movability_targets(images: np.ndarray, args,
                       device: torch.device) -> np.ndarray:
    """One MovabilityPredictor estimate per image, min-max normalised:
    [N, 1, H, W] maps in [0, 1]. The predictor and its RAFT-12 load the
    reference checkpoints named by CWM_TEACHER_PARAMS / CWM_TEACHER_RAFT
    strictly, or take seeded random weights. Keypoints play no part (the
    keypoint head is what is being trained): patches are seeded
    uniformly."""
    from ..models import vmae
    from ..pipelines.movability import MovabilityPredictor
    from ..pipelines.prediction import (load_raft_checkpoint,
                                        load_vmae_checkpoint)
    from ..utils import weights
    dtype, attn = loop.dtype_and_attn(device)
    size = args.img_size
    if args.teacher_model == 'tiny':
        cfg = vmae.PretrainVisionTransformer(
            img_size=(size, size), patch_size=(8, 8), encoder_embed_dim=64,
            encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=48,
            decoder_depth=1, decoder_num_heads=4, mlp_ratio=2.0,
            qkv_bias=True, num_frames=2, tubelet_size=1, dtype=dtype,
            attn_impl=attn)
    else:
        cfg = vmae.base_8x8patch_2frames_1tube(img_size=(size, size),
                                               dtype=dtype, attn_impl=attn)
    params_path = os.environ.get('CWM_TEACHER_PARAMS')
    if params_path:
        params = load_vmae_checkpoint(params_path)
    else:
        params = weights.init_vmae_state_dict(
            cfg, torch.Generator(device=device).manual_seed(args.seed))
        loop.say('teacher: RANDOM-INIT predictor (set CWM_TEACHER_PARAMS '
                 'for a real teacher)')
    raft = RAFT(iters=12, dtype=dtype, device=device)
    raft_path = os.environ.get('CWM_TEACHER_RAFT')
    if raft_path:
        raft.load_state_dict(load_raft_checkpoint(raft_path), strict=True)
    else:
        weights.init_raft(raft, torch.Generator(device=device).manual_seed(
            args.seed + 1))
    psi = MovabilityPredictor(
        predictor=cfg, params=params, flow_model=raft, raft_iters=12,
        imagenet_normalize_inputs=True, seed=args.seed, device=device,
        initialize_from_keypoints=False, iterate_from_keypoints=False)
    outs = []
    for i in range(images.shape[0]):
        x = torch.from_numpy(images[i:i + 1]).to(device) / 255.0
        m = psi(torch.stack([x, x], 1),
                num_initial_samples=args.teacher_samples,
                num_samples_per_iteration=max(args.teacher_samples // 2, 2),
                num_iters=1)
        m = m.float().cpu().numpy().reshape(1, 1, *m.shape[-2:])
        lo, hi = m.min(), m.max()
        outs.append((m - lo) / max(hi - lo, 1e-6))
        loop.say(f'teacher map {i + 1}/{images.shape[0]}')
    return np.concatenate(outs)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dp = loop.data_parallel(args, device)
    keypoint = args.mode == 'keypoint'
    dtype, _ = loop.dtype_and_attn(device)
    model = RAFT(small=args.small, iters=args.iters,
                 output_dim=1 if keypoint else None, dtype=dtype,
                 device=device)
    optimizer = T.make_optimizer(learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 warmup_steps=args.warmup_steps,
                                 total_steps=args.steps)
    state = R.init_raft_train_state(model, optimizer, args.seed)
    ckpt, state, start = loop.resume(args, state)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    loop.say(f'device={name} dp={dp.size} mode={args.mode} '
             f'small={args.small} dtype={dtype}')

    step_kwargs = (dict(iters=args.iters) if keypoint else
                   dict(gamma=args.gamma, iters=args.iters,
                        accum_steps=args.accum_steps))
    if dp.mesh is None:
        mk = R.make_keypoint_distill_step if keypoint \
            else R.make_raft_train_step
        train_step = mk(model, optimizer, remat=not args.no_remat,
                        **step_kwargs)
    else:
        train_step, shard_state, _ = R.make_sharded_raft_train_step(
            model, optimizer, dp.mesh, keypoint=keypoint,
            remat=not args.no_remat, **step_kwargs)
        state = shard_state(state)

    if keypoint:
        if args.targets:
            data = np.load(args.targets)
            pool_img = np.asarray(data['images'], np.float32)
            pool_tgt = np.asarray(data['targets'], np.float32)
        elif args.teacher == 'movability':
            pool_img = load_image_pool(args, dp.batch_size, dp.data_seed)
            pool_tgt = movability_targets(pool_img, args, device)
        else:
            raise SystemExit('keypoint mode needs --targets or '
                             '--teacher movability')
        if pool_img.shape[0] != pool_tgt.shape[0]:
            raise SystemExit(f'{pool_img.shape[0]} images but '
                             f'{pool_tgt.shape[0]} targets')
    else:
        pool_img = load_image_pool(args, dp.batch_size, dp.data_seed)
    pool = torch.from_numpy(pool_img)

    def step_fn(state, step):
        # the step's batch indices and warp draws, on the host: a resumed
        # run draws what the uninterrupted one drew, on any device
        g = loop.step_generator(torch.device('cpu'), dp.data_seed, step)
        idx = torch.randint(0, pool.shape[0], (dp.batch_size,), generator=g)
        if keypoint:
            tgt = torch.from_numpy(pool_tgt)[idx]
            return train_step(state, dp.put(pool[idx], device,
                                            args.batch_size),
                              dp.put(tgt, device, args.batch_size))
        im1, im2, gt, valid = R.synthetic_flow_batch(
            pool[idx], cells=args.cells, max_mag=args.max_mag, generator=g)
        return train_step(state, *(dp.put(v, device, args.batch_size)
                                   for v in (im1, im2, gt, valid)))

    return loop.run(args, state, ckpt, start, step_fn, 'pairs_per_sec')


if __name__ == '__main__':
    main()
