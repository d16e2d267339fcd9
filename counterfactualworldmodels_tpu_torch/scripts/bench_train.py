"""Training-throughput bench: steps/s, clips/s and MFU per model family.

Port of the JAX package's ``scripts/bench_train.py``. Each family runs its
train step on synthetic data (the step is measured, not the input
pipeline): 2 warm-up steps, then ``CWM_TRAIN_BENCH_STEPS`` timed steps
closed by one host fetch of the last loss, then one more step whose kernel
launches are counted. On the card every attention forward of a step is K5
and every backward K6 (the RAFT family trains on the gather lookup, no
kernel). MFU is the family's FLOPs per step (``training/flops.py``) over
the step time, against the H100's dense bf16 peak; on the CPU it is not
stated.

Families (CWM_TRAIN_BENCH_FAMILIES, comma-separated; default all):

- ``vmae``: the VMAE at CWM_TRAIN_BENCH_MODEL (base | large | tiny,
  default base) with full remat; ``vmae_large``, ``vmae_large_accum``
  (2 microbatches), ``vmae_large_dots`` (remat saving the Linears'
  outputs), ``vmae_large_noremat``, ``vmae_large_dots_mu_bf16`` (Adam's
  first moment in bf16);
- ``loader``: the native loader feeding the ViT-B step (uint8, zero copy),
  with the input's share of the step;
- ``cmae``: train_cmae's ChannelMAE (ViT-B, 224 px, 32 px patches, batch
  32);
- ``conjoined``: the imu400 conjoined VMAE (batch 4);
- ``raft``: the large RAFT's flow step (224 px, batch 6, 12 iterations).

On the CPU each family runs its small configuration (f32, dense). One JSON
line per family, then the headline line (``train_clips_per_sec``: the
first family's rate). A failing family raises (the JAX script records the
error and goes on).

    python -m counterfactualworldmodels_tpu_torch.scripts.bench_train
    CWM_TRAIN_BENCH_FAMILIES=vmae,cmae CWM_TRAIN_BENCH_MODEL=tiny \\
        CWM_TRAIN_BENCH_STEPS=1 python -m \\
        counterfactualworldmodels_tpu_torch.scripts.bench_train --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .._device import resolve_device
from . import _bench_common as C

FAMILIES = ('vmae,vmae_large,vmae_large_dots,vmae_large_dots_mu_bf16,'
            'vmae_large_noremat,vmae_large_accum,loader,cmae,conjoined,raft')


def timed_steps(dev, steps: int, step_fn):
    """(seconds per step, launches of one step): ``step_fn(i)`` runs step
    i and returns its loss tensor; 2 warm-up steps, ``steps`` timed ones
    closed by one fetch of the last loss, then one counted step."""
    from .. import kernels
    for i in range(2):
        loss = step_fn(i)
    loss.item()
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step_fn(10 + i)
    loss.item()
    dt = (time.perf_counter() - t0) / steps
    kernels.reset_launches()
    step_fn(10 + steps).item()
    return dt, dict(kernels.LAUNCHES)


def _mfu(flops: int, dt: float, dev) -> float:
    return (round(flops / dt / C.H100_PEAK_FLOPS, 4) if dev.type == 'cuda'
            else None)


def _gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _vmae_config(name: str, dev):
    from ..training.loop import dtype_and_attn
    from .bench import bench_config
    return bench_config(name, *dtype_and_attn(dev))


def bench_vmae(dev, steps: int, model_name: str, accum_steps: int = 1,
               remat=True, mu_dtype=None) -> dict:
    """The VMAE step (mask ratio 0.9, rotated-table masks) at ``remat``
    (False, True = full, 'dots')."""
    from ..training import flops
    from ..training import train as T
    cuda = dev.type == 'cuda'
    cfg = _vmae_config(model_name, dev)
    # ViT-L at batch 8 does not fit the TPU v5e the JAX bench sized for;
    # the port keeps its batches
    batch = (4 if model_name == 'large' else 8) if cuda else 1
    batch = max(batch, accum_steps)
    opt = T.make_optimizer(mu_dtype=mu_dtype)
    state = T.init_train_state(cfg, opt, seed=0, device=dev)
    gen = _gen(dev, 0)
    _, n_vis = T.make_batch_masks(gen, cfg, batch, 0.9)

    def mask_fn(g, b):
        return T.make_batch_masks(g, cfg, b, 0.9)[0]

    step = T.make_train_step(cfg, opt, n_vis, mask_fn=mask_fn,
                             accum_steps=accum_steps, remat=remat,
                             device=dev)
    hw = cfg.img_size[0]
    x = torch.from_numpy(np.random.RandomState(0).rand(
        batch, 2, 3, hw, hw).astype(np.float32)).to(dev)

    def step_fn(i):
        return step(state, x, gen)[1]['loss']

    dt, launches = timed_steps(dev, steps, step_fn)
    fl = flops.vmae_train_flops(cfg, batch, n_vis)
    name = f'vmae_{model_name}' + (f'_accum{accum_steps}'
                                   if accum_steps > 1 else '')
    if remat is not True:
        name += f'_remat_{remat}'.replace('False', 'off')
    if mu_dtype is not None:
        name += '_mu_bf16'
    return {'family': name, 'batch': batch, 'accum_steps': accum_steps,
            'remat': str(remat), 'flash_bwd': 'K6' if cuda else 'plain',
            'sec_per_step': round(dt, 4),
            'clips_per_sec': round(batch / dt, 2),
            'train_flops_per_step': fl, 'mfu': _mfu(fl, dt, dev),
            'launches_per_step': launches}


def bench_loader_in_loop(dev, steps: int) -> dict:
    """The native loader (uint8, zero copy) feeding the ViT-B step (a small
    VMAE at 32 px on the CPU), against the same step on a resident batch:
    the input pipeline's share of a step."""
    from ..data import shards as D
    from ..models import vmae
    from ..training import train as T
    from ..training.loop import dtype_and_attn
    cuda = dev.type == 'cuda'
    dtype, attn = dtype_and_attn(dev)
    hw = 224 if cuda else 32
    cfg = (vmae.base_8x8patch_2frames_1tube(dtype=dtype, attn_impl=attn)
           if cuda else vmae.PretrainVisionTransformer(
               img_size=(hw, hw), patch_size=(8, 8), encoder_embed_dim=48,
               encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
               decoder_depth=1, decoder_num_heads=2, num_frames=2,
               dtype=dtype, attn_impl=attn))
    batch = 8 if cuda else 2
    rng = np.random.RandomState(0)
    opt = T.make_optimizer()
    state = T.init_train_state(cfg, opt, seed=0, device=dev)
    gen = _gen(dev, 0)
    _, n_vis = T.make_batch_masks(gen, cfg, batch, 0.9)

    def mask_fn(g, b):
        return T.make_batch_masks(g, cfg, b, 0.9)[0]

    step = T.make_train_step(cfg, opt, n_vis, mask_fn=mask_fn, device=dev)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, 'bench.clips')
        D.write_shard(path, (rng.rand(64, 2, hw, hw, 3) * 255)
                      .astype(np.uint8))
        loader = D.NativeClipLoader(path, batch_size=batch, num_threads=2,
                                    out_dtype='u8', zero_copy=True)
        try:
            def loader_step(i):
                xb = D.u8_to_chw_01(torch.from_numpy(
                    loader.next_batch()).to(dev))
                return step(state, xb, gen)[1]['loss']

            dt_loader, _ = timed_steps(dev, steps, loader_step)
        finally:
            loader.close()
    x = torch.from_numpy(rng.rand(batch, 2, 3, hw, hw).astype(np.float32)
                         ).to(dev)
    dt_synth, _ = timed_steps(dev, steps,
                              lambda i: step(state, x, gen)[1]['loss'])
    return {'family': 'vmae_base_loader_in_loop', 'batch': batch, 'img': hw,
            'sec_per_step': round(dt_loader, 4),
            'sec_per_step_synthetic': round(dt_synth, 4),
            'clips_per_sec': round(batch / dt_loader, 2),
            'input_share': round(max(0.0, 1 - dt_synth / dt_loader), 4)}


def bench_cmae(dev, steps: int) -> dict:
    """train_cmae's model and step at its defaults (ViT-B, 224 px, 32 px
    patches, batch 32, mask ratio 0.75); the tiny model at 32 px on the
    CPU."""
    from ..models import cmae
    from ..training import flops
    from ..training import train as T
    from ..training.train_cmae import build_model
    cuda = dev.type == 'cuda'
    args = argparse.Namespace(
        model='base' if cuda else 'tiny', img_size=224 if cuda else 32,
        patch_size=32 if cuda else 8)
    batch = 32 if cuda else 2
    model = build_model(args, (3,), dev)
    opt = T.make_optimizer()
    state = T.init_cmae_train_state(model, opt, 0)
    gen = _gen(dev, 0)
    _, counts = cmae.group_uniform_mask(gen, model.mask_size, 0.75, 1)
    n_vis = model.num_patches - sum(counts)

    def mask_fn(g, b):
        return cmae.group_uniform_mask(g, model.mask_size, 0.75, b)[0]

    step = T.make_cmae_train_step(model, opt, n_vis, counts, mask_fn=mask_fn)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        batch, 3, args.img_size, args.img_size).astype(np.float32)).to(dev)
    dt, launches = timed_steps(dev, steps,
                               lambda i: step(state, x, gen)[1]['loss'])
    # the count builds the same model on the meta device (f32, dense)
    fl = flops.cmae_train_flops(lambda d: build_model(args, (3,), d), batch,
                                n_vis, counts)
    return {'family': f'cmae_{args.model}', 'batch': batch,
            'img': args.img_size, 'sec_per_step': round(dt, 4),
            'clips_per_sec': round(batch / dt, 2),
            'train_flops_per_step': fl, 'mfu': _mfu(fl, dt, dev),
            'launches_per_step': launches}


def conjoined_model(device, small: bool):
    """imu400, or the JAX bench's small conjoined model at 32 px, on
    ``device``: bf16 with flash attention on the card, f32 dense
    elsewhere (the meta device included)."""
    from ..models import conjoined as conj
    from ..training.loop import dtype_and_attn
    dtype, attn = dtype_and_attn(device)
    if not small:
        return conj.imu400_base_4x4patch_2frames_1tube(
            dtype=dtype, attn_impl=attn, device=device)
    return conj.ConjoinedVMAE(
        main=conj.StreamSpec(img_size=(32, 32), patch_size=(8, 8),
                             encoder_embed_dim=48, encoder_depth=2,
                             encoder_num_heads=4, decoder_embed_dim=32,
                             decoder_depth=1, decoder_num_heads=4,
                             mlp_ratio=2.0, padded=True,
                             max_padding_tokens=8),
        context=conj.StreamSpec(is_imu=True, in_chans=6, sequence_length=32,
                                imu_tubelet=8, encoder_embed_dim=32,
                                encoder_depth=2, encoder_num_heads=4,
                                decoder_embed_dim=24, decoder_depth=1,
                                decoder_num_heads=4, decoder_num_classes=48,
                                mlp_ratio=2.0, concat_dummy_token=False,
                                padded=True, max_padding_tokens=4),
        conjoin_encoder_layers=((0, 0), (1, 1)),
        conjoin_decoder_layers=((0, 0),), dtype=dtype, attn_impl=attn,
        device=device)


def bench_conjoined(dev, steps: int) -> dict:
    """The conjoined step with a fixed mask (frame 0 and 2 frame-1 patches
    visible) and the whole IMU stream visible."""
    from ..training import flops
    from ..training import train as T
    from ..utils import weights
    cuda = dev.type == 'cuda'
    model = conjoined_model(dev, small=not cuda)
    batch, img = (4, 224) if cuda else (1, 32)
    model.load_state_dict(weights.init_conjoined_state_dict(
        model, _gen(dev, 0)), strict=True)
    opt = T.make_optimizer()
    state = T.TrainState(0, model, opt.init(model.parameters()))
    n = model.main.num_patches
    n_vis = n // 2 + 2
    n_vis_c = model.context.num_patches
    step = T.make_conjoined_train_step(model, opt, n_vis, n_vis_c)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 3, 2, img, img).astype(np.float32)
                         ).to(dev)
    mask = torch.ones(batch, n, dtype=torch.bool, device=dev)
    mask[:, :n_vis] = False
    seq = model.context.sequence_length
    xc = torch.from_numpy(rng.rand(batch, 6, seq, 1, 1).astype(np.float32)
                          ).to(dev)
    mc = torch.zeros(batch, n_vis_c, dtype=torch.bool, device=dev)
    dt, launches = timed_steps(
        dev, steps, lambda i: step(state, x, mask, xc, mc)[1]['loss'])
    fl = flops.conjoined_train_flops(
        lambda d: conjoined_model(d, small=not cuda), batch, n_vis, n_vis_c)
    return {'family': 'conjoined_imu', 'batch': batch, 'img': img,
            'sec_per_step': round(dt, 4),
            'clips_per_sec': round(batch / dt, 2),
            'train_flops_per_step': fl, 'mfu': _mfu(fl, dt, dev),
            'launches_per_step': launches}


def bench_raft(dev, steps: int) -> dict:
    """The RAFT flow step on synthetic warps: the large RAFT at 224 px,
    batch 6, 12 iterations (bf16); the small one at 64 px, batch 1, 2
    iterations on the CPU."""
    from ..models.raft.raft import RAFT
    from ..training import flops
    from ..training import raft as R
    from ..training import train as T
    cuda = dev.type == 'cuda'
    batch, hw, iters = (6, 224, 12) if cuda else (1, 64, 2)
    dtype = torch.bfloat16 if cuda else torch.float32

    def build(d):
        return RAFT(small=not cuda, iters=iters, dtype=dtype, device=d,
                    corr_lookup='gather')

    model = build(dev)
    opt = T.make_optimizer(learning_rate=4e-4)
    state = R.init_raft_train_state(model, opt, 0)
    step = R.make_raft_train_step(model, opt, iters=iters)
    ims = torch.from_numpy(np.random.RandomState(0).rand(
        batch, 3, hw, hw).astype(np.float32) * 255).to(dev)
    im1, im2, gt, valid = R.synthetic_flow_batch(ims, generator=_gen(dev, 1))
    dt, launches = timed_steps(
        dev, steps, lambda i: step(state, im1, im2, gt, valid)[1]['loss'])
    fl = flops.raft_train_flops(build, batch, hw, iters)
    return {'family': 'raft', 'batch': batch, 'img': hw, 'iters': iters,
            'sec_per_step': round(dt, 4),
            'pairs_per_sec': round(batch / dt, 2),
            'train_flops_per_step': fl, 'mfu': _mfu(fl, dt, dev),
            'launches_per_step': launches}


def run_family(fam: str, dev, steps: int, model_name: str) -> dict:
    if fam == 'vmae':
        return bench_vmae(dev, steps, model_name)
    if fam == 'vmae_large':
        return bench_vmae(dev, steps, 'large')
    if fam == 'vmae_large_accum':
        return bench_vmae(dev, steps, 'large', accum_steps=2)
    if fam == 'vmae_large_dots':
        return bench_vmae(dev, steps, 'large', remat='dots')
    if fam == 'vmae_large_noremat':
        return bench_vmae(dev, steps, 'large', remat=False)
    if fam == 'vmae_large_dots_mu_bf16':
        return bench_vmae(dev, steps, 'large', remat='dots',
                          mu_dtype=torch.bfloat16)
    if fam == 'loader':
        return bench_loader_in_loop(dev, steps)
    if fam == 'cmae':
        return bench_cmae(dev, steps)
    if fam == 'conjoined':
        return bench_conjoined(dev, steps)
    if fam == 'raft':
        return bench_raft(dev, steps)
    raise ValueError(f'unknown family {fam!r}; known: {FAMILIES}')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None,
                    help='also write every family\'s record here (JSON)')
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    env = os.environ
    steps = int(env.get('CWM_TRAIN_BENCH_STEPS', '8'))
    fams = [f for f in env.get('CWM_TRAIN_BENCH_FAMILIES', FAMILIES
                               ).split(',') if f]
    model_name = env.get('CWM_TRAIN_BENCH_MODEL', 'base')
    out = dict(C.device_record(dev), steps=steps, results=[])
    for fam in fams:
        t0 = time.time()
        r = run_family(fam, dev, steps, model_name)
        r['total_sec'] = round(time.time() - t0, 1)
        out['results'].append(r)
        print(json.dumps(r), flush=True)
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    r0 = out['results'][0]
    head = {'metric': 'train_clips_per_sec',
            'value': r0.get('clips_per_sec', r0.get('pairs_per_sec')),
            'unit': 'clips/s', 'family': r0['family'],
            'backend': out['backend']}
    print(json.dumps(head), flush=True)
    return out, head


if __name__ == '__main__':
    main()
