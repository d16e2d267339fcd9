"""How far the shared-prefix engine moves the counterfactuals from the
exact model: videos, flows and the end products users read.

Port of the JAX package's ``scripts/fidelity_report.py``. On each image the
same prompts (32 passive patches and 1 active one per sample, shifts in
[-3, 3], drawn from numpy as the JAX script draws them) and the same
rectangularizer draws go through three things, each against the one exact
run:

- the exact model (``pipelines.segmentation.counterfactual_videos_and_flows``);
- the shared-prefix engine at the exact rung
  (``counterfactual_videos_and_flows_fast``);
- the engine at every ``--prefix-pools`` rung (prefix[:suffix[:gelu]]).

Each comparison reports the videos' and flows' agreement (correlation,
mean relative deviation, largest absolute error) and that of the end
products: the covariance-probe segment map at sample 0's active patch and
the minmax-normalised movability map (Pearson, Spearman, IoU of the top
decile). On the card (bf16) the first image also runs every leg in f32
(TF32 off), to split the deviation into bf16 numerics, prefix isolation
and pooling. The
conjoined (IMU-conditioned) engine is compared with its exact path too
(``--conjoined``: the released imu400 ViT-B 4x4 config, or a small one).

Weights are seeded random ones. Images: ``--images``, a glob of ``.npy``
[224, 224, 3] files (PNG / JPEG with PIL); with none given or none
matching, ``--max-images`` seeded random images.

Unlike the JAX script this one has no degrade chain and records no error
in place of a result: a failing kernel, rung, decomposition or conjoined
leg raises, and the run exits non-zero.

Writes the report to ``--out`` (one JSON object) and prints it.

    python -m counterfactualworldmodels_tpu_torch.scripts.fidelity_report \\
        --model large --samples 8 --max-images 2
    python -m counterfactualworldmodels_tpu_torch.scripts.fidelity_report \\
        --model base --samples 2 --max-images 1 --raft-iters 2 \\
        --prefix-pools 2:2 --conjoined small --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os

import numpy as np
import torch

from .._device import resolve_device
from ..utils import to_host
from ._timing import timed


def _pair_stats(ye, fe, yx, fx):
    """Agreement of (video, flow) pairs: correlation, mean relative
    deviation, and max per-pixel absolute error (videos are [0,1]-scaled
    pixels; flow is in pixels of displacement)."""
    ye = np.asarray(ye, np.float32).ravel()
    yx = np.asarray(yx, np.float32).ravel()
    fe = np.asarray(fe, np.float32).ravel()
    fx = np.asarray(fx, np.float32).ravel()
    return {
        'video_corr': round(float(np.corrcoef(ye, yx)[0, 1]), 5),
        'flow_corr': round(float(np.corrcoef(fe, fx)[0, 1]), 5),
        'flow_mean_rel_dev': round(float(
            np.abs(fe - fx).mean() / (np.abs(fe).mean() + 1e-8)), 5),
        'video_max_abs_err': round(float(np.abs(ye - yx).max()), 5),
        'flow_max_abs_err': round(float(np.abs(fe - fx).max()), 5),
    }


def _end_products(flows, probe_yx, ds=2):
    """(segment map, movability map) from one batch of counterfactual
    flows [S, 1, 2, H, W].

    segment = the probe row of the pixel x pixel flow-magnitude covariance
    (one row instead of the full [hw x hw] matrix) at pixel ``probe_yx``;
    movability = the minmax-normalised mean flow magnitude over samples."""
    fs = np.asarray(flows, np.float32)[:, 0]            # [S, 2, H, W]
    mags = np.sqrt((fs ** 2).mean(1))                   # [S, H, W] (RMS
    # over the flow channels)
    s, h, w = mags.shape
    mov = mags.mean(0)
    mov = (mov - mov.min()) / max(float(mov.max() - mov.min()), 1e-8)
    m_ds = mags.reshape(s, h // ds, ds, w // ds, ds).mean((2, 4))
    mc = m_ds - m_ds.mean(0)
    probe = mc[:, probe_yx[0] // ds, probe_yx[1] // ds]
    seg = (mc * probe[:, None, None]).mean(0)           # covariance row
    return seg, mov


def _map_agreement(a, b, top_q=0.9):
    """Agreement of two spatial maps: Pearson and Spearman correlation and
    the IoU of their top-decile pixel sets."""
    from scipy.stats import spearmanr
    av, bv = np.asarray(a).ravel(), np.asarray(b).ravel()
    ta, tb = np.quantile(av, top_q), np.quantile(bv, top_q)
    ma, mb = av >= ta, bv >= tb
    inter, union = (ma & mb).sum(), (ma | mb).sum()
    return {
        'pearson': round(float(np.corrcoef(av, bv)[0, 1]), 5),
        'spearman': round(float(spearmanr(av, bv).statistic), 5),
        'iou_top10pct': round(float(inter) / max(int(union), 1), 5),
    }


def parse_pools(spec: str):
    """'2:1,4:4:tanh' -> [(2, 1, 'erf'), (4, 4, 'tanh')]."""
    pools = []
    for v in spec.split(','):
        if not v.strip():
            continue
        parts = v.split(':')
        pools.append((int(parts[0]),
                      int(parts[1]) if len(parts) > 1 and parts[1] else 1,
                      parts[2] if len(parts) > 2 else 'erf'))
    return pools


def rung_key(pool: int, spool: int, gelu: str) -> str:
    key = f'pool{pool}'
    if spool > 1:
        key += f'_suffix{spool}'
    if gelu != 'erf':
        key += f'_{gelu}'
    return key


def draw_prompts(rng: np.random.RandomState, n: int, s: int):
    """The JAX script's prompts for one image: per sample 32 visible
    passive patches and 1 visible active patch in frame 1 (frame 0 fully
    visible in both), shifts in [-3, 3]. Returns (passive [1, N, S],
    active [1, N, S], shifts [1, S, 2] int32, active patch per sample)."""
    npf = n // 2
    passive = np.ones((1, n, s), dtype=bool)
    passive[:, :npf] = False
    active = np.ones((1, n, s), dtype=bool)
    active[:, :npf] = False
    a_idx = []
    for i in range(s):
        passive[0, npf + rng.choice(npf, 32, replace=False), i] = False
        ai = rng.randint(npf)
        a_idx.append(ai)
        active[0, npf + ai, i] = False
    shifts = rng.randint(-3, 4, size=(1, s, 2)).astype(np.int32)
    return passive, active, shifts, a_idx


class Legs:
    """The exact model and the engine on one VMAE + RAFT pair at one
    dtype: ``exact(...)`` and ``fast(..., rung)`` return (videos
    [S, 2, C, H, W], flows [S, 1, 2, H, W]). ``log`` (a list, or None)
    collects each leg's milliseconds and kernel launches
    (scripts/_timing.timed)."""

    def __init__(self, model, state_dict, raft, dtype, device, log=None):
        from ..models import fast_vmae
        from ..models.vmae import PretrainVisionTransformerModule
        self.device = resolve_device(device)
        self.model = dataclasses.replace(model, dtype=dtype)
        self.raft = raft
        module = PretrainVisionTransformerModule(
            dataclasses.replace(self.model, attn_impl='flash'),
            device=self.device)
        module.load_state_dict(state_dict, strict=True)
        self.module = module.eval()
        self.fast_params = fast_vmae.stack_vmae_params(
            self.model, state_dict, dtype=dtype, device=self.device)
        self.log = log

    @torch.no_grad()
    def exact(self, x, passive, active, shifts, noise, n_vis, raft_iters,
              name='exact'):
        from ..pipelines.segmentation import counterfactual_videos_and_flows
        y, f, _ = timed(
            self.log, name, self.device,
            lambda: counterfactual_videos_and_flows(
                self.module, self.raft, x, passive, active, shifts, noise,
                n_vis, True, raft_iters, True, device=self.device))
        return y, f

    @torch.no_grad()
    def fast(self, x, passive, active, shifts, noise, n_vis, raft_iters,
             rung=(1, 1, 'erf'), name='fast'):
        from ..models.fast_vmae import sfx_bucket
        from ..pipelines.segmentation import (
            counterfactual_videos_and_flows_fast)
        n0 = self.model.num_patches_per_frame
        pad = sfx_bucket(n_vis - n0, self.model.num_patches - n0)
        y, f, _ = timed(
            self.log, name, self.device,
            lambda: counterfactual_videos_and_flows_fast(
                self.model, self.fast_params, self.raft, x, passive, active,
                shifts, noise, pad, True, raft_iters, True, None, *rung,
                n_vis=n_vis))
        return y, f


def image_row(legs: Legs, x, passive, active, shifts, noise, n_vis,
              raft_iters, pools, probe_yx):
    """One image's row: the engine at the exact rung and at each pooled
    rung against the exact model. Returns (row without the image name,
    {leg: (videos, flows)} on the host)."""
    y_e, f_e = (to_host(v) for v in legs.exact(x, passive, active, shifts,
                                             noise, n_vis, raft_iters))
    seg_e, mov_e = _end_products(f_e, probe_yx)

    def vs_exact(y_x, f_x):
        stats = _pair_stats(y_e, f_e, y_x, f_x)
        seg_x, mov_x = _end_products(f_x, probe_yx)
        stats['segment'] = _map_agreement(seg_e, seg_x)
        stats['movability'] = _map_agreement(mov_e, mov_x)
        return stats

    arrays = {'exact': (y_e, f_e)}
    arrays['fast'] = tuple(to_host(v) for v in legs.fast(
        x, passive, active, shifts, noise, n_vis, raft_iters))
    row = vs_exact(*arrays['fast'])
    for rung in pools:
        key = rung_key(*rung)
        arrays[key] = tuple(to_host(v) for v in legs.fast(
            x, passive, active, shifts, noise, n_vis, raft_iters, rung,
            name=key))
        row[key] = vs_exact(*arrays[key])
    return row, arrays


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and cuDNN's convolutions (PyTorch lets the
    convolutions use TF32 by default), restored after: the decomposition's
    f32 legs are f32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def decomposition(legs32: Legs, bf16_arrays, x, passive, active, shifts,
                  noise, n_vis, raft_iters, pools):
    """Every leg again in f32 on the same prompts, splitting the bf16
    deviation: isolation = fast f32 vs exact f32, bf16 = each engine in
    f32 vs bf16, pooling = a pooled rung in f32 vs the fast f32 leg."""
    y_e, f_e = bf16_arrays['exact']
    y_f, f_f = bf16_arrays['fast']
    y_e32, f_e32 = (to_host(v) for v in legs32.exact(
        x, passive, active, shifts, noise, n_vis, raft_iters,
        name='exact f32'))
    y_f32, f_f32 = (to_host(v) for v in legs32.fast(
        x, passive, active, shifts, noise, n_vis, raft_iters,
        name='fast f32'))
    out = {
        'note': 'flow_mean_rel_dev attribution: isolation = fast_f32 vs '
                'exact_f32; bf16 = each engine f32 vs bf16; total = '
                'fast_bf16 vs exact_bf16',
        'exact_bf16_vs_exact_f32': _pair_stats(y_e32, f_e32, y_e, f_e),
        'fast_bf16_vs_fast_f32': _pair_stats(y_f32, f_f32, y_f, f_f),
        'fast_f32_vs_exact_f32_isolation': _pair_stats(y_e32, f_e32, y_f32,
                                                       f_f32),
        'fast_bf16_vs_exact_bf16_total': _pair_stats(y_e, f_e, y_f, f_f),
    }
    for pool, spool, gelu in pools:
        if (pool, spool) == (1, 1):
            continue
        key = f'pool{pool}_suffix{spool}_{gelu}'
        y_p32, f_p32 = (to_host(v) for v in legs32.fast(
            x, passive, active, shifts, noise, n_vis, raft_iters,
            (pool, spool, gelu), name=f'{key} f32'))
        out[f'{key}_f32_vs_exact_f32'] = _pair_stats(y_e32, f_e32, y_p32,
                                                     f_p32)
        out[f'{key}_f32_vs_fast_f32_pooling_only'] = _pair_stats(
            y_f32, f_f32, y_p32, f_p32)
    return out


def conjoined_model(mode: str, dtype, device):
    """(model, image size): the released imu400 ViT-B 4x4 config
    ('flagship') or a reduced one that runs on the CPU ('small')."""
    from ..models import conjoined as conj
    if mode == 'flagship':
        return conj.imu400_base_4x4patch_2frames_1tube(dtype=dtype,
                                                       device=device), 224
    if mode != 'small':
        raise ValueError(f'conjoined mode must be flagship or small: {mode!r}')
    ctx = conj.StreamSpec(
        is_imu=True, in_chans=6, sequence_length=400, imu_tubelet=16,
        encoder_embed_dim=64, encoder_depth=4, encoder_num_heads=4,
        decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4,
        decoder_num_classes=96, mlp_ratio=2.0, concat_dummy_token=False,
        padded=True, max_padding_tokens=25)
    main = conj.StreamSpec(
        img_size=(112, 112), patch_size=(8, 8), in_chans=3, num_frames=2,
        encoder_embed_dim=96, encoder_depth=4, encoder_num_heads=4,
        decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
        mlp_ratio=2.0, padded=True, max_padding_tokens=64)
    return conj.ConjoinedVMAE(main=main, context=ctx,
                              conjoin_encoder_layers=((0, 0), (2, 2)),
                              conjoin_decoder_layers=((0, 0), (1, 1)),
                              dtype=dtype, device=device), 112


def conjoined_fidelity(images, mode, args, device, dtype, log=None):
    """Fast-vs-exact agreement of the conjoined (IMU-conditioned) engine
    on the movability workload's shape, with seeded weights and a fixed
    random IMU embedding standing in for the static-scene IMU. images:
    [(name, read(size) -> float32 [size, size, 3])]."""
    from ..models import conjoined as conj
    from ..models.raft.raft import RAFT
    from ..pipelines.imu import ImuConditionedFlowGenerator
    from ..utils import weights
    model, hw = conjoined_model(mode, dtype, device)
    params = weights.init_conjoined_state_dict(
        model, torch.Generator(device=device).manual_seed(0))
    w = conj.ConjoinedPredictorWrapper(model, params=params,
                                       main_input='rgb01',
                                       context_input='imu')
    raft = weights.init_raft(
        RAFT(iters=args.raft_iters, dtype=dtype, device=device),
        torch.Generator(device=device).manual_seed(1))

    n = w.num_patches
    n0 = model.main.num_patches // model.main.num_frames
    s = args.samples
    rng = np.random.RandomState(args.seed + 7)
    head = (rng.randn(1, model.context.num_patches,
                      model.context.imu_tubelet * model.context.in_chans)
            * 0.1).astype(np.float32)

    per_image = []
    for name, read in images:
        fr = read(hw).transpose(2, 0, 1)
        x = np.stack([fr, fr], axis=0)[None]
        active = np.ones((1, n, s), dtype=bool)
        active[:, :n0] = False
        for i in range(s):
            active[0, n0 + rng.randint(n0), i] = False
        shifts = [tuple(v) for v in rng.randint(-3, 4, size=(s, 2))]

        outs = {}
        for engine in ('exact', 'fast'):
            g = ImuConditionedFlowGenerator(
                predictor=w, head_motion_predictor=w, flow_model=raft,
                raft_iters=args.raft_iters, imagenet_normalize_inputs=True,
                seed=args.seed, engine=engine, device=device)
            with torch.no_grad():
                y, f = timed(
                    log, f'conjoined {engine}', device,
                    lambda: g.predict_counterfactual_videos_and_flows(
                        x, active_patches=active, shifts=shifts,
                        num_samples=s, sample_batch_size=s,
                        head_motion=head))
            outs[engine] = (to_host(y), to_host(f))
        ye, fe = outs['exact']
        yf, ff = outs['fast']
        per_image.append({
            'image': name,
            'video_corr': round(float(np.corrcoef(ye.ravel(),
                                                  yf.ravel())[0, 1]), 5),
            'flow_corr': round(float(np.corrcoef(fe.ravel(),
                                                 ff.ravel())[0, 1]), 5),
            'flow_mean_rel_dev': round(float(
                np.abs(fe - ff).mean() / (np.abs(fe).mean() + 1e-8)), 5),
        })
    return {
        'engine': 'conjoined shared-prefix (models/fast_conjoined.py)',
        'config': mode,
        'per_image': per_image,
        'min_flow_corr': min(r['flow_corr'] for r in per_image),
        'min_video_corr': min(r['video_corr'] for r in per_image),
    }


def image_sources(pattern, max_images: int, seed: int):
    """[(name, read(size))] from the glob (at most max_images), or
    max_images seeded random images when the glob is empty or matches
    nothing; and the label the report gives them."""
    from ._io import read_image
    paths = sorted(glob.glob(pattern))[:max_images] if pattern else []
    if paths:
        return ([(os.path.basename(p),
                  lambda size, p=p: read_image(p, size)) for p in paths],
                pattern)

    def seeded(i):
        return lambda size: np.random.RandomState(seed + 1000 + i).rand(
            size, size, 3).astype(np.float32)

    return ([(f'seeded_{i}', seeded(i)) for i in range(max_images)],
            'seeded random')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--samples', type=int, default=8)
    ap.add_argument('--images', default=None,
                    help='glob of .npy [224, 224, 3] images (PNG / JPEG '
                         'with PIL); none matching: seeded random images')
    ap.add_argument('--max-images', type=int, default=3)
    ap.add_argument('--out', default=os.path.join('demo_out_torch',
                                                  'fidelity.json'))
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--model', default='large', choices=['large', 'base'],
                    help='base is light enough for CPU smoke runs')
    ap.add_argument('--raft-iters', type=int, default=24)
    ap.add_argument('--prefix-pools', default='2:1,2:2,2:2:tanh,4:4,4:4:tanh',
                    help='comma-separated prefix[:suffix[:gelu]] pool '
                         'configs to also measure vs exact (empty = '
                         'none), e.g. "2:1,2:2,4:4:tanh"')
    ap.add_argument('--no-decompose', action='store_true',
                    help='skip the f32 bf16-vs-isolation decomposition '
                         'legs (they re-run exact+fast+pooled in f32 on '
                         'the first image)')
    ap.add_argument('--conjoined', default='auto',
                    choices=['auto', 'flagship', 'small', 'off'],
                    help='also measure the conjoined (IMU) engine: '
                         "'flagship' = the released imu400 ViT-B/4x4 "
                         "config, 'small' = a reduced config for CPU, "
                         "'auto' = flagship on the card / small on CPU")
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..models import vmae
    from ..models.raft.raft import RAFT
    from ..utils import weights
    from ..utils.cache import enable_persistent_cache
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    if cuda:
        enable_persistent_cache()
    dtype = torch.bfloat16 if cuda else torch.float32
    factory = (vmae.large_4x4patch_2frames_1tube if args.model == 'large'
               else vmae.base_8x8patch_2frames_1tube)
    model = factory(dtype=dtype)
    sd = weights.init_vmae_state_dict(
        model, torch.Generator(device=dev).manual_seed(0))
    raft = weights.init_raft(RAFT(iters=args.raft_iters, dtype=dtype,
                                  device=dev),
                             torch.Generator(device=dev).manual_seed(1))
    log = []
    legs = Legs(model, sd, raft, dtype, dev, log)

    n = model.num_patches
    npf = n // 2
    s = args.samples
    n_vis = npf + 32 + 1
    rng = np.random.RandomState(args.seed)
    pools = parse_pools(args.prefix_pools)
    hw = model.img_size[0]       # 224 for both released configurations
    psz = model.full_patch_size[-1]
    grid = hw // psz
    images, label = image_sources(args.images, args.max_images, args.seed)

    per_image, decompose = [], None
    for name, read in images:
        fr = torch.from_numpy(read(hw).transpose(2, 0, 1).copy())
        x = torch.stack([fr, fr], 0)[None].to(dev)
        passive, active, shifts, a_idx = draw_prompts(rng, n, s)
        passive, active, shifts = (torch.from_numpy(v).to(dev)
                                   for v in (passive, active, shifts))
        # the rectangularizer's draws: the same for every leg, and for
        # every image (the JAX script splits one key per image alike)
        noise = torch.rand(1, s, npf, device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.seed + 1)) * 0.999
        # covariance probe pixel = sample 0's active patch centre
        probe_yx = ((a_idx[0] // grid) * psz + psz // 2,
                    (a_idx[0] % grid) * psz + psz // 2)
        row, arrays = image_row(legs, x, passive, active, shifts, noise,
                                n_vis, args.raft_iters, pools, probe_yx)
        per_image.append({'image': name, **row})
        if (decompose is None and dtype != torch.float32
                and not args.no_decompose):
            legs32 = Legs(model, sd, RAFT(iters=args.raft_iters,
                                          dtype=torch.float32, device=dev),
                          torch.float32, dev, log)
            legs32.raft.load_state_dict(raft.state_dict(), strict=True)
            with strict_f32():
                decompose = {'image': name, **decomposition(
                    legs32, arrays, x, passive, active, shifts, noise, n_vis,
                    args.raft_iters, pools)}
            del legs32
            if cuda:
                torch.cuda.empty_cache()

    conjoined = None
    if args.conjoined != 'off':
        mode = args.conjoined
        if mode == 'auto':
            mode = 'flagship' if cuda else 'small'
        conjoined = conjoined_fidelity(images, mode, args, dev, dtype, log)

    report = {
        'engine': 'shared-prefix (models/fast_vmae.py)',
        'weights': 'random-init (seeded; no released checkpoint is read)',
        'samples_per_image': s,
        'model': args.model,
        'raft_iters': args.raft_iters,
        'backend': dev.type,
        'images': label,
        'per_image': per_image,
        'min_flow_corr': min(r['flow_corr'] for r in per_image),
        'min_video_corr': min(r['video_corr'] for r in per_image),
        'min_segment_spearman': min(r['segment']['spearman']
                                    for r in per_image),
        'min_movability_pearson': min(r['movability']['pearson']
                                      for r in per_image),
        'max_video_abs_err': max(r['video_max_abs_err'] for r in per_image),
        'legs': log,
    }
    if decompose is not None:
        report['bf16_vs_isolation_decomposition'] = decompose
    if conjoined is not None:
        report['conjoined'] = conjoined
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == '__main__':
    main()
