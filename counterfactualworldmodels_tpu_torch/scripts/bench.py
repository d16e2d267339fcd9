"""Benchmark: counterfactual simulations per second, ViT-L 4x4 @ 224 px.

Port of the JAX package's root ``bench.py``. One counterfactual simulation
is one motion prompt (frame 0 visible, 32 passive and 1 active frame-1
patch, a shift), run through the shared-prefix VMAE engine and probed by
RAFT with 24 refinement iterations: one dispatch of
``pipelines.segmentation.counterfactual_videos_and_flows_fast`` for S
prompts of one scene (bf16 on the card: K1 in the prefix, K2 in the suffix
decoder, the window lookup in every RAFT iteration).

The headline is the library default: the rung ``fast_vmae.resolve_pools``
gives for the model at 224 px (ViT-L 4x4: pool4 + suffix4 + tanh). Beside
it: the S-scaling probe (the headline takes the best per-simulation rate
over S), the rung ladder (the exact rung included), the per-stage ms
(prefix, suffix, RAFT), both FLOP counts of a dispatch, the executed MFU
against the H100's dense bf16 peak, the three timing windows and the
kernel launches of one dispatch.

Timing: one warm call, then 3 windows of 8 dispatches (1 on the CPU), each
closed by one host fetch of the summed |flow|; the minimum window counts.
Seeded random weights (``vmae`` seed 0, RAFT seed 1); the scene is
``--image`` (``.npy``, or PNG / JPEG with PIL) or a seeded random movie.

Env knobs (the JAX script's): CWM_BENCH_S (samples per scene, default 16;
2 on the CPU), CWM_BENCH_MODEL (large | base | tiny), CWM_BENCH_RAFT_ITERS
(default 24), CWM_BENCH_SBIG (S-probe sizes, default 64,128,256; the probe
runs on the card, or wherever the knob is set, unless CWM_BENCH_S pins S),
CWM_BENCH_RUNGS=0 (no rung ladder), CWM_PREFIX_POOL / CWM_SUFFIX_POOL /
CWM_FAST_GELU (pin the measured rung). Under ``torchrun`` with
WORLD_SIZE > 1 the S samples split over the ranks
(``parallel.inference.sharded_counterfactuals_fast``) and the rate is per
card. There is no fallback: any failure raises.

    python -m counterfactualworldmodels_tpu_torch.scripts.bench
    CWM_BENCH_MODEL=tiny CWM_BENCH_RAFT_ITERS=1 \\
        python -m counterfactualworldmodels_tpu_torch.scripts.bench \\
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .._device import resolve_device
from . import _bench_common as C

N_VIS_F1 = 33


def vit_flops(model, s, n_sfx, prefix_pool=1, suffix_pool=1):
    """Analytic MAC*2 count of one shared-prefix dispatch (S sims).

    prefix_pool / suffix_pool make it the executed count of the pooled
    rungs: pooling shrinks only the decoder attention's key set (the
    QKV / projection / MLP matmuls and all queries stay full resolution).
    With pools of 1 this is the exact-equivalent count."""
    n0 = model.num_patches_per_frame
    n1 = model.num_patches - n0
    de, dd = model.encoder_embed_dim, model.decoder_embed_dim
    Le, Ld = model.encoder_depth, model.decoder_depth

    def block(nq, nk, d, mlp=4):
        mm = 2 * nq * d * d * (3 + 1 + 2 * mlp)        # qkv + proj + mlp
        attn = 4 * nq * nk * d
        return mm + attn

    pt, ph, pw = model.full_patch_size
    patch_dim = pt * ph * pw * 3
    prefix = Le * block(n0, n0, de) + Ld * block(n0, n0, dd)
    prefix += 2 * n0 * de * dd                          # encoder_to_decoder
    nk_dec = n0 // prefix_pool ** 2 + n1 // suffix_pool ** 2
    suffix = s * (Le * block(n_sfx, n0 + n_sfx, de) +
                  Ld * block(n1, nk_dec, dd))
    embed = (n0 + s * n_sfx) * 2 * patch_dim * de
    head = s * n1 * 2 * dd * model.out_dim
    return prefix + suffix + embed + head


def raft_flops(s, hw=224, iters=24):
    """Rough analytic count: fnet / cnet ~5.4 GF per 224 px frame, one
    shared frame-0 pass and S frame-1 passes; ~3.75 GF per refinement
    iteration and sample (the update block's convolutions dominate)."""
    enc = 5.4e9 * (s + 2)
    per_iter = 3.75e9 * s
    corr = 2 * s * 784 * 784 * 256
    upsample = s * 784 * 9 * 64 * 2 * 2
    return enc + iters * per_iter + corr + upsample


def rung_label(ppool, spool, gelu):
    if (ppool, spool, gelu) == (1, 1, 'erf'):
        return 'exact-numerics'
    lbl = f'pooled{ppool}'
    if spool > 1:
        lbl += f'+suffix{spool}'
    if gelu != 'erf':
        lbl += f'+{gelu}'
    return lbl


def bench_config(name: str, dtype, attn_impl: str = 'flash'):
    """The VMAE configuration of CWM_BENCH_MODEL: large (ViT-L 4x4, the
    headline), base (ViT-B 8x8), both at 224 px, or tiny (a 2-block model
    at 64 px with 8 px patches, for runs on the CPU).
    ``attn_impl`` is the exact model's attention (the shared-prefix engine
    runs the kernels on the card and their plain versions on the CPU)."""
    from ..models import vmae
    kw = dict(dtype=dtype, attn_impl=attn_impl)
    if name == 'tiny':
        return vmae.PretrainVisionTransformer(
            img_size=(64, 64), patch_size=(8, 8), encoder_embed_dim=64,
            encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=48,
            decoder_depth=1, decoder_num_heads=4, num_frames=2,
            qkv_bias=True, **kw)
    if name == 'base':
        return vmae.base_8x8patch_2frames_1tube(**kw)
    if name == 'large':
        return vmae.large_4x4patch_2frames_1tube(**kw)
    raise ValueError(f'CWM_BENCH_MODEL must be large, base or tiny: {name!r}')


def build(name: str, device: torch.device, raft_iters: int):
    """(config, FastParams, RAFT) with seeded random weights on ``device``:
    bf16 on the card, f32 on the CPU."""
    from ..models import fast_vmae
    from ..models.raft.raft import RAFT
    from ..utils import weights
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    model = bench_config(name, dtype)
    g = torch.Generator(device=device)
    sd = weights.init_vmae_state_dict(model, g.manual_seed(0))
    fp = fast_vmae.stack_vmae_params(model, sd, dtype, device)
    raft = weights.init_raft(RAFT(iters=raft_iters, dtype=dtype,
                                  device=device), g.manual_seed(1))
    return model, fp, raft


def on_device(device, passive, active, shifts, n_vis, noise):
    """The demo prompts and their draws as tensors on ``device``, in the
    order ``dispatch`` takes them."""
    p, a, sh, nz = C.as_tensors(device, passive, active, shifts, noise)
    return p, a, sh, n_vis, nz


@torch.no_grad()
def dispatch(model, fp, raft, x, prompts, rung, raft_iters: int,
             mesh=None):
    """One counterfactual dispatch of the prompts (passive, active, shifts,
    n_vis, noise) on the scene x [1, 2, 3, H, W] at ``rung`` (prefix pool,
    suffix pool, gelu). Returns (videos, flows, masks) for all S."""
    from ..models import fast_vmae
    from ..pipelines.segmentation import counterfactual_videos_and_flows_fast
    p, a, shifts, n_vis, noise = prompts
    pp, sp, gelu = rung
    if mesh is not None:
        from ..parallel.inference import sharded_counterfactuals_fast
        return sharded_counterfactuals_fast(
            mesh, model, fp, raft, x, p, a, shifts, noise, n_vis, True,
            raft_iters, prefix_pool=pp, suffix_pool=sp, gelu=gelu)
    n0 = model.num_patches_per_frame
    pad = fast_vmae.sfx_bucket(n_vis - n0, model.num_patches - n0)
    return counterfactual_videos_and_flows_fast(
        model, fp, raft, x, p, a, shifts, noise, pad, True, raft_iters, True,
        None, pp, sp, gelu, n_vis=n_vis)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--image', default=None,
                    help='.npy [H, W, 3] scene (or PNG / JPEG with PIL); '
                         'default: a seeded random movie')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import kernels
    from ..models import fast_vmae
    from ..models.raft.raft import apply_raft_shared0
    from ..ops.normalization import imagenet_normalize
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    env = os.environ
    mesh, world, rank = C.sample_mesh(dev)
    bench_model = env.get('CWM_BENCH_MODEL', 'large')
    raft_iters = int(env.get('CWM_BENCH_RAFT_ITERS', 24))
    model, fp, raft = build(bench_model, dev, raft_iters)

    b = 1
    s = int(env.get('CWM_BENCH_S', 16 if cuda else 2))
    if mesh is not None and s % world:
        s = max(world, s - s % world)      # keep S divisible by the ranks
    n = model.num_patches
    npf = n // 2
    hw = model.img_size[0]
    rng = np.random.RandomState(args.seed)
    movie, source = C.demo_static_movie(hw, rng, b=b, image=args.image)
    x = torch.from_numpy(movie).to(dev)

    def build_prompts(s_):
        p, a, sh, n_vis = C.demo_prompts(rng, n, s_, b=b)
        return on_device(dev, p, a, sh, n_vis, C.demo_noise(s_, n - npf))

    _, ph, pw = model.full_patch_size
    grid = hw // ph
    rung = fast_vmae.resolve_pools(
        grid, hw // pw, env.get('CWM_PREFIX_POOL', 'auto') or 'auto',
        env.get('CWM_SUFFIX_POOL', 'auto') or 'auto',
        env.get('CWM_FAST_GELU', 'auto') or 'auto')
    engine = f'shared-prefix/default:{rung_label(*rung)}'
    per_window = 8 if cuda else 1

    def flow_sum(prompts, rung_):
        def fn():
            flows = dispatch(model, fp, raft, x, prompts, rung_, raft_iters,
                             mesh)[1]
            return flows.abs().float().sum()
        return fn

    def measure(fn, per):
        """(seconds per dispatch: the best window, every window's)."""
        fn().item()                            # warm-up
        ts = C.windows(fn, 3, per)
        return min(ts), ts

    def peak_gib():
        return (torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda
                else None)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prompts = build_prompts(s)
    fn = flow_sum(prompts, rung)
    fn().item()
    kernels.reset_launches()
    fn().item()
    launches = dict(kernels.LAUNCHES)
    dt, window_s = measure(fn, per_window)
    sims_per_sec = b * s / dt / world
    peak_mem = peak_gib()

    # the S-scaling probe of the same rung: scene-level work amortizes
    # over S, so the headline is the best per-simulation rate
    s_scaling = s_scaling_mem = None
    s_bigs = [int(v) for v in
              env.get('CWM_BENCH_SBIG', '64,128,256').split(',') if v]
    if ((cuda or 'CWM_BENCH_SBIG' in env) and s_bigs and mesh is None
            and 'CWM_BENCH_S' not in env):
        s_scaling = {f's{s}': round(sims_per_sec, 3)}
        s_scaling_mem = {}
        for s_big in s_bigs:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            dt_big, win_big = measure(flow_sum(build_prompts(s_big), rung), 3)
            rate_big = b * s_big / dt_big
            s_scaling[f's{s_big}'] = round(rate_big, 3)
            s_scaling_mem[f's{s_big}'] = peak_gib()
            if rate_big > sims_per_sec:
                sims_per_sec, s, dt, window_s = (rate_big, s_big, dt_big,
                                                 win_big)

    # the rung ladder at the headline S (the headline is the library
    # default above; the exact rung keeps the approximation's cost in view)
    rungs_out = None
    if env.get('CWM_BENCH_RUNGS', '1') != '0' and mesh is None:
        p3 = build_prompts(s)
        rungs_out = {'s': s, 'fidelity_ref': 'scripts.fidelity_report'}
        for r in [(1, 1, 'erf'), (2, 2, 'tanh'), (4, 4, 'erf'),
                  (4, 4, 'tanh')]:
            if r == tuple(rung):
                rungs_out[rung_label(*r)] = round(sims_per_sec, 3)
                continue
            if grid % r[0] or grid % r[1]:
                continue               # the grid does not split by this pool
            dtp, _ = measure(flow_sum(p3, r), per_window)
            rungs_out[rung_label(*r)] = round(b * s / dtp, 3)

    # per-stage ms (separate calls; small overhead each)
    xm = imagenet_normalize(x.expand(s, *x.shape[1:]), temporal_dim=1)
    vis1 = torch.from_numpy(np.stack([
        rng.choice(npf, N_VIS_F1, replace=False) for _ in range(s)])).to(dev)
    yv = torch.from_numpy(rng.rand(s, 2, 3, hw, hw).astype(np.float32)).to(dev)
    stage_iters = 6 if cuda else 1
    with torch.no_grad():
        cache = fast_vmae.encode_prefix(model, fp, xm[0:1, 0])
    stages = {
        'prefix_ms': C.stage_ms(lambda: fast_vmae.encode_prefix(
            model, fp, xm[0:1, 0]), stage_iters),
        'suffix_ms': C.stage_ms(lambda: fast_vmae.predict_frame1_from_prefix(
            model, fp, cache, xm[:, 1], vis1, prefix_pool=rung[0],
            suffix_pool=rung[1], gelu=rung[2]), stage_iters),
        'raft_ms': C.stage_ms(lambda: apply_raft_shared0(
            raft, yv, raft_iters, True), stage_iters),
    }

    exact_fl = vit_flops(model, s, N_VIS_F1) + raft_flops(s)
    exec_fl = vit_flops(model, s, N_VIS_F1, rung[0], rung[1]) + raft_flops(s)
    rec = {
        'metric': f'counterfactual sims/sec/card (ViT {bench_model}, '
                  f'{hw}px, RAFT-{raft_iters})',
        'value': round(sims_per_sec, 3),
        'unit': 'sims/sec/card',
        'vs_baseline': round(sims_per_sec / 100.0, 4),
        'config': dict({'b': b, 's': s, 'hw': hw, 'n_vis_f1': N_VIS_F1,
                        'engine': engine, 'raft_iters': raft_iters,
                        'model': bench_model, 'prefix_pool': rung[0],
                        'suffix_pool': rung[1], 'gelu': rung[2],
                        'library_default': True, 'mesh': world,
                        'image': source}, **C.device_record(dev)),
        'stages': stages,
        'window_ms': [round(v * 1e3, 3) for v in window_s],
        'launches_per_dispatch': launches,
        'tflops_per_dispatch': {'exact_equivalent': round(exact_fl / 1e12, 3),
                                'executed': round(exec_fl / 1e12, 3)},
        # a rate against the H100's peak only from a run on the card
        'mfu_executed': (round(exec_fl / dt / world / C.H100_PEAK_FLOPS, 4)
                         if cuda else None),
        'mfu_peak': C.H100_PEAK_NAME,
        'exact_equivalent_tflops_per_s': round(exact_fl / dt / world / 1e12,
                                               3),
    }
    if cuda:
        rec['peak_mem_gib'] = peak_mem
    if s_scaling is not None:
        rec['s_scaling'] = s_scaling
        rec['s_scaling_peak_mem_gib'] = s_scaling_mem
    if rungs_out is not None:
        rec['rungs'] = rungs_out
    if rank == 0:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    main()
