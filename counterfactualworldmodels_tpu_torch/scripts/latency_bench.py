"""p50 / p90 / p99 latency of one prediction, one click and one IMU click.

Port of the JAX package's ``scripts/latency_bench.py``. Each section times
``--iters`` calls from the host, each ending in one fetch of a device
scalar (the summed |prediction|), after two warm-up calls:

- the cold factual prediction: ``pipelines.prediction.predict_video`` on
  the exact VMAE at batch 1 (frame 0 and 32 frame-1 patches visible; K1 in
  every block on the card);
- ``warm_prefix``: the interactive click with a cached scene prefix, the
  S = 1 suffix pass of ``fast_vmae.predict_frame1_from_prefix`` (K2);
- ``warm_prefix_imu``: the IMU-conditioned click,
  ``fast_conjoined.predict_frame1_conjoined`` against a cached (scene,
  IMU) prefix: the imu400 ViT-B 4x4 model on the card, the small
  configuration on the CPU (there with ``--imu`` only).

Seeded random weights; each section also records its kernel launches per
call. A failing section raises (the JAX script records the error and goes
on).

    python -m counterfactualworldmodels_tpu_torch.scripts.latency_bench \\
        --model large
    python -m counterfactualworldmodels_tpu_torch.scripts.latency_bench \\
        --model tiny --iters 5 --imu --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from . import _bench_common as C


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--model', default='large',
                    choices=['large', 'base', 'tiny'],
                    help='ViT-L 4x4, ViT-B 8x8, or the bench\'s tiny '
                         'model (for runs on the CPU)')
    ap.add_argument('--imu', action='store_true',
                    help='also time the IMU-conditioned click on the CPU '
                         '(small configuration; on the card it always runs, '
                         'at imu400)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    return ap.parse_args(argv)


def cold_mask(model) -> np.ndarray:
    """[1, N] bool: frame 0 and the first 32 frame-1 patches visible."""
    n = model.num_patches
    npf = n // 2
    mask = np.ones((1, n), dtype=bool)
    mask[0, :npf + 32] = False
    return mask


def timed(fn, iters: int) -> dict:
    """Two warm-up calls, then ``iters`` timed ones (host ms around a call
    that ends in a device-scalar fetch): percentiles, the samples and one
    more call's kernel launches."""
    from .. import kernels
    fn()
    fn()
    lats = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        lats.append((time.perf_counter() - t0) * 1e3)
    out = C.percentiles(lats)
    kernels.reset_launches()
    fn()
    out['launches_per_call'] = dict(kernels.LAUNCHES)
    return out


@torch.no_grad()
def cold_prediction(module, x, mask, n_vis: int) -> torch.Tensor:
    """The factual prediction's frame 1 (the timed call)."""
    from ..pipelines.prediction import predict_video
    return predict_video(module, x, mask, n_vis, True, 1)


def main(argv=None):
    args = parse_args(argv)
    from ..models import fast_vmae, vmae
    from ..ops.normalization import imagenet_normalize
    from .bench import bench_config
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    dtype = torch.bfloat16 if cuda else torch.float32
    cfg = bench_config(args.model, dtype, 'flash' if cuda else 'dense')
    module = vmae.init_params(cfg, seed=0, device=dev)

    n = cfg.num_patches
    npf = n // 2
    mask = torch.from_numpy(cold_mask(cfg)).to(dev)
    n_vis = npf + 32
    rng = np.random.RandomState(args.seed)
    hw = cfg.img_size[0]
    x = torch.from_numpy(rng.rand(1, 2, 3, hw, hw).astype(np.float32)
                         ).to(dev)

    def run():
        return cold_prediction(module, x, mask, n_vis).abs().float().sum(
        ).item()

    rec = {'metric': f'single-prediction latency (ViT {args.model}, {hw}px, '
                     'batch 1)',
           'iters': args.iters, 'unit': 'ms'}
    rec.update(C.device_record(dev))
    rec.update(timed(run, args.iters))

    # the interactive click with a warm scene prefix (a PrefixLru hit:
    # only the S = 1 frame-1 suffix pass runs)
    fp = fast_vmae.stack_vmae_params(cfg, module.state_dict(), dtype, dev)
    xm = imagenet_normalize(x, temporal_dim=1)
    with torch.no_grad():
        cache = fast_vmae.encode_prefix(cfg, fp, xm[0:1, 0])
    vis1 = torch.from_numpy(rng.choice(npf, 33, replace=False)[None]).to(dev)

    def run_warm():
        with torch.no_grad():
            y1 = fast_vmae.predict_frame1_from_prefix(cfg, fp, cache,
                                                      xm[:, 1], vis1)
        return y1.abs().float().sum().item()

    rec['warm_prefix'] = timed(run_warm, args.iters)
    rec['warm_prefix']['note'] = ('S=1 suffix pass against a cached frame-0 '
                                  'prefix (PrefixLru hit); one device-scalar '
                                  'fetch per call')

    if cuda or args.imu:
        rec['warm_prefix_imu'] = imu_click(rng, dev, args.iters)
    print(json.dumps(rec), flush=True)
    return rec


def imu_click(rng, dev: torch.device, iters: int) -> dict:
    """The IMU-conditioned click: imu400 (ViT-B 4x4, bf16, flash) on the
    card, the small configuration on the CPU."""
    from ..models import conjoined as conj
    from ..models import fast_conjoined as fc
    from ..ops.normalization import imagenet_normalize
    from ..utils import weights
    cuda = dev.type == 'cuda'
    if cuda:
        cmodel = conj.imu400_base_4x4patch_2frames_1tube(
            dtype=torch.bfloat16, attn_impl='flash', device=dev)
        chw = 224
    else:
        cmodel, chw = C.small_conjoined_model(torch.float32, 'dense', dev)
    sd = weights.init_conjoined_state_dict(
        cmodel, torch.Generator(device=dev).manual_seed(2))
    cfp = fc.cast_params(cmodel, sd, device=dev)
    cn0 = cmodel.main.num_patches // 2
    cx = torch.from_numpy(rng.rand(1, 2, 3, chw, chw).astype(np.float32)
                          ).to(dev)
    cimu = torch.from_numpy((rng.randn(1, 6, cmodel.context.sequence_length)
                             * 0.1).astype(np.float32)).to(dev)
    cxm = imagenet_normalize(cx, temporal_dim=1).transpose(1, 2)
    ccache = fc.encode_conjoined_prefix(cmodel, cfp, cxm[0:1, :, 0], cimu)
    cvis1 = torch.from_numpy(rng.choice(cn0, 33, replace=False)[None]).to(dev)

    def run_warm_imu():
        y1 = fc.predict_frame1_conjoined(cmodel, cfp, ccache, cxm[:, :, 1],
                                         cvis1)
        return y1.abs().float().sum().item()

    out = timed(run_warm_imu, iters)
    out['note'] = ('S=1 conjoined suffix against a cached scene prefix '
                   '(ConjoinedPrefixLru hit; '
                   + ('imu400' if cuda else 'small config') + ')')
    return out


if __name__ == '__main__':
    main()
