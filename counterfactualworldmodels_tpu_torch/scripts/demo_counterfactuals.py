"""The demo: factual prediction, a counterfactual motion prompt, Spelke
segments, motion maps, motion covariance and movability on one image.

Port of the JAX package's ``demo/demo_counterfactuals.py``, the script
equivalent of the demo notebooks. ``--checkpoint_dir`` with the released
reference ``.pth`` files reproduces the paper's outputs; without them the
models take seeded random weights (the pipeline runs, the maps are not the
paper's). ``--image`` takes a ``.npy`` [H, W, 3] (or a PNG / JPEG with
PIL); without one a seeded random image stands in. The PNGs are written
without matplotlib (utils/png.py, with the ``inferno`` and ``RdBu_r``
maps the JAX script passes).

    python -m counterfactualworldmodels_tpu_torch.scripts.demo_counterfactuals
    python -m counterfactualworldmodels_tpu_torch.scripts.demo_counterfactuals \\
        --model large --movability
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from ..utils import to_host
from ._timing import timed

CHECKPOINTS = {'base': 'cwm_baseVMAE_224px_8x8patches_2frames.pth',
               'large': 'cwm_largeVMAE_224px_4x4patches_2frames.pth'}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--image', default=None)
    ap.add_argument('--checkpoint_dir', default=None)
    ap.add_argument('--model', default='base', choices=['base', 'large'])
    ap.add_argument('--samples', type=int, default=8)
    ap.add_argument('--raft_iters', type=int, default=12)
    ap.add_argument('--out', default='demo_out_torch')
    ap.add_argument('--movability', action='store_true')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def make_movability(G, samples: int, raft_iters: int):
    """The demo's MovabilityPredictor on G's models: no keypoint
    initialisation, two iterations of ``samples`` counterfactuals."""
    from ..pipelines import MovabilityPredictor
    return MovabilityPredictor(
        predictor=G.predictor, params=G.params, flow_model=G.flow_model,
        raft_iters=raft_iters, imagenet_normalize_inputs=True, seed=0,
        initialize_from_keypoints=False, num_initial_samples=samples,
        num_samples_per_iteration=samples, num_iters=2,
        sample_batch_size=samples, device=G.device)


@torch.no_grad()
def run_demo(G, x, out: str, samples: int = 8, movability=False,
             raft_iters: int = 12, log=None) -> Dict[str, np.ndarray]:
    """The demo's four steps on a FlowGenerator G (with its mask generator)
    and an image x [1, 3, H, W] in [0, 1]; writes each map as a PNG under
    ``out`` and returns the arrays it writes, by file stem (and the flows
    they come from). ``movability``: False, True (make_movability) or a
    MovabilityPredictor to run. ``log`` (a list, or None) collects each
    step's milliseconds and kernel launches (scripts/_timing.timed)."""
    from ..ops.flow_viz import flow_to_rgb
    from ..utils.png import imsave
    os.makedirs(out, exist_ok=True)
    x = G._tensor(x)
    grid = x.shape[-1] // G.patch_size[-1]
    arrays = {}

    def save(name, arr, cmap=None):
        arrays[name] = arr
        imsave(os.path.join(out, name + '.png'), arr, cmap=cmap)

    # 1. factual prediction
    video = x[:, None].expand(1, 2, *x.shape[1:])
    pred = timed(log, 'factual', G.device, lambda: G(video))
    save('factual_pred',
         np.clip(to_host(pred[0, 0]).transpose(1, 2, 0), 0, 1))
    print('factual prediction ->', os.path.join(out, 'factual_pred.png'))

    # 2. one counterfactual: move the centre patch right
    n = G.predictor.num_patches
    npf = n // 2
    active = np.ones((1, n), bool)
    active[0, :npf] = False
    active[0, npf + (grid // 2) * grid + grid // 2] = False
    _, flows = timed(
        log, 'counterfactual', G.device,
        lambda: G.predict_counterfactual_videos_and_flows(
            x, active_patches=active, shifts=[(0, 2)], num_samples=1,
            sample_batch_size=1))
    rgb = flow_to_rgb(flows[0, 0], max_speed=max(
        float(flows.abs().max()), 1e-3))
    arrays['flows'] = to_host(flows)
    save('counterfactual_flow',
         np.clip(to_host(rgb).transpose(1, 2, 0), 0, 1))
    seg = G.compute_mean_motion_map(G._batch_to_samples(flows))
    save('spelke_segment', to_host(seg[0, 0]), 'inferno')
    print('counterfactual flow + Spelke segment saved')

    # 3. batched random counterfactuals + covariance
    flows_s, _, _ = timed(
        log, 'motion map', G.device,
        lambda: G.sample_counterfactual_motion_map(
            x, num_active_patches=1, num_passive_patches=1,
            num_samples=samples, sample_batch_size=samples))
    arrays['flow_samples'] = to_host(flows_s)
    motion = G.compute_mean_motion_map(flows_s)
    save('mean_motion_map', to_host(motion[0, 0]), 'inferno')
    corrs = G.compute_flow_corrs(flows_s, downsample=4)
    center = corrs[0, 0, corrs.shape[2] // 2, corrs.shape[3] // 2]
    save('motion_covariance_center', to_host(center), 'RdBu_r')
    print('mean motion map + covariance probe saved')

    # 4. movability (optional; heavier)
    if movability is not False and movability is not None:
        M = (make_movability(G, samples, raft_iters) if movability is True
             else movability)
        save('movability', to_host(timed(log, 'movability', G.device,
                                       lambda: M(video))[0, 0]), 'inferno')
        print('movability map saved')
    return arrays


def build_generator(model_name: str, checkpoint_dir, raft_iters: int,
                    device='cuda'):
    """The demo's FlowGenerator: ViT-B 8x8 or ViT-L 4x4 (bf16 on the card,
    f32 on the CPU), RAFT with ``raft_iters`` iterations, the rotated-table
    mask generator at ratio 0.99; the released .pth files under
    checkpoint_dir when present, else seeded weights."""
    from ..masking import generators
    from ..models import vmae
    from ..models.raft.raft import RAFT
    from ..pipelines.segmentation import FlowGenerator
    from ..utils import weights
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    if model_name == 'base':
        model = vmae.base_8x8patch_2frames_1tube(dtype=dtype)
    else:
        model = vmae.large_4x4patch_2frames_1tube(dtype=dtype)
    grid = model.img_size[0] // model.patch_size[0]

    predictor_path = raft_path = None
    if checkpoint_dir:
        predictor_path = os.path.join(checkpoint_dir, CHECKPOINTS[model_name])
        raft_path = os.path.join(checkpoint_dir, 'raft_checkpoints',
                                 'raft-large.pth')
        predictor_path = (predictor_path if os.path.exists(predictor_path)
                          else None)
        raft_path = raft_path if os.path.exists(raft_path) else None

    params = (None if predictor_path else weights.init_vmae_state_dict(
        model, torch.Generator(device=dev).manual_seed(0)))
    raft = RAFT(iters=raft_iters, dtype=dtype, device=dev)
    if not raft_path:
        weights.init_raft(raft, torch.Generator(device=dev).manual_seed(1))
    mask_gen = generators.RotatedTableUniformMaskingGenerator(
        (2, grid, grid), mask_ratio=0.99, clumping_factor=2, seed=0,
        device=dev)
    return FlowGenerator(
        predictor=model, params=params, predictor_load_path=predictor_path,
        flow_model=raft, flow_model_load_path=raft_path,
        raft_iters=raft_iters, imagenet_normalize_inputs=True,
        mask_generator=mask_gen, seed=0, device=dev)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.cache import enable_persistent_cache
    from ._io import read_image
    dev = resolve_device(args.device)
    if dev.type == 'cuda':
        enable_persistent_cache()
    G = build_generator(args.model, args.checkpoint_dir, args.raft_iters,
                        dev)
    hw = G.predictor.img_size[0]  # 224 for both released configurations
    if args.image:
        img = read_image(args.image, hw)
    else:
        img = np.random.RandomState(0).rand(hw, hw, 3).astype(np.float32)
    x = torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(dev)
    return run_demo(G, x, args.out, args.samples, args.movability,
                    args.raft_iters)


if __name__ == '__main__':
    main()
