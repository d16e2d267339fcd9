"""Counterfactual inference with the sample axis split over ranks.

Port of counterfactualworldmodels_tpu/parallel/inference.py. The S sampled
(mask, shift) variants of a counterfactual step are independent, so each
wrapper runs the port's own core (pipelines/segmentation.py,
pipelines/imu.py) on this rank's contiguous block of samples
[r*S/W, (r+1)*S/W), the layout of JAX's ``P('samples')``: the prompts, the
shifts and the rectangularizer's draws (``noise``, drawn in full on every
rank when it is a torch.Generator, then sliced), and for the multi-scene
engine and the exact IMU step also the stacked prefix caches and the
per-sample context streams. The scene, the weights and a shared prefix
cache are replicated: every rank holds them whole. The outputs are
all-gathered in rank order, so every rank returns (videos, flows, masks)
for all S samples, as the JAX wrappers' global arrays hold them.

Each rank's kernels (K1, K2, the RAFT lookup) run on its own card at the
local shapes. S must be divisible by the mesh axis.
"""
from __future__ import annotations

from typing import Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import fast_vmae
from ..pipelines.imu import _imu_counterfactual_step, \
    _imu_counterfactual_step_fast
from ..pipelines.segmentation import (
    _rect_noise, counterfactual_videos_and_flows,
    counterfactual_videos_and_flows_fast,
    counterfactual_videos_and_flows_fast_multi)
from .mesh import BatchSharding

Noise = Union[torch.Tensor, torch.Generator]


def _samples(mesh: DeviceMesh, s: int, axis_name: str = 'samples'
             ) -> BatchSharding:
    sh = BatchSharding(mesh, axis_name)
    if s % sh.size:
        raise ValueError(f'{s} samples do not split over the {sh.size} '
                         f'ranks of mesh axis {axis_name!r}')
    return sh


def _gather3(sh: BatchSharding, outs):
    return tuple(sh.gather(o) for o in outs)


def _tree_local(sh: BatchSharding, tree, dim: int):
    """This rank's block of every tensor in a (nested) tuple or NamedTuple
    along ``dim``."""
    if isinstance(tree, torch.Tensor):
        return sh.local(tree, dim)
    parts = [_tree_local(sh, t, dim) for t in tree]
    return type(tree)(*parts) if hasattr(tree, '_fields') else \
        type(tree)(parts)


def shard_counterfactual_batch(mesh: DeviceMesh, *arrays, axis: int = 0,
                               axis_name: str = 'samples'):
    """This rank's block of each array along ``axis`` (JAX: a device_put
    with that axis sharded over the mesh)."""
    sh = BatchSharding(mesh, axis_name)
    return tuple(sh.local(torch.as_tensor(a), axis) for a in arrays)


def sharded_counterfactuals(mesh: DeviceMesh, vmae_module, raft_model, x,
                            passive, active, shifts, noise: Noise, n_vis: int,
                            normalize: bool, raft_iters: int,
                            fix_passive: bool = True, device='cuda'):
    """segmentation.counterfactual_videos_and_flows (the exact step) with
    B = 1 and the samples split over the mesh: passive / active [1, N, S],
    shifts [1, S, 2] and noise [1, S, n] (or a Generator) split on S; x and
    the modules replicated. Returns (videos [S, ...], flows, masks)."""
    x, passive, active, shifts = (torch.as_tensor(v, device=device)
                                  for v in (x, passive, active, shifts))
    if x.shape[0] != 1:
        raise ValueError(f'sample sharding is per scene (B == 1), got '
                         f'B={x.shape[0]}')
    s = passive.shape[-1]
    sh = _samples(mesh, s)
    n = vmae_module.cfg.num_patches_per_frame
    noise = _rect_noise(noise, s, n, x.device).reshape(1, s, n)
    out = counterfactual_videos_and_flows(
        vmae_module, raft_model, x, sh.local(passive, 2),
        sh.local(active, 2), sh.local(shifts, 1), sh.local(noise, 1), n_vis,
        normalize, raft_iters, fix_passive, device=device)
    return _gather3(sh, out)


def sharded_counterfactuals_fast(mesh: DeviceMesh, vmae_model, fast_params,
                                 raft_model, x, passive, active, shifts,
                                 noise: Noise, n_vis: int, normalize: bool,
                                 raft_iters: int, prefix_cache=None,
                                 prefix_pool: int = 1, suffix_pool: int = 1,
                                 gelu: str = 'erf'):
    """The shared-prefix engine (counterfactual_videos_and_flows_fast) with
    the samples split over the mesh. The scene's prefix is computed on
    every rank from the replicated x and weights, or read from the
    replicated ``prefix_cache``; each rank runs the suffix and RAFT on its
    block. passive / active [1, N, S], shifts [1, S, 2], noise [1, S, n1]
    or [S, n1] (or a Generator). Returns (videos, flows, masks) for all S."""
    s = passive.shape[-1]
    sh = _samples(mesh, s)
    n0 = vmae_model.num_patches_per_frame
    n1 = vmae_model.num_patches - n0
    n_sfx_pad = fast_vmae.sfx_bucket(n_vis - n0, n1)
    noise = _rect_noise(noise, s, n1, x.device)
    out = counterfactual_videos_and_flows_fast(
        vmae_model, fast_params, raft_model, x, sh.local(passive, 2),
        sh.local(active, 2), sh.local(shifts, 1), sh.local(noise, 0),
        n_sfx_pad, normalize, raft_iters, True, prefix_cache=prefix_cache,
        prefix_pool=prefix_pool, suffix_pool=suffix_pool, gelu=gelu,
        n_vis=n_vis)
    return _gather3(sh, out)


def sharded_counterfactuals_fast_multi(mesh: DeviceMesh, vmae_model,
                                       fast_params, raft_model, x, passive,
                                       active, shifts, noise: Noise,
                                       n_vis: int, normalize: bool,
                                       raft_iters: int, prefix_cache=None,
                                       device='cuda'):
    """The multi-scene engine (counterfactual_videos_and_flows_fast_multi)
    with every per-sample operand split over the mesh, the stacked prefix
    cache included (its leaves' batch axis 1): a rank holds only its own
    scenes' prefix K/V. x [S, T, C, H, W]; passive / active [S, N]; shifts
    [S, 2]; noise [S, n1] (or a Generator); prefix_cache REQUIRED
    (fast_vmae.stack_prefix_caches over the S scenes)."""
    if prefix_cache is None:
        raise ValueError(
            'sharded_counterfactuals_fast_multi requires the stacked '
            "prefix_cache (fast_vmae.stack_prefix_caches over the S scenes' "
            'caches); for a single shared scene use '
            'sharded_counterfactuals_fast')
    x, passive, active, shifts = (torch.as_tensor(v, device=device)
                                  for v in (x, passive, active, shifts))
    s = x.shape[0]
    sh = _samples(mesh, s)
    n0 = vmae_model.num_patches_per_frame
    n1 = vmae_model.num_patches - n0
    n_sfx_pad = fast_vmae.sfx_bucket(n_vis - n0, n1)
    noise = _rect_noise(noise, s, n1, x.device)
    out = counterfactual_videos_and_flows_fast_multi(
        vmae_model, fast_params, raft_model, sh.local(x), sh.local(passive),
        sh.local(active), sh.local(shifts), n_sfx_pad, normalize, raft_iters,
        True, sh.local(noise),
        _tree_local(sh, prefix_cache, 1), n_vis=n_vis, device=device)
    return _gather3(sh, out)


def sharded_imu_counterfactuals_fast(mesh: DeviceMesh, wrapper, params,
                                     raft_model, x, passive, active, shifts,
                                     noise: Noise, x_context, mask_context,
                                     n_vis: int, normalize: bool,
                                     raft_iters: int, prefix_cache=None):
    """The conjoined (IMU-conditioned) shared-prefix step
    (pipelines.imu._imu_counterfactual_step_fast) with the samples split
    over the mesh: the scene, the IMU context and the prefix cache
    replicated, the prompts, shifts and draws split. noise [1, S, n1] or
    [S, n1] (or a Generator)."""
    m = wrapper.model.main
    n1 = m.num_patches - m.num_patches // m.num_frames
    s = passive.shape[-1]
    sh = _samples(mesh, s)
    noise = _rect_noise(noise, s, n1, x.device)
    out = _imu_counterfactual_step_fast(
        wrapper, params, raft_model, x, sh.local(passive, 2),
        sh.local(active, 2), sh.local(shifts, 1), sh.local(noise, 0),
        x_context, mask_context, n_vis, normalize, raft_iters, prefix_cache)
    return _gather3(sh, out)


def sharded_imu_counterfactuals(mesh: DeviceMesh, wrapper, raft_model, x,
                                passive, active, shifts, noise: Noise,
                                x_context, mask_context, n_vis: int,
                                n_vis_c: int, normalize: bool,
                                raft_iters: int, fix_passive: bool = True,
                                shared0_ok: bool = False):
    """The exact conjoined step (pipelines.imu._imu_counterfactual_step)
    with B = 1 and the samples split over the mesh: x_context /
    mask_context are the per-sample tiled [S, ...] streams and split with
    the prompts; the scene and the weights replicate. noise [1, S, n] (or
    a Generator)."""
    if x.shape[0] != 1:
        raise ValueError(f'sample sharding is per scene (B == 1), got '
                         f'B={x.shape[0]}')
    s = passive.shape[-1]
    sh = _samples(mesh, s)
    npf = wrapper.num_patches // wrapper.num_frames
    noise = _rect_noise(noise, s, npf, x.device).reshape(1, s, npf)
    out = _imu_counterfactual_step(
        wrapper, raft_model, x, sh.local(passive, 2), sh.local(active, 2),
        sh.local(shifts, 1), sh.local(noise, 1), sh.local(x_context),
        sh.local(mask_context), n_vis, n_vis_c, normalize, raft_iters,
        fix_passive, shared0_ok)
    return _gather3(sh, out)
