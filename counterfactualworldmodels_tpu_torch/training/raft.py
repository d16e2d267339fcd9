"""RAFT training: supervised flow and keypoint-head distillation.

Port of counterfactualworldmodels_tpu/training/raft.py. Two objectives:

- **flow**: the gamma-weighted L1 over every GRU iteration's upsampled
  flow against ground truth (ops/misc.masked_sequence_loss; iteration i of
  n weighs gamma**(n-1-i)), pixels whose ground truth exceeds ``max_flow``
  excluded, and the final iteration's end-point error as a metric;
- **keypoint**: BCE-with-logits of the ``output_dim=1`` head against a
  dense [0, 1] target map, the image fed as both frames (the reference's
  single-image keypoint forward).

As in the JAX package, the steps differentiate through the plain gather
lookup (``corr_lookup='gather'``: the lookup kernel has no backward),
through coords1 across iterations (no detach), and into the frozen batch
norms' statistics, which the JAX package declares as parameters:
``init_raft_train_state`` makes them trainable (``RAFT.train_norm_stats``),
so AdamW updates and decays them too.

``synthetic_flow_batch`` supplies exact ground truth: a smooth random field
applied by backward warping. Its draws are inputs (or come from a
``torch.Generator``), where JAX takes a key.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..models.raft.layers import FrozenBatchNorm
from ..models.raft.raft import RAFT
from ..ops.misc import (l1_loss, masked_bce_loss, masked_per_pixel_loss,
                        masked_sequence_loss)
from ..parallel.mesh import axis_size
from ..utils import weights
from .train import (Optimizer, TrainState, _ShardedOptimizer, _check_model,
                    _dp_step, _on, _shard_state, _update, apply_remat,
                    data_parallel)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def raft_sequence_loss(flow_seq, flow_gt, valid=None, gamma: float = 0.8,
                       max_flow: float = 400.0):
    """Gamma-weighted L1 over the iteration sequence. flow_seq [iters, B, 2,
    H, W]; flow_gt [B, 2, H, W]; valid optional [B, H, W] (bool or float,
    > 0.5 is valid). Pixels whose ground-truth magnitude reaches max_flow
    are excluded."""
    mag = torch.sqrt((flow_gt ** 2).sum(1))
    v = mag < max_flow
    if valid is not None:
        v = v & (valid > 0.5)
    v = v[:, None].to(flow_gt.dtype)
    return masked_sequence_loss(
        list(flow_seq), flow_gt, v, gamma=gamma,
        loss_func=functools.partial(masked_per_pixel_loss, loss_fn=l1_loss))


def end_point_error(flow_pred, flow_gt, valid=None):
    """Mean per-image L2 flow error over the valid pixels (each image
    normalised by its own count, so microbatches average to the batch's
    value). flow_* [B, 2, H, W]; valid optional [B, H, W]."""
    epe = torch.sqrt(((flow_pred - flow_gt) ** 2).sum(1))
    if valid is None:
        return epe.mean()
    v = valid.to(epe.dtype)
    per = (epe * v).sum((-2, -1)) / torch.clamp(v.sum((-2, -1)), min=1)
    return per.mean()


def raft_flow_loss(model: RAFT, image1, image2, flow_gt, valid=None,
                   gamma: float = 0.8, max_flow: float = 400.0,
                   iters: Optional[int] = None):
    """(sequence loss, final-iteration EPE) of one batch. image1/image2
    [B, 3, H, W] in [0, 255]; flow_gt [B, 2, H, W] in pixels, channel 0 =
    x."""
    _, flow_up, flow_seq = model(image1, image2, iters, True)
    loss = raft_sequence_loss(flow_seq, flow_gt, valid, gamma, max_flow)
    return loss, end_point_error(flow_up, flow_gt, valid)


def keypoint_distill_loss(model: RAFT, image, target,
                          iters: Optional[int] = None):
    """BCE-with-logits of the output_dim=1 head against a dense [0, 1]
    target. image [B, 3, H, W] in [0, 255]; target [B, 1, H, W]."""
    _, logits = model(image, image, iters)
    ones = torch.ones_like(target)
    return masked_bce_loss(logits, target, ones, with_logits=True).mean()


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _device(model: RAFT) -> torch.device:
    return next(model.parameters()).device


def _require_trainable_stats(model: RAFT) -> None:
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm) and 'running_mean' in m._buffers:
            raise ValueError(
                "the RAFT's batch-norm statistics are buffers; the JAX "
                'package trains them. Build the state with '
                'init_raft_train_state, or call model.train_norm_stats() '
                'before binding the optimizer')


def _gather_lookup(model: RAFT) -> None:
    """The lookup kernel has no backward: a RAFT that routes by device
    trains on the plain gather lookup, as the JAX steps clone theirs."""
    if model.corr_lookup is None:
        model.corr_lookup = 'gather'


def make_raft_train_step(model: RAFT, optimizer: Optimizer,
                         gamma: float = 0.8, max_flow: float = 400.0,
                         iters: Optional[int] = None, remat=True,
                         accum_steps: int = 1):
    """Returns train_step(state, image1, image2, flow_gt, valid) ->
    (state, {'loss', 'epe', 'grad_norm'}), in place on a state whose model
    is ``model`` (valid may be None); the inputs move to the model's
    device. accum_steps > 1 accumulates microbatch gradients. Sets
    ``model.corr_lookup`` to 'gather' when it routes by device."""
    _gather_lookup(model)

    def loss(m, image1, image2, flow_gt, *valid):
        return raft_flow_loss(m, image1, image2, flow_gt,
                              valid[0] if valid else None, gamma, max_flow,
                              iters)
    loss_fn = apply_remat(loss, remat)

    def train_step(state: TrainState, image1, image2, flow_gt, valid=None):
        _check_model(state, model)
        _require_trainable_stats(model)
        batch = (image1, image2, flow_gt) + (() if valid is None
                                              else (valid,))
        return _update(state, optimizer, loss_fn, accum_steps,
                       _on(_device(model), *batch), aux_name='epe')

    return train_step


def make_keypoint_distill_step(model: RAFT, optimizer: Optimizer,
                               iters: Optional[int] = None, remat=True):
    """Returns train_step(state, image, target) -> (state, {'loss',
    'grad_norm'}) for the output_dim=1 keypoint head (``model.output_dim``
    must be set), in place like make_raft_train_step."""
    if model.output_dim is None:
        raise ValueError('keypoint distillation needs a RAFT built with '
                         'output_dim')
    _gather_lookup(model)
    loss_fn = apply_remat(functools.partial(keypoint_distill_loss,
                                            iters=iters), remat)

    def train_step(state: TrainState, image, target):
        _check_model(state, model)
        _require_trainable_stats(model)
        return _update(state, optimizer, loss_fn, 1,
                       _on(_device(model), image, target))

    return train_step


def init_raft_train_state(model: RAFT, optimizer: Optimizer,
                          seed: int = 0) -> TrainState:
    """Step 0 with ``model`` given seeded random weights (the JAX
    initialisers' distributions, weights.init_raft, drawn on the host: the
    same weights on every device), its batch-norm statistics made
    trainable, and the optimizer bound to its parameters."""
    weights.init_raft(model, torch.Generator().manual_seed(seed))
    model.train_norm_stats()
    return TrainState(0, model, optimizer.init(model.parameters()))


def make_sharded_raft_train_step(model: RAFT, optimizer: Optimizer, mesh,
                                 keypoint: bool = False, **step_kwargs):
    """RAFT training data-parallel over the mesh's axis 'dp' (JAX's is dp
    only too): each rank runs the step on its rows of the batch and the
    gradients are averaged over the axis before the update. Returns (step,
    shard_state, data_sharding) like training.train's sharded steps; the
    step's signature is the unsharded one's."""
    if 'tp' in mesh.mesh_dim_names and axis_size(mesh, 'tp') > 1:
        raise ValueError('RAFT trains data-parallel only, as in the JAX '
                         'package: the mesh has an axis tp above 1')
    dp = data_parallel(mesh)
    opt = _ShardedOptimizer(optimizer, dp)
    step = (make_keypoint_distill_step(model, opt, **step_kwargs) if keypoint
            else make_raft_train_step(model, opt, **step_kwargs))
    return _dp_step(step, dp), _shard_state(mesh, opt), dp


# ---------------------------------------------------------------------------
# synthetic ground-truth flow
# ---------------------------------------------------------------------------

def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image.resize's bilinear (triangle)
    filter along one axis: half-pixel centres, each column renormalised
    over the taps inside the input, columns outside it zero."""
    s = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
         * (n_in / n_out) - 0.5)
    taps = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1 - (s[None, :] - taps[:, None]).abs(), min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _upsample_field(low: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """low [B, 2, c, c] -> [B, 2, h, w] as jax.image.resize(..., 'bilinear')
    computes it (rows, then columns), bit for bit on the CPU."""
    dev = low.device
    out = torch.einsum('bcyx,yY->bcYx', low,
                       _resize_weights(low.shape[2], h, dev))
    return torch.einsum('bcYx,xX->bcYX', out,
                        _resize_weights(low.shape[3], w, dev))


def _warp_bilinear_nearest(img, cy, cx):
    """Bilinear samples of img [C, H, W] at (cy, cx) [H, W] with the edges
    replicated (``map_coordinates(order=1, mode='nearest')``): the four
    corners' weights and values in the same order and rounding."""
    _, h, w = img.shape
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    wy1 = cy - y0
    wx1 = cx - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    out = None
    for yy, wy in ((y0, wy0), (y0 + 1, wy1)):
        yi = torch.clamp(yy, 0, h - 1).long()
        for xx, wx in ((x0, wx0), (x0 + 1, wx1)):
            xi = torch.clamp(xx, 0, w - 1).long()
            term = (wy * wx) * img[:, yi, xi]
            out = term if out is None else out + term
    return out


def synthetic_flow_batch(images, cells: int = 4, max_mag: float = 8.0,
                         translation_only: bool = False, draws=None,
                         generator: Optional[torch.Generator] = None):
    """(image1, image2, flow_gt, valid) from images [B, 3, H, W] in
    [0, 255]. A smooth random field g (bilinear upsampling of a [cells,
    cells] grid of uniform draws in [-max_mag, max_mag]; one vector per
    image with ``translation_only``) defines image2 by backward warping
    image2(y) = image1(y - g(y)), so the forward flow is g itself, exact
    where g is locally constant. ``valid`` [B, H, W] marks pixels whose
    warp source stayed inside the frame.

    draws: the uniform values themselves, [B, 2, cells, cells] (or [B, 2, 1,
    1] with translation_only); otherwise drawn from ``generator`` on the
    images' device."""
    images = torch.as_tensor(images)
    b, _, h, w = images.shape
    shape = (b, 2, 1, 1) if translation_only else (b, 2, cells, cells)
    if draws is None:
        u = torch.rand(shape, generator=generator, device=images.device)
        draws = -max_mag + 2 * max_mag * u
    draws = torch.as_tensor(draws, device=images.device).reshape(shape)
    if translation_only:
        flow = draws.expand(b, 2, h, w).contiguous()
    else:
        flow = _upsample_field(draws, h, w)
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=images.device),
        torch.arange(w, dtype=torch.float32, device=images.device),
        indexing='ij')
    image2, valid = [], []
    for img, f in zip(images, flow):
        cy = yy - f[1]
        cx = xx - f[0]
        image2.append(_warp_bilinear_nearest(img, cy, cx))
        valid.append((cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1))
    return images, torch.stack(image2), flow, torch.stack(valid)
