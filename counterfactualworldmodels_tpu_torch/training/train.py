"""VMAE masked-prediction pretraining on one card. Port of the VMAE part of
counterfactualworldmodels_tpu/training/train.py.

The objective is the JAX package's: the rotated-table masking policy, MSE on
the masked patch pixels against the per-patch-normalised target, and
``optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))``,
reproduced here on ``torch.optim.AdamW`` (``Optimizer``). Unlike the JAX
step, which returns a new state, the port's step updates the parameters,
the optimizer moments and the step count in place.

Attention with ``attn_impl='flash'`` trains through the hand-written K5
forward and K6 backward (ops/flash_attention). The sharded, ChannelMAE and
conjoined train steps come with their models and the parallel package.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from .._device import resolve_device
from ..data.shards import u8_to_chw_01
from ..masking.generators import rotated_table_uniform_mask
from ..models.vmae import (PretrainVisionTransformer, init_params, mask_order,
                           take_tokens)
from ..ops.normalization import imagenet_normalize
from ..ops.patches import patchify


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all entries, f32 scalar."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The JAX package's optimizer as a recipe: global-norm clipping, then
    AdamW (decoupled decay on every parameter, biases, norms and the mask
    token included, as optax applies it without a mask) at a linear warm-up
    from 0 and a cosine decay to 0 (``optax.warmup_cosine_decay_schedule``).
    ``init`` binds it to parameters; ``update`` applies one step."""
    learning_rate: float = 1.5e-4
    weight_decay: float = 0.05
    warmup_steps: int = 1000
    total_steps: int = 100_000
    b1: float = 0.9
    b2: float = 0.95
    clip_norm: float = 1.0

    def schedule(self, count: int) -> float:
        """Learning rate of the update made at step ``count`` (the count
        before it is incremented, so the first update has lr 0)."""
        warm = self.warmup_steps
        decay = max(self.total_steps, warm + 1) - warm
        if count < warm:
            return self.learning_rate * count / warm
        t = min(count - warm, decay)
        return self.learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=0.0,
                                 betas=(self.b1, self.b2), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.AdamW, params, step: int):
        """Clip the parameters' gradients in place by optax's rule
        g * clip / max(|g|, clip), then take the AdamW step at
        ``schedule(step)``. Returns the unclipped global norm."""
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        factor = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        lr = self.schedule(step)
        for group in opt.param_groups:
            group['lr'] = lr
        opt.step()
        return gnorm


def make_optimizer(learning_rate=1.5e-4, weight_decay=0.05,
                   warmup_steps=1000, total_steps=100_000,
                   b1=0.9, b2=0.95, clip_norm=1.0, mu_dtype=None) -> Optimizer:
    """The optimizer recipe. ``mu_dtype`` (a narrower first moment) is not
    ported yet (ROADMAP.md, queue 1 item 10)."""
    if mu_dtype is not None:
        raise NotImplementedError(
            'mu_dtype (Adam first moment in a narrower dtype) is not ported '
            'yet: ROADMAP.md, queue 1 item 10')
    return Optimizer(learning_rate, weight_decay, warmup_steps, total_steps,
                     b1, b2, clip_norm)


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    moments). The train step updates all three in place."""
    step: int
    model: nn.Module
    opt_state: torch.optim.Optimizer


def apply_remat(loss_fn: Callable, remat):
    """Rematerialization of a loss function. False: save every activation.
    True/'full': ``torch.utils.checkpoint`` over the whole loss, which
    keeps only its inputs and recomputes the forward in the backward.
    'dots' (save the matmul outputs) is not ported yet."""
    if not remat:
        return loss_fn
    if remat in (True, 'full'):
        def remat_loss(*args):
            return torch.utils.checkpoint.checkpoint(loss_fn, *args,
                                                     use_reentrant=False)
        return remat_loss
    if remat == 'dots':
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs, recompute the rest) is "
            'not ported yet: ROADMAP.md, queue 1 item 10')
    raise ValueError(f'remat must be False, True/"full", or "dots": {remat}')


def masked_prediction_loss(model: nn.Module, x, mask, n_vis: int,
                           normalize_inputs: bool = True,
                           normalize_targets: bool = True,
                           eps: float = 1e-6):
    """MSE on masked patch pixels. ``model`` is a
    PretrainVisionTransformerModule; x: [B, T, C, H, W] in [0, 1], or raw
    uint8 [B, T, H, W, C] loader batches."""
    if x.dtype == torch.uint8:
        x = u8_to_chw_01(x)
    xm = imagenet_normalize(x, temporal_dim=1) if normalize_inputs else x
    pred = model(xm.transpose(1, 2), mask, n_vis)
    target = patchify(xm, model.cfg.full_patch_size, temporal_dim=1)
    if normalize_targets:
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + eps)
    target_masked = take_tokens(target, mask_order(mask)[:, n_vis:])
    return ((pred - target_masked) ** 2).mean()


def _zero_grads(params):
    for p in params:
        p.grad = None


def _fill_grads(params):
    """Give parameters the loss did not reach a zero gradient, so the
    update treats every parameter alike (as optax does)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def accumulated_grads(loss_fn: Callable, model: nn.Module, accum_steps: int,
                      *batch_args):
    """Gradient accumulation over ``accum_steps`` equal microbatches.

    loss_fn(model, *microbatch) -> scalar; every tensor in ``batch_args``
    splits on its leading axis. Each microbatch's backward adds into the
    parameters' ``.grad`` (peak activation memory of one microbatch); the
    sum is then divided by ``accum_steps``, which for a mean loss over
    equal microbatches is the full-batch gradient. Returns the loss
    averaged over microbatches; the gradients are left in ``.grad``."""
    if accum_steps < 1:
        raise ValueError(f'accum_steps must be >= 1: {accum_steps}')
    b = batch_args[0].shape[0]
    if any(a.shape[0] != b for a in batch_args) or b % accum_steps:
        raise ValueError(f'batch of {b} does not split into {accum_steps} '
                         'equal microbatches')
    mb = b // accum_steps
    params = list(model.parameters())
    _zero_grads(params)
    loss_sum = 0.0
    for i in range(accum_steps):
        loss = loss_fn(model, *(a[i * mb:(i + 1) * mb] for a in batch_args))
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    _fill_grads(params)
    for p in params:
        p.grad.div_(accum_steps)
    return loss_sum / accum_steps


def make_train_step(model: PretrainVisionTransformer, optimizer: Optimizer,
                    n_vis: int, normalize_inputs: bool = True,
                    normalize_targets: bool = True, remat=True,
                    mask_fn: Optional[Callable] = None, accum_steps: int = 1,
                    device='cuda'):
    """Returns train_step(state, x, mask) -> (state, metrics), which
    updates ``state`` in place (parameters, optimizer moments, step) and
    returns it with {'loss', 'grad_norm'} (device scalars; grad_norm is the
    norm before clipping). x and mask are moved to ``device``.

    mask_fn: optional ``(generator, batch_size) -> bool [B, N]`` mask
    sampler (e.g. a partial of ``make_batch_masks``). The returned step
    then takes a ``torch.Generator`` in place of a mask.

    accum_steps > 1 splits the batch into that many microbatches and
    accumulates their gradients (``accumulated_grads``).
    """
    device = resolve_device(device)
    loss_fn = apply_remat(functools.partial(
        masked_prediction_loss, n_vis=n_vis,
        normalize_inputs=normalize_inputs,
        normalize_targets=normalize_targets), remat)

    def train_step(state: TrainState, x, mask):
        if state.model.cfg != model:
            raise ValueError('the state holds a model of another configuration')
        x = torch.as_tensor(x).to(device)
        mask = torch.as_tensor(mask).to(device)
        params = list(state.model.parameters())
        if accum_steps > 1:
            loss = accumulated_grads(loss_fn, state.model, accum_steps, x,
                                     mask)
        else:
            _zero_grads(params)
            loss = loss_fn(state.model, x, mask)
            loss.backward()
            loss = loss.detach()
            _fill_grads(params)
        gnorm = optimizer.update(state.opt_state, params, state.step)
        state.step += 1
        return state, {'loss': loss, 'grad_norm': gnorm}

    if mask_fn is None:
        return train_step

    def train_step_keyed(state: TrainState, x, generator: torch.Generator):
        return train_step(state, x, mask_fn(generator, x.shape[0]))

    return train_step_keyed


def init_train_state(model: PretrainVisionTransformer, optimizer: Optimizer,
                     seed: int = 0, device='cuda') -> TrainState:
    """Step 0, the model with seeded random weights on ``device``, and the
    optimizer bound to its parameters."""
    module = init_params(model, seed, device)
    return TrainState(0, module, optimizer.init(module.parameters()))


def make_batch_masks(generator: Optional[torch.Generator],
                     model: PretrainVisionTransformer, batch_size: int,
                     mask_ratio: float = 0.9):
    """Training masks with the rotated-table policy, drawn from
    ``generator`` (on its device); returns (mask, n_vis)."""
    t, h, w = model.mask_size
    mask = rotated_table_uniform_mask((t, h, w), mask_ratio,
                                      batch_size=batch_size,
                                      generator=generator)
    n_per_frame = model.num_patches // t
    n_vis = (t - 1) * n_per_frame + (n_per_frame -
                                     int(mask_ratio * n_per_frame))
    return mask, n_vis
