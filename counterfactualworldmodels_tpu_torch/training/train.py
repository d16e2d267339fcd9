"""Masked-prediction training: the VMAE, ChannelMAE and conjoined
(IMU-conditioned) families, on one card or sharded over a dp x tp mesh.
Port of counterfactualworldmodels_tpu/training/train.py.

The objectives are the JAX package's: for the VMAE the rotated-table
masking policy and MSE on the masked patch pixels against the
per-patch-normalised target; for the ChannelMAE the masked patches' MSE
summed over channel groups (models/cmae.channel_mae_train_loss); for the
conjoined model the main stream's masked-prediction MSE with the context
stream (IMU) as input (``conjoined_prediction_loss``). The optimizer is
``optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))``,
reproduced on ``torch.optim.AdamW``, or on ``AdamWMixed`` when Adam's first
moment is kept in a narrower dtype (``mu_dtype``). Unlike the JAX steps,
which return a new state, the port's steps update the parameters, the
optimizer moments and the step count in place.

Attention with ``attn_impl='flash'`` trains through the hand-written K5
forward and K6 backward (ops/flash_attention). The sharded steps
(``make_sharded_*``: a mesh {'dp': d} or {'dp': d, 'tp': t} over the ranks
of a process group, one process per card) run the same step on each dp
rank's share of the batch and average the gradients over the dp group of
the rank's tp coordinate before the clipping and the AdamW update, so
every rank takes the global batch's step. With an axis 'tp' the model runs
tensor-parallel (parallel/tensor.py): each rank keeps its shard of the
split parameters and of their AdamW moments, and the clipping norm sums
the split gradients' squares over the tp group, counting the replicated
ones once (optax's global_norm of the sharded tree).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..data.shards import u8_to_chw_01
from ..masking.generators import rotated_table_uniform_mask
from ..models.vmae import (PretrainVisionTransformer, init_params, mask_order,
                           take_tokens)
from ..ops.normalization import imagenet_normalize
from ..ops.patches import patchify
from ..parallel.mesh import (CONJOINED_PARTITION_RULES, VMAE_PARTITION_RULES,
                             BatchSharding, replicate, replicate_tensors_,
                             shard_params)
from ..parallel.tensor import shard_optimizer_state_, tp_global_norm


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
    mu_dtype: Optional[torch.dtype] = None

    def schedule(self, count: int) -> float:
        """Learning rate of the update made at step ``count`` (the count
        before it is incremented, so the first update has lr 0)."""
        warm = self.warmup_steps
        decay = max(self.total_steps, warm + 1) - warm
        if count < warm:
            return self.learning_rate * count / warm
        t = min(count - warm, decay)
        return self.learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))

    def init(self, params) -> torch.optim.Optimizer:
        if self.mu_dtype is not None:
            return AdamWMixed(list(params), betas=(self.b1, self.b2),
                              eps=1e-8, weight_decay=self.weight_decay,
                              mu_dtype=self.mu_dtype)
        return torch.optim.AdamW(list(params), lr=0.0,
                                 betas=(self.b1, self.b2), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.Optimizer, params, step: int,
               gnorm: Optional[torch.Tensor] = None):
        """Clip the parameters' gradients in place by optax's rule
        g * clip / max(|g|, clip), then take the AdamW step at
        ``schedule(step)``. Returns the unclipped global norm (``gnorm``
        when given, else the gradients' global_norm)."""
        grads = [p.grad for p in params]
        if gnorm is None:
            gnorm = global_norm(grads)
        factor = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        lr = self.schedule(step)
        for group in opt.param_groups:
            group['lr'] = lr
        opt.step()
        return gnorm


class AdamWMixed(torch.optim.Optimizer):
    """AdamW with its first moment stored in ``mu_dtype`` (e.g. bf16, half
    that buffer's memory) and the update computed in f32, in optax's order
    (``optax.adamw(..., mu_dtype=...)``): mu = (1 - b1) g + b1 mu in f32
    with b1 rounded to ``mu_dtype`` as the jitted optax step rounds it, nu =
    (1 - b2) g^2 + b2 nu, u = mu_hat / (sqrt(nu_hat) + eps) + wd p,
    p -= lr u; mu is rounded to ``mu_dtype`` only when it is stored.
    ``torch.optim.AdamW`` keeps its moments in the parameters' dtype, so
    this optimizer keeps its own."""

    def __init__(self, params, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.05, mu_dtype=torch.bfloat16):
        if not (isinstance(mu_dtype, torch.dtype)
                and mu_dtype.is_floating_point):
            raise ValueError(f'mu_dtype must be a floating torch dtype: '
                             f'{mu_dtype!r}')
        super().__init__(params, dict(lr=0.0, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            lr, eps, wd = group['lr'], group['eps'], group['weight_decay']
            # optax's b1 * mu takes b1 as a weakly typed scalar, which XLA
            # rounds to mu's dtype before the f32 product
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['step'] = 0
                    st['exp_avg'] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st['exp_avg_sq'] = torch.zeros_like(p)
                g = p.grad.float()
                mu = (1 - b1) * g + b1_mu * st['exp_avg'].float()
                nu = (1 - b2) * (g * g) + b2 * st['exp_avg_sq']
                st['step'] += 1
                t = st['step']
                u = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                            + eps)
                p.add_((u + wd * p) * -lr)
                st['exp_avg'] = mu.to(self.mu_dtype)
                st['exp_avg_sq'] = nu

    def load_state_dict(self, state_dict):
        """As torch's, which casts the moments to the parameters' dtype;
        the first moment goes back to ``mu_dtype`` (exactly: it was stored
        in it)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if 'exp_avg' in st:
                st['exp_avg'] = st['exp_avg'].to(self.mu_dtype)


def make_optimizer(learning_rate=1.5e-4, weight_decay=0.05,
                   warmup_steps=1000, total_steps=100_000,
                   b1=0.9, b2=0.95, clip_norm=1.0, mu_dtype=None) -> Optimizer:
    """The optimizer recipe. ``mu_dtype``: the dtype of Adam's first moment
    (e.g. torch.bfloat16; the second moment and the parameters stay
    f32), None for the parameters' dtype."""
    return Optimizer(learning_rate, weight_decay, warmup_steps, total_steps,
                     b1, b2, clip_norm, mu_dtype)


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    moments). The train step updates all three in place."""
    step: int
    model: nn.Module
    opt_state: torch.optim.Optimizer


# the un-batched products (every Linear): jax's
# dots_with_no_batch_dims_saveable keeps exactly these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_remat(loss_fn: Callable, remat):
    """Rematerialization of a loss function. False: save every activation.
    True/'full': ``torch.utils.checkpoint`` over the whole loss, which
    keeps only its inputs and recomputes the forward in the backward.
    'dots': a selective checkpoint that saves the outputs of the
    un-batched products (``aten.mm``/``addmm``: the Linears) and recomputes
    the rest, the attention kernels included."""
    if not remat:
        return loss_fn
    if remat in (True, 'full'):
        def remat_loss(*args):
            return torch.utils.checkpoint.checkpoint(loss_fn, *args,
                                                     use_reentrant=False)
        return remat_loss
    if remat == 'dots':
        def dots_loss(*args):
            return torch.utils.checkpoint.checkpoint(
                loss_fn, *args, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _save_dots))
        return dots_loss
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
                      *batch_args, has_aux: bool = False):
    """Gradient accumulation over ``accum_steps`` equal microbatches.

    loss_fn(model, *microbatch) -> scalar, or (scalar, aux scalar) with
    ``has_aux``; every tensor in ``batch_args`` splits on its leading axis.
    Each microbatch's backward adds into the parameters' ``.grad`` (peak
    activation memory of one microbatch); the sum is then divided by
    ``accum_steps``, which for a mean loss over equal microbatches is the
    full-batch gradient. Returns the loss averaged over microbatches, or
    with ``has_aux`` (loss, aux, grads) as the JAX package's does: the
    loss and aux averaged, grads the parameters' ``.grad`` (which keep
    them)."""
    if accum_steps < 1:
        raise ValueError(f'accum_steps must be >= 1: {accum_steps}')
    b = batch_args[0].shape[0]
    if any(a.shape[0] != b for a in batch_args) or b % accum_steps:
        raise ValueError(f'batch of {b} does not split into {accum_steps} '
                         'equal microbatches')
    mb = b // accum_steps
    params = list(model.parameters())
    _zero_grads(params)
    loss_sum, aux_sum = 0.0, 0.0
    for i in range(accum_steps):
        out = loss_fn(model, *(a[i * mb:(i + 1) * mb] for a in batch_args))
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        if has_aux:
            aux_sum = aux_sum + aux.detach()
    _fill_grads(params)
    for p in params:
        p.grad.div_(accum_steps)
    if not has_aux:
        return loss_sum / accum_steps
    return (loss_sum / accum_steps, aux_sum / accum_steps,
            [p.grad for p in params])


def _check_model(state: TrainState, model: nn.Module):
    if state.model is not model:
        raise ValueError('the state holds another model than the step was '
                         'made for')


def _on(device, *arrays):
    return [torch.as_tensor(a).to(device) for a in arrays]


def _update(state: TrainState, optimizer: Optimizer, loss_fn: Callable,
            accum_steps: int, batch, aux_name: Optional[str] = None):
    """One optimizer step of loss_fn(model, *batch) on ``state``, in place:
    the gradients (over ``accum_steps`` microbatches), the clipped AdamW
    update and the step count. With ``aux_name`` loss_fn returns (loss,
    aux) and the metrics carry aux under that name. Returns (state,
    {'loss', 'grad_norm'[, aux_name]})."""
    params = list(state.model.parameters())
    has_aux = aux_name is not None
    if accum_steps > 1:
        out = accumulated_grads(loss_fn, state.model, accum_steps, *batch,
                                has_aux=has_aux)
        loss, aux = out[:2] if has_aux else (out, None)
    else:
        _zero_grads(params)
        out = loss_fn(state.model, *batch)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        loss = loss.detach()
        _fill_grads(params)
    gnorm = optimizer.update(state.opt_state, params, state.step)
    state.step += 1
    metrics = {'loss': loss, 'grad_norm': gnorm}
    if has_aux:
        metrics[aux_name] = aux.detach()
    return state, metrics


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
        return _update(state, optimizer, loss_fn, accum_steps,
                       _on(device, x, mask))

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


# ---------------------------------------------------------------------------
# ChannelMAE
# ---------------------------------------------------------------------------

def make_cmae_train_step(model: nn.Module, optimizer: Optimizer, n_vis: int,
                         group_masked_counts, remat=True,
                         mask_fn: Optional[Callable] = None,
                         accum_steps: int = 1):
    """Train step of a ChannelMae (models/cmae.py): masked channel-group
    reconstruction. Returns train_step(state, x, mask) -> (state, metrics),
    which updates ``state`` (whose model must be ``model``) in place; x
    [B, C, H, W] and mask move to the model's device. With mask_fn (``(generator, batch_size) -> mask``, e.g. a
    ``group_uniform_mask`` partial) the step takes a ``torch.Generator``
    in place of a mask."""
    from ..models.cmae import channel_mae_train_loss

    def loss(m, x, mask):
        return channel_mae_train_loss(m, x, mask, n_vis, group_masked_counts)
    loss_fn = apply_remat(loss, remat)

    def train_step(state: TrainState, x, mask):
        _check_model(state, model)
        return _update(state, optimizer, loss_fn, accum_steps,
                       _on(model.device, x, mask))

    if mask_fn is None:
        return train_step

    def train_step_keyed(state: TrainState, x, generator: torch.Generator):
        return train_step(state, x, mask_fn(generator, x.shape[0]))

    return train_step_keyed


def init_cmae_train_state(model: nn.Module, optimizer: Optimizer,
                          seed: int = 0) -> TrainState:
    """Step 0 with ``model`` (a ChannelMae or Soft variant, on its device)
    given seeded random weights, and the optimizer bound to them."""
    from ..utils.weights import init_channel_mae_state_dict
    g = torch.Generator(device=model.device).manual_seed(seed)
    model.load_state_dict(init_channel_mae_state_dict(model, g), strict=True)
    return TrainState(0, model, optimizer.init(model.parameters()))


# ---------------------------------------------------------------------------
# Conjoined (IMU-conditioned) VMAE
# ---------------------------------------------------------------------------

def conjoined_prediction_loss(model: nn.Module, x, mask, x_context,
                              mask_context, n_vis: int, n_vis_context: int,
                              normalize_inputs: bool = True,
                              normalize_targets: bool = True,
                              eps: float = 1e-6):
    """Masked-prediction MSE on the main (RGB) stream of a ConjoinedVMAE
    (models/conjoined.py) with context (e.g. IMU) conditioning. x
    [B, C, T, H, W] in [0, 1], imagenet-normalised here by default as on
    every inference path; the padded model's null outputs beyond the real
    masked tokens are not scored."""
    xm = imagenet_normalize(x, temporal_dim=2) if normalize_inputs else x
    pred = model(xm, mask, x_context, mask_context, n_vis, n_vis_context)
    ps = (model.main.tubelet_size,) + tuple(model.main.patch_size)
    target = patchify(xm.transpose(1, 2), ps, temporal_dim=1)
    if normalize_targets:
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + eps)
    target_masked = take_tokens(target, mask_order(mask)[:, n_vis:])
    n_real = target_masked.shape[1]
    return ((pred[:, :n_real] - target_masked) ** 2).mean()


def make_conjoined_train_step(model: nn.Module, optimizer: Optimizer,
                              n_vis: int, n_vis_context: int, remat=True,
                              mask_fn: Optional[Callable] = None,
                              accum_steps: int = 1, **loss_kwargs):
    """Train step of a ConjoinedVMAE: step(state, x, mask, x_context,
    mask_context) -> (state, metrics), in place on a state whose model is
    ``model``; the inputs move to the model's device. With mask_fn (``(generator, batch_size) -> (mask,
    mask_context)``) the step takes (state, x, x_context, generator)."""
    def loss(m, x, mask, xc, mc):
        return conjoined_prediction_loss(m, x, mask, xc, mc, n_vis,
                                         n_vis_context, **loss_kwargs)
    loss_fn = apply_remat(loss, remat)

    def train_step(state: TrainState, x, mask, xc, mc):
        _check_model(state, model)
        return _update(state, optimizer, loss_fn, accum_steps,
                       _on(model.device, x, mask, xc, mc))

    if mask_fn is None:
        return train_step

    def train_step_keyed(state: TrainState, x, xc,
                         generator: torch.Generator):
        mask, mc = mask_fn(generator, x.shape[0])
        return train_step(state, x, mask, xc, mc)

    return train_step_keyed


# ---------------------------------------------------------------------------
# The sharded steps over a mesh {'dp': d} or {'dp': d, 'tp': t}
# ---------------------------------------------------------------------------

def data_parallel(mesh) -> BatchSharding:
    """The batch split over the mesh's axis 'dp' (JAX's data_sharding): the
    tp ranks of one dp coordinate hold the same rows. Raises ValueError
    for a mesh without 'dp'."""
    names = mesh.mesh_dim_names
    if 'dp' not in names:
        raise ValueError(f"the mesh {names} has no axis 'dp'")
    return BatchSharding(mesh, 'dp')


class _ShardedOptimizer:
    """``optimizer`` with the gradients averaged over the dp axis first
    (one all_reduce of the gradients flattened, within the dp group of this
    rank's tp coordinate) and, under tensor parallelism, the clipping norm
    of the whole model: the same bits on every rank of a tp group."""

    def __init__(self, optimizer: Optimizer, dp: BatchSharding):
        self.optimizer, self.dp = optimizer, dp
        self.plan = None        # the model's tp plan, set by shard_state

    def update(self, opt, params, step: int):
        grads = [p.grad for p in params]
        self.dp.mean_(grads)
        gnorm = None if self.plan is None else tp_global_norm(
            grads, [getattr(p, 'tp_split', None) for p in params], self.plan)
        return self.optimizer.update(opt, params, step, gnorm)


def _shard_state(mesh, opt: _ShardedOptimizer, rules=VMAE_PARTITION_RULES):
    """shard_state(state): every rank takes the mesh's first rank's
    parameters, buffers, optimizer moments and step count, in place; with
    an axis 'tp', each rank then keeps its shard of the split parameters
    and of their moments (mesh.shard_params, opt_state_shardings), and
    ``opt`` clips by the tp-aware norm."""
    def shard_state(state: TrainState) -> TrainState:
        replicate(state.model, mesh)
        opt_state = state.opt_state
        replicate_tensors_(
            [v for g in opt_state.param_groups for p in g['params']
             for _, v in sorted(opt_state.state.get(p, {}).items())
             if isinstance(v, torch.Tensor)], mesh)
        step = torch.tensor([state.step], dtype=torch.long)
        replicate_tensors_([step], mesh)
        state.step = int(step)
        if 'tp' in mesh.mesh_dim_names:
            shard_params(state.model, mesh, rules)
            shard_optimizer_state_(opt_state, state.model)
            opt.plan = state.model.tp_plan
        return state
    return shard_state


def _dp_step(step: Callable, dp: BatchSharding,
             mask_fn: Optional[Callable] = None,
             arrange: Callable = lambda inputs, masks: (*inputs, *masks)):
    """``step(state, *batch)`` on this rank's share of the batch, with the
    loss (and aux) averaged over the axis for the metrics. With mask_fn the
    returned step takes (state, *inputs, generator): every rank draws the
    global batch's masks from its generator (seeded alike on every rank)
    and keeps its rows; ``arrange(inputs, masks)`` orders the step's
    arguments."""
    def averaged(state, *batch):
        state, metrics = step(state, *batch)
        dp.mean_([v for k, v in metrics.items() if k != 'grad_norm'])
        return state, metrics

    if mask_fn is None:
        return averaged

    def keyed(state, *args):
        *inputs, generator = args
        masks = mask_fn(generator, inputs[0].shape[0] * dp.size)
        masks = masks if isinstance(masks, tuple) else (masks,)
        return averaged(state, *arrange(inputs,
                                        [dp.local(m) for m in masks]))
    return keyed


def make_sharded_train_step(model: PretrainVisionTransformer,
                            optimizer: Optimizer, mesh, n_vis: int,
                            remat=True, mask_fn: Optional[Callable] = None,
                            accum_steps: int = 1, device='cuda',
                            **loss_kwargs):
    """The VMAE step over the mesh {'dp': d} or {'dp': d, 'tp': t}.
    Returns (step, shard_state, data_sharding): ``step(state, x, mask)``
    (with mask_fn ``step(state, x, generator)``) takes this rank's rows of
    the batch, ``shard_state(state)`` gives every rank the first rank's
    state and, with 'tp', keeps this rank's shard of it per
    VMAE_PARTITION_RULES, and
    ``data_sharding`` (a BatchSharding) says which rows are this rank's.
    The result on every rank is the single-process step on the global
    batch."""
    dp = data_parallel(mesh)
    opt = _ShardedOptimizer(optimizer, dp)
    step = make_train_step(model, opt, n_vis, remat=remat,
                           accum_steps=accum_steps, device=device,
                           **loss_kwargs)
    return _dp_step(step, dp, mask_fn), _shard_state(mesh, opt), dp


def make_sharded_cmae_train_step(model: nn.Module, optimizer: Optimizer,
                                 mesh, n_vis: int, group_masked_counts,
                                 remat=True,
                                 mask_fn: Optional[Callable] = None,
                                 accum_steps: int = 1):
    """The ChannelMAE step over 'dp' (and 'tp': its blocks are the
    VMAE's), as make_sharded_train_step: (step, shard_state,
    data_sharding)."""
    dp = data_parallel(mesh)
    opt = _ShardedOptimizer(optimizer, dp)
    step = make_cmae_train_step(model, opt, n_vis, group_masked_counts,
                                remat=remat, accum_steps=accum_steps)
    return _dp_step(step, dp, mask_fn), _shard_state(mesh, opt), dp


def make_sharded_conjoined_train_step(model: nn.Module, optimizer: Optimizer,
                                      mesh, n_vis: int, n_vis_context: int,
                                      remat=True,
                                      mask_fn: Optional[Callable] = None,
                                      accum_steps: int = 1, **loss_kwargs):
    """The conjoined step over 'dp' (and 'tp', per
    CONJOINED_PARTITION_RULES): step(state, x, mask,
    x_context, mask_context), with mask_fn step(state, x, x_context,
    generator); (step, shard_state, data_sharding)."""
    dp = data_parallel(mesh)
    opt = _ShardedOptimizer(optimizer, dp)
    step = make_conjoined_train_step(
        model, opt, n_vis, n_vis_context, remat=remat,
        accum_steps=accum_steps, **loss_kwargs)
    return (_dp_step(step, dp, mask_fn,
                     lambda ins, ms: (ins[0], ms[0], ins[1], ms[1])),
            _shard_state(mesh, opt, CONJOINED_PARTITION_RULES), dp)
