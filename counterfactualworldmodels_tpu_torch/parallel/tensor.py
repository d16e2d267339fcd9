"""Tensor parallelism over the mesh axis 'tp': head-parallel attention and
column/row-parallel MLPs, Megatron's recipe, one process per card.

Port of counterfactualworldmodels_tpu/parallel/tensor.py and of what JAX's
jit does with mesh.VMAE_PARTITION_RULES / CONJOINED_PARTITION_RULES. Every
rank of the axis holds a head-aligned shard of the qkv / proj / fc weights
(parallel/mesh.py's Split) and runs attention over its local heads with no
communication; the collectives are Megatron's two autograd Functions:

- ``copy_to_tp``: identity forward, all-reduce over the tp group backward,
  on the input of every column-parallel projection (qkv, fc1, the cross
  blocks' values);
- ``reduce_from_tp``: all-reduce forward, identity backward, on the output
  of every row-parallel one (proj, fc2, the cross blocks' projections),
  whose replicated bias is added once, after the reduction.

The backward all-reduce is what gives the replicated parameters (norms,
embeddings, row-parallel biases, the layerscale gammas) the same, full
gradient on every tp rank; a forward-only all-reduce would leave each rank
the gradient of its own heads only. The cross blocks' packed qk weights
stay replicated (JAX's rules): they compute every head on every rank, and
the heads' q/k pass ``copy_to_tp`` before each rank takes its own, so their
weight's gradient is the full one too.

``shard_params`` (parallel/mesh.py) turns a model tensor-parallel in
place: ``parallelize_`` keeps each rank's shard of the split parameters and
swaps each split module's class for its tensor-parallel subclass here.
``tensor_parallel_blocks`` and ``make_tp_encoder_forward`` are the JAX
package's explicit head-parallel encoder stack on layer-stacked state
dicts; on the card their attention is ops/flash_attention (K1 forward, K5/K6
with a gradient), never SDPA.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.layers import Attention, Block, Mlp, dense
from ..models.transformer import (BidirectionalCrossAttention, GenericMlp,
                                  _heads)
from .mesh import (VMAE_PARTITION_RULES, Split, axis_rank, axis_size,
                   opt_state_shardings, partition_spec_for)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient to another input
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel projection."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of the row-parallel partial outputs."""
    return _ReduceFromTP.apply(x, group)


def row_parallel(x, layer: nn.Linear, dtype, group) -> torch.Tensor:
    """flax ``nn.Dense(dtype)`` of a row-parallel Linear: this rank's input
    slice times its weight slice, summed over the group, then the
    (replicated) bias added once."""
    y = reduce_from_tp(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return y if layer.bias is None else y + layer.bias.to(dtype)


# ---------------------------------------------------------------------------
# the tensor-parallel modules (the split modules' classes after parallelize_)
# ---------------------------------------------------------------------------

class TensorParallelAttention(Attention):
    """layers.Attention over this rank's ``num_heads`` heads: qkv column-
    and proj row-parallel."""

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.heads(copy_to_tp(x, self.tp_group))
        out = self.attend(q, k, v).transpose(1, 2).reshape(b, n, -1)
        return row_parallel(out, self.proj, self.dtype, self.tp_group)


class TensorParallelMlp(Mlp):
    """layers.Mlp over this rank's hidden units: fc1 column-, fc2
    row-parallel."""

    def forward(self, x):
        h = F.gelu(dense(copy_to_tp(x, self.tp_group), self.fc1, self.dtype),
                   approximate='none')
        return row_parallel(h, self.fc2, self.dtype, self.tp_group)


class TensorParallelGenericMlp(GenericMlp):
    """transformer.GenericMlp (the cross blocks' MLPs) over this rank's
    hidden units."""

    def forward(self, x):
        h = F.gelu(dense(copy_to_tp(x, self.tp_group), self.layers[0],
                         self.dtype), approximate='none')
        return row_parallel(h, self.layers[2], self.dtype, self.tp_group)


class TensorParallelCrossAttention(BidirectionalCrossAttention):
    """transformer.BidirectionalCrossAttention over this rank's heads: the
    values (v, v_src) column- and the projections row-parallel; qk and
    qk_src replicated, each rank taking its heads of them."""

    def forward(self, x, src):
        dt, h, d, g = self.dtype, self.num_heads, self.head_dim, self.tp_group
        b, n, _ = x.shape
        m = src.shape[1]
        heads = slice(self.tp_rank * h, (self.tp_rank + 1) * h)
        n_all = h * self.tp_size
        qk = copy_to_tp(_heads(dense(x, self.qk, dt), b, n, n_all, 2 * d),
                        g)[:, heads]
        qk_src = copy_to_tp(_heads(dense(src, self.qk_src, dt), b, m, n_all,
                                   2 * d), g)[:, heads]
        v = _heads(dense(copy_to_tp(x, g), self.v, dt), b, n, h, d)
        v_src = _heads(dense(copy_to_tp(src, g), self.v_src, dt), b, m, h, d)
        y, y_src = self.exchange(qk, qk_src, v, v_src)
        return (row_parallel(y, self.projection, dt, g),
                row_parallel(y_src, self.projection_src, dt, g))


# the modules a plan splits, each with its tensor-parallel class
TP_CLASSES = {Attention: TensorParallelAttention, Mlp: TensorParallelMlp,
              GenericMlp: TensorParallelGenericMlp,
              BidirectionalCrossAttention: TensorParallelCrossAttention}


def split_units(model: nn.Module):
    """(name, module, head count or None) of every module of ``model`` that
    tensor parallelism splits as a whole."""
    for name, m in model.named_modules():
        if type(m) in TP_CLASSES:
            yield name, m, getattr(m, 'num_heads', None)


@dataclasses.dataclass
class TensorParallelPlan:
    """How a model is split: the tp group, its size, this rank's coordinate
    and every parameter's Split (None: replicated)."""
    group: object
    size: int
    rank: int
    specs: Dict[str, Optional[Split]]


def parallelize_(model: nn.Module, mesh: DeviceMesh,
                 specs: Dict[str, Optional[Split]]) -> nn.Module:
    """Keep this rank's shard of each split parameter (in place: the
    parameter objects stay, so an optimizer bound to them keeps them) and
    make each split module tensor-parallel. Records the plan as
    ``model.tp_plan``."""
    if getattr(model, 'tp_plan', None) is not None:
        raise ValueError('the model is tensor-parallel already')
    plan = TensorParallelPlan(mesh.get_group('tp'), axis_size(mesh, 'tp'),
                              axis_rank(mesh, 'tp'), dict(specs))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for prefix, unit, heads in split_units(model):
            members = [n for n in params if n.startswith(prefix + '.')]
            if not any(specs.get(n) for n in members):
                continue
            for n in members:
                split = specs.get(n)
                if split is not None:
                    p = params[n]
                    p.data = split.local(p.data, plan.size, plan.rank)
                    p.tp_split = split
            unit.__class__ = TP_CLASSES[type(unit)]
            unit.tp_group, unit.tp_size, unit.tp_rank = (plan.group, plan.size,
                                                         plan.rank)
            if heads is not None:
                unit.num_heads = heads // plan.size
    model.tp_plan = plan
    return model


def shard_optimizer_state_(opt: torch.optim.Optimizer,
                           model: nn.Module) -> None:
    """Keep this rank's shard of each moment of a split parameter, in
    place (``opt`` is bound to ``model``'s parameters, sharded by
    ``parallelize_`` after the moments were made at full size)."""
    plan = model.tp_plan
    splits = opt_state_shardings(opt, model)
    params = [p for g in opt.param_groups for p in g['params']]
    for i, p in enumerate(params):
        st = opt.state.get(p)
        if splits[i] is None or not st:
            continue
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                st[k] = splits[i].local(v, plan.size, plan.rank)


def gather_split(t: torch.Tensor, split: Split, plan: TensorParallelPlan
                 ) -> torch.Tensor:
    """The full tensor of which every rank of the plan's group holds the
    block ``t`` (an all_gather: every rank of the group calls it)."""
    blocks = [torch.empty_like(t) for _ in range(plan.size)]
    dist.all_gather(blocks, t.contiguous(), group=plan.group)
    return split.full(blocks)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's reference-layout state dict at full size: the split
    parameters gathered over the tp group (every rank of it calls this),
    the rest as they are."""
    sd = model.state_dict()
    plan = getattr(model, 'tp_plan', None)
    if plan is None:
        return sd
    return {k: gather_split(v, plan.specs[k], plan) if plan.specs.get(k)
            else v for k, v in sd.items()}


def full_optimizer_state_dict(opt: torch.optim.Optimizer,
                              model: nn.Module) -> Dict:
    """``opt.state_dict()`` with the moments of split parameters gathered
    to full size (every rank of the tp group calls this); the optimizer's
    own state is untouched."""
    sd = opt.state_dict()
    plan = getattr(model, 'tp_plan', None)
    if plan is None:
        return sd
    splits = opt_state_shardings(opt, model)
    state = {}
    for i in sorted(sd['state']):
        split = splits.get(i)
        state[i] = {k: gather_split(v, split, plan) if (
            split is not None and torch.is_tensor(v) and v.dim() > 0)
            else v for k, v in sd['state'][i].items()}
    return dict(sd, state=state)


def tp_global_norm(grads, splits, plan: Optional[TensorParallelPlan]
                   ) -> torch.Tensor:
    """optax.global_norm of gradients of which some are tp shards: each
    split gradient's squared norm summed over the tp group, each
    replicated one counted once. With no plan, or a group of one, it is
    ``training.train.global_norm`` bit for bit."""
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    split = [i for i, s in enumerate(splits) if s is not None]
    if plan is not None and plan.size > 1 and split:
        sq = torch.stack([norms[i] for i in split]) ** 2
        dist.all_reduce(sq, group=plan.group)
        for j, full in zip(split, sq.sqrt()):
            norms[j] = full
    return torch.linalg.vector_norm(torch.stack(norms))


# ---------------------------------------------------------------------------
# the explicit encoder stacks on layer-stacked state dicts
# ---------------------------------------------------------------------------

def stack_block_params(encoder_params: Dict[str, torch.Tensor], depth: int
                       ) -> Dict[str, torch.Tensor]:
    """Stack ``blocks.0 .. blocks.{depth-1}`` of an encoder's state dict
    into [L, ...] tensors keyed by the block's own names (e.g.
    ``attn.qkv.weight``)."""
    keys = [k[len('blocks.0.'):] for k in encoder_params
            if k.startswith('blocks.0.')]
    return {k: torch.stack([encoder_params[f'blocks.{i}.{k}']
                            for i in range(depth)]) for k in keys}


def unstack_block_params(stacked: Dict[str, torch.Tensor], depth: int
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of stack_block_params: ``blocks.{i}.<name>`` entries."""
    return {f'blocks.{i}.{k}': v[i] for i in range(depth)
            for k, v in stacked.items()}


def refuse_grad(what: str, *tensors) -> None:
    """The forward-only stacks raise where autograd would record their
    inputs, rather than return what autograd would treat as constant."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f'{what} is a forward: call it under '
                           'torch.no_grad() or on tensors that do not '
                           'require grad')


def template_block(stacked: Dict[str, torch.Tensor], dim: int,
                   num_heads: int, qk_scale=None, dtype=torch.float32
                   ) -> Block:
    """A layers.Block without storage (on the meta device) whose
    parameters each layer of ``stacked`` supplies through
    ``torch.func.functional_call``; its attention runs ops/flash_attention
    (the kernels on the card, their plain versions on the CPU)."""
    return Block(dim, num_heads, 4.0, 'attn.q_bias' in stacked, qk_scale,
                 1.0 if 'gamma_1' in stacked else None, dtype=dtype,
                 attn_impl='flash', device='meta')


def run_layers(block: nn.Module, stacked: Dict[str, torch.Tensor], x):
    """x through each layer of ``stacked`` in turn, on ``block``."""
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        x = torch.func.functional_call(
            block, {k: v[i] for k, v in stacked.items()}, (x,))
    return x


def _split_stacked(stacked, tp: int, rank: int, rules):
    out = {}
    for k, v in stacked.items():
        split = partition_spec_for(k, rules)
        out[k] = v if split is None else split.stacked().local(v, tp, rank)
    return out


def tensor_parallel_blocks(stacked_params: Dict[str, torch.Tensor],
                           x: torch.Tensor, mesh: DeviceMesh, num_heads: int,
                           axis: str = 'tp', qk_scale=None) -> torch.Tensor:
    """Run a layer-stacked block stack over ``x`` [B, N, D] (the same on
    every rank) with attention heads and MLP hidden units split over
    ``axis``; ``stacked_params`` holds this rank's shards (as
    make_tp_encoder_forward's shard_params cuts them). num_heads must be
    divisible by the axis size (head-aligned shards): ValueError
    otherwise. It computes in x's dtype; the output, on every rank, is the
    sequential stack's."""
    tp = axis_size(mesh, axis)
    d = x.shape[-1]
    if num_heads % tp:
        raise ValueError(f'num_heads={num_heads} not divisible by '
                         f'{axis}={tp}: cannot head-align the shards')
    if stacked_params['attn.qkv.weight'].shape[1] * tp != 3 * d:
        raise ValueError(f'the stacked qkv {tuple(stacked_params["attn.qkv.weight"].shape)} '
                         f'is not this rank\'s shard of width {d} over {tp}')
    group = mesh.get_group(axis)
    block = template_block(stacked_params, d, num_heads, qk_scale, x.dtype)
    for unit in (block.attn, block.mlp):
        unit.__class__ = TP_CLASSES[type(unit)]
        unit.tp_group, unit.tp_size = group, tp
        unit.tp_rank = axis_rank(mesh, axis)
    block.attn.num_heads = num_heads // tp
    return run_layers(block, stacked_params, x)


def make_tp_encoder_forward(model, mesh: DeviceMesh, axis: str = 'tp'):
    """Returns (forward(stacked_params, tokens), shard_params(encoder_sd))
    for a head-parallel encoder block stack of ``model`` (a
    PretrainVisionTransformer configuration). ``encoder_sd`` is the
    encoder's state dict (``blocks.{i}.…`` keys); shard_params stacks its
    blocks and keeps this rank's shards per mesh.VMAE_PARTITION_RULES."""
    depth = model.encoder_depth
    num_heads = model.encoder_num_heads
    tp = axis_size(mesh, axis)
    if num_heads % tp:
        raise ValueError(f'num_heads={num_heads} not divisible by '
                         f'{axis}={tp}: cannot head-align the shards')

    def shard_params(encoder_params):
        return _split_stacked(stack_block_params(encoder_params, depth), tp,
                              axis_rank(mesh, axis), VMAE_PARTITION_RULES)

    def forward(stacked_params, tokens):
        return tensor_parallel_blocks(stacked_params, tokens, mesh,
                                      num_heads, axis, model.qk_scale)

    return forward, shard_params
