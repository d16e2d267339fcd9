"""Sequence parallelism for the VMAE encoder stack: the token axis split
over a mesh axis.

Port of counterfactualworldmodels_tpu/parallel/sequence.py. LayerNorm, the
qkv / proj projections and the MLP act per token (fully local); attention
all-gathers K and V over the axis, so each rank attends its N/sp local
queries against the full sequence. On the card that is ops/flash_attention
with Nq = N/sp and Nk = N (K1 forward; K5/K6 with a gradient), never SDPA.
Like the JAX package, which calls it only as a forward, the port's stack
is a forward: where autograd would record its inputs it raises (a plain
all_gather has no backward, and the replicated parameters' gradients would
need a sum over the axis).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.layers import Attention, dense
from .mesh import BatchSharding
from .tensor import (refuse_grad, run_layers, stack_block_params,
                     template_block)


class SequenceParallelAttention(Attention):
    """layers.Attention on this rank's tokens, against every rank's keys
    and values."""

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.heads(x)
        sp = self.sp
        k, v = sp.gather(k, dim=2), sp.gather(v, dim=2)
        out = self.attend(q, k, v).transpose(1, 2).reshape(b, n, -1)
        return dense(out, self.proj, self.dtype)


def sequence_parallel_blocks(stacked_params: Dict[str, torch.Tensor],
                             x: torch.Tensor, mesh: DeviceMesh,
                             num_heads: int, axis: str = 'sp', qk_scale=None
                             ) -> torch.Tensor:
    """Run a layer-stacked block stack over ``x`` [B, N, D] (the same on
    every rank) with the token axis split over ``axis``: each rank runs its
    N/sp tokens, and the output, gathered, is the sequential stack's on
    every rank (the layerscale gammas and a custom ``qk_scale`` included).
    N must be divisible by the axis size (ValueError). It computes in x's
    dtype; RuntimeError where autograd would record the inputs."""
    refuse_grad('sequence_parallel_blocks', x, *stacked_params.values())
    sp = BatchSharding(mesh, axis)
    x_local = sp.local(x, dim=1)
    block = template_block(stacked_params, x.shape[-1], num_heads, qk_scale,
                           x.dtype)
    block.attn.__class__ = SequenceParallelAttention
    block.attn.sp = sp
    return sp.gather(run_layers(block, stacked_params, x_local), dim=1)


def make_sp_encoder_forward(model, mesh: DeviceMesh, axis: str = 'sp'):
    """Returns (forward(stacked_params, tokens), shard_params(encoder_sd))
    for a sequence-parallel encoder block stack of ``model`` (a
    PretrainVisionTransformer configuration); the parameters are
    replicated, so shard_params only stacks the blocks."""
    depth = model.encoder_depth
    num_heads = model.encoder_num_heads

    def shard_params(encoder_params):
        return stack_block_params(encoder_params, depth)

    def forward(stacked_params, tokens):
        return sequence_parallel_blocks(stacked_params, tokens, mesh,
                                        num_heads, axis, model.qk_scale)

    return forward, shard_params
