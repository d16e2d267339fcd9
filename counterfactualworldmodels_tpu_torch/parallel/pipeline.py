"""Pipeline parallelism for the VMAE encoder stack: GPipe over a mesh axis.

Port of counterfactualworldmodels_tpu/parallel/pipeline.py. The L encoder
blocks split into S = the axis size contiguous stages, one per rank; M
microbatches flow stage to stage by point-to-point send / recv, and after
M + S - 1 ticks the last stage's outputs are broadcast to every rank of
the axis (JAX's closing psum). The JAX package calls pp only as a forward
(no trainer uses it), and so does the port: where autograd would record the
inputs it raises, as the lookup kernel does.

A gloo group sends host tensors only, so over gloo a card's activations go
through the host; NCCL sends them from the card.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_rank, axis_size
from .tensor import (refuse_grad, run_layers, stack_block_params,
                     template_block, unstack_block_params)

__all__ = ['stack_block_params', 'unstack_block_params', 'pipelined_blocks',
           'make_pp_encoder_forward']


def _via_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == 'gloo'


def _send(t: torch.Tensor, dst: int, group) -> None:
    dist.send(t.cpu() if _via_host(t) else t.contiguous(), dst, group=group)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = torch.empty_like(like, device='cpu') if _via_host(like) \
        else torch.empty_like(like)
    dist.recv(buf, src, group=group)
    return buf.to(like.device)


def pipelined_blocks(stacked_params: Dict[str, torch.Tensor],
                     x: torch.Tensor, mesh: DeviceMesh, block: nn.Module,
                     num_microbatches: int, axis: str = 'pp'
                     ) -> torch.Tensor:
    """Run a layer-stacked block stack over ``x`` [B, N, D] (the same on
    every rank) pipeline-parallel over ``axis``. ``stacked_params`` holds
    this stage's contiguous L/S layers ([L/S, ...] tensors, as
    make_pp_encoder_forward's shard_params cuts them); ``block`` runs one
    layer on them (``torch.func.functional_call``). B must be divisible by
    num_microbatches. Returns [B, N, D] on every rank, the sequential
    stack's."""
    refuse_grad('pipelined_blocks', x, *stacked_params.values())
    s = axis_size(mesh, axis)
    rank = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    b, n, d = x.shape
    m = num_microbatches
    if b % m:
        raise ValueError(f'{b} rows do not split into {m} microbatches')
    xs = x.reshape(m, b // m, n, d)
    out = torch.empty_like(xs)
    for t in range(m + s - 1):
        i = t - rank                  # the microbatch at this stage now
        if not 0 <= i < m:
            continue
        h = xs[i] if rank == 0 else _recv(xs[0], ranks[rank - 1], group)
        y = run_layers(block, stacked_params, h)
        if rank == s - 1:
            out[i] = y
        else:
            _send(y, ranks[rank + 1], group)
    # the outputs live on the last stage; every rank gets them
    if _via_host(out):
        host = out.cpu()
        dist.broadcast(host, ranks[-1], group=group)
        out = host.to(x.device)
    else:
        dist.broadcast(out, ranks[-1], group=group)
    return out.reshape(b, n, d)


def make_pp_encoder_forward(model, mesh: DeviceMesh,
                            num_microbatches: int = 4, axis: str = 'pp'):
    """Returns (forward(stacked_params, tokens), shard_params(encoder_sd))
    for a pipeline-parallel encoder block stack of ``model`` (a
    PretrainVisionTransformer configuration). ``forward`` runs the blocks
    on pre-embedded tokens [B, N, D]; shard_params stacks the encoder's
    blocks and keeps this stage's contiguous layers (L must be divisible by
    the axis size)."""
    depth = model.encoder_depth
    s = axis_size(mesh, axis)
    if depth % s:
        raise ValueError(f'{depth} layers do not split into {s} stages')

    def shard_params(encoder_params):
        stacked = stack_block_params(encoder_params, depth)
        per = depth // s
        r = axis_rank(mesh, axis)
        return {k: v[r * per:(r + 1) * per] for k, v in stacked.items()}

    def forward(stacked_params, tokens):
        block = template_block(stacked_params, model.encoder_embed_dim,
                               model.encoder_num_heads, model.qk_scale,
                               model.dtype)
        return pipelined_blocks(stacked_params, tokens, mesh, block,
                                num_microbatches, axis)

    return forward, shard_params
