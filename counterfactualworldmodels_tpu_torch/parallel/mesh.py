"""Device meshes over the ranks of a torch.distributed process group, and
the partition rules of tensor parallelism.

Port of counterfactualworldmodels_tpu/parallel/mesh.py. JAX runs one
controller over every local device and lets XLA insert the collectives from
shardings; PyTorch runs one process per card (``torchrun``), so a mesh here
is a ``DeviceMesh`` over the ranks of the process group, and the code that
uses it (training/train.py's sharded steps, parallel/tensor.py,
parallel/inference.py, parallel/covariance.py) calls the collectives
itself. ``BatchSharding`` is the counterpart of ``NamedSharding(mesh,
P(axis))`` on the leading axis: rank r of the axis holds the contiguous
block r of rows.

The partition rules map the reference-layout state-dict names (e.g.
``encoder.blocks.3.attn.qkv.weight``) to a ``Split`` over the mesh axis
'tp', or to None (replicated). They are JAX's ``VMAE_PARTITION_RULES`` and
``CONJOINED_PARTITION_RULES`` on torch's layout: a Linear weight is
[out, in] where a flax kernel is [in, out], so JAX's ``P(None, 'tp')`` on
``fc1/kernel`` is ``Split(0)`` of ``mlp.fc1.weight`` and ``P('tp', None)``
on ``proj/kernel`` is ``Split(1)`` of ``attn.proj.weight``. JAX stores qkv
as [D, 3, A] and splits A; the port keeps the fused ``qkv.weight`` [3A, D],
which it splits per third (``Split(0, thirds=True)``), so every shard is
head-aligned and inside one of q, k and v.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

def _device_type() -> str:
    """'cuda' for an NCCL process group, 'cpu' for gloo (which also takes
    CUDA tensors)."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def make_mesh(axis_sizes: Dict[str, int]) -> DeviceMesh:
    """A named mesh over every rank of the process group, ranks laid out
    row-major, e.g. make_mesh({'dp': 4}) or make_mesh({'dp': 2, 'tp': 1}).
    The axis sizes must multiply to the world size (one process per card),
    or ValueError is raised."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'parallel.initialize_distributed first')
    names = tuple(axis_sizes)
    shape = tuple(int(v) for v in axis_sizes.values())
    n = 1
    for v in shape:
        n *= v
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f'mesh {axis_sizes} has {n} ranks; the process '
                         f'group has {world}')
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def sample_parallel_mesh(n: Optional[int] = None) -> DeviceMesh:
    """1-D mesh over the counterfactual sample axis ('samples'), of every
    rank by default."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh({'samples': n or world})


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading axis split over the mesh axis ``axis``: rank r holds the
    contiguous rows [r*b, (r+1)*b) of a global batch of size*b rows
    (JAX's ``NamedSharding(mesh, P(axis))``)."""
    mesh: DeviceMesh
    axis: str

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.axis)

    @property
    def rank(self) -> int:
        return axis_rank(self.mesh, self.axis)

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim``; raises ValueError when
        the axis does not divide it."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f'{n} rows do not split over the {self.size} '
                             f'ranks of mesh axis {self.axis!r}')
        b = n // self.size
        return x.narrow(dim, self.rank * b, b)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of the axis, concatenated in rank order
        along ``dim`` (an all_gather; bool tensors travel as uint8)."""
        if self.size == 1:
            return x
        src = x.to(torch.uint8) if x.dtype == torch.bool else x
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def mean_(self, tensors) -> None:
        """All-reduce the mean over the axis, in place: one collective per
        dtype over the tensors flattened (the rank order of the sum is the
        collective's; every rank gets the same bits)."""
        tensors = list(tensors)
        if self.size == 1 or not tensors:
            return
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def _broadcast_(t: torch.Tensor, src: int) -> None:
    """Broadcast ``t`` in place from global rank ``src``; NCCL takes only
    CUDA tensors, so a host tensor travels through the card there."""
    if dist.get_backend() == 'nccl' and not t.is_cuda:
        tmp = t.cuda()
        dist.broadcast(tmp, src)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src)


def replicate(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Give every rank of the mesh the parameters and buffers of the
    mesh's first rank (broadcasts, in the module's order). Returns the
    module."""
    src = int(mesh.mesh.reshape(-1)[0])
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            _broadcast_(t.data, src)
    return module


def replicate_tensors_(tensors, mesh: DeviceMesh) -> None:
    """Broadcast each tensor in place from the mesh's first rank."""
    src = int(mesh.mesh.reshape(-1)[0])
    for t in tensors:
        _broadcast_(t, src)


# ---------------------------------------------------------------------------
# Tensor parallelism: the partition rules and the shardings they give
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A tensor split over the mesh axis 'tp' (a JAX PartitionSpec with
    'tp' on one dim): rank r of tp holds block r of dim ``dim``. With
    ``thirds``, block r of each third of that dim: the fused qkv weight
    [3A, D] keeps rows [t*A + r*A/tp, t*A + (r+1)*A/tp) for t = 0, 1, 2."""
    dim: int
    thirds: bool = False

    def divides(self, shape, tp: int) -> bool:
        if self.dim >= len(shape):
            return False
        n = shape[self.dim]
        if self.thirds:
            return n % 3 == 0 and (n // 3) % tp == 0
        return n % tp == 0

    def local(self, t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
        """Rank ``rank``'s block of the full tensor ``t`` (a copy)."""
        n = t.shape[self.dim]
        if not self.thirds:
            b = n // tp
            return t.narrow(self.dim, rank * b, b).clone()
        a = n // 3
        b = a // tp
        return torch.cat([t.narrow(self.dim, k * a + rank * b, b)
                          for k in range(3)], self.dim)

    def full(self, blocks) -> torch.Tensor:
        """The full tensor from every rank's block, in rank order."""
        if not self.thirds:
            return torch.cat(list(blocks), self.dim)
        thirds = [b.chunk(3, self.dim) for b in blocks]
        return torch.cat([torch.cat([t[k] for t in thirds], self.dim)
                          for k in range(3)], self.dim)

    def stacked(self) -> 'Split':
        """The same split of a tensor with a leading layer axis."""
        return Split(self.dim + 1, self.thirds)


# The VMAE family (and the ChannelMAE, whose blocks are the same): heads of
# the attention and the hidden units of the MLP split over tp, Megatron's
# column-parallel qkv / fc1 and row-parallel proj / fc2. The row-parallel
# layers' biases are replicated and added once, after the reduction.
VMAE_PARTITION_RULES: Sequence[Tuple[str, Optional[Split]]] = (
    (r'.*attn\.qkv\.weight$', Split(0, thirds=True)),
    (r'.*attn\.(q_bias|v_bias)$', Split(0)),
    (r'.*attn\.proj\.weight$', Split(1)),
    (r'.*attn\.proj\.bias$', None),
    (r'.*mlp\.fc1\.weight$', Split(0)),
    (r'.*mlp\.fc1\.bias$', Split(0)),
    (r'.*mlp\.fc2\.weight$', Split(1)),
    (r'.*mlp\.fc2\.bias$', None),
    # everything else replicated
    (r'.*', None),
)

# The conjoined family: the streams' blocks take the VMAE rules; the cross
# blocks (models/transformer.BidirectionalCrossAttention) split the values
# over heads, the projections over their input and the MLPs over the
# hidden dim. The packed qk weights stay replicated, as in JAX: a shard
# would straddle the q|k boundary. The cross blocks' self-attention
# (``self_attention.{trg,src}``) matches no rule and is replicated, as it is
# under JAX's rules.
CONJOINED_PARTITION_RULES: Sequence[Tuple[str, Optional[Split]]] = (
    (r'.*cross_attention\.qk(_src)?\.weight$', None),
    (r'.*cross_attention\.v(_src)?\.weight$', Split(0)),
    (r'.*cross_attention\.projection(_src)?\.weight$', Split(1)),
    (r'.*cross_attention\.projection(_src)?\.bias$', None),
    (r'.*mlp\.(trg|src)\.layers\.0\.weight$', Split(0)),
    (r'.*mlp\.(trg|src)\.layers\.0\.bias$', Split(0)),
    (r'.*mlp\.(trg|src)\.layers\.2\.weight$', Split(1)),
) + tuple(VMAE_PARTITION_RULES)


def partition_spec_for(name: str, rules=VMAE_PARTITION_RULES
                       ) -> Optional[Split]:
    """The first rule matching the state-dict name ``name``: a Split, or
    None (replicated)."""
    for pattern, spec in rules:
        if re.match(pattern, name):
            return spec
    return None


def param_shardings(model: torch.nn.Module, mesh: DeviceMesh,
                    rules=VMAE_PARTITION_RULES) -> Dict[str, Optional[Split]]:
    """{parameter name: Split or None} for every parameter of ``model``
    under ``rules`` on ``mesh`` (JAX's param_shardings).

    A mesh without an axis 'tp' replicates everything. The port splits a
    module (a block's attention, a block's MLP, a cross block's attention
    or one of its MLPs) as a whole, since half of a layer's weights cannot
    be split without a gather: where tp does not divide one of the
    module's split dims, or its head count, the module stays replicated,
    with JAX's warning."""
    from .tensor import split_units
    names = mesh.mesh_dim_names
    tp = axis_size(mesh, 'tp') if 'tp' in names else None
    specs = {n: (partition_spec_for(n, rules) if tp else None)
             for n, _ in model.named_parameters()}
    params = dict(model.named_parameters())
    covered = set()
    for prefix, unit, heads in split_units(model):
        members = [n for n in specs if n.startswith(prefix + '.')]
        covered.update(members)
        split = {n: specs[n] for n in members if specs[n] is not None}
        if not split:
            continue
        bad = [f'dim {s.dim} of {n} {tuple(params[n].shape)}'
               for n, s in split.items() if not s.divides(params[n].shape, tp)]
        if heads is not None and heads % tp:
            bad.append(f'the {heads} heads of {prefix}')
        if bad:
            if tp > 1:
                import warnings
                warnings.warn(f'tp={tp} does not divide {"; ".join(bad)}; '
                              f'replicating {prefix} (no tensor parallelism '
                              'for it)', stacklevel=2)
            for n in members:
                specs[n] = None
    stray = [n for n, s in specs.items() if s is not None and n not in covered]
    if stray:
        raise ValueError(f'the rules split {stray}, which no tensor-parallel '
                         'module holds')
    return specs


def shard_params(model: torch.nn.Module, mesh: DeviceMesh,
                 rules=VMAE_PARTITION_RULES) -> torch.nn.Module:
    """Keep this rank's shard of every split parameter of ``model``, in
    place, and run its split modules tensor-parallel over the mesh axis
    'tp' (JAX's shard_params places the parameters per the rules). The
    module must hold the same weights on every rank of the axis. Returns
    the model, which records the shardings as ``model.tp_plan``."""
    from .tensor import parallelize_
    return parallelize_(model, mesh, param_shardings(model, mesh, rules))


def opt_state_shardings(opt: torch.optim.Optimizer, model: torch.nn.Module,
                        p_shardings: Optional[Dict[str, Optional[Split]]]
                        = None) -> Dict[int, Optional[Split]]:
    """{parameter index of ``opt.state_dict()``: Split or None}: the
    optimizer's per-parameter moments follow their parameter's sharding;
    its scalars (the step counts) are replicated. ``p_shardings`` defaults
    to the model's plan (none: every entry None)."""
    if p_shardings is None:
        plan = getattr(model, 'tp_plan', None)
        p_shardings = plan.specs if plan is not None else {}
    name_of = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in opt.param_groups for p in g['params']]
    return {i: p_shardings.get(name_of.get(id(p))) for i, p in
            enumerate(params)}
