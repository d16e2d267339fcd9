"""Device meshes over the ranks of a torch.distributed process group.

Port of counterfactualworldmodels_tpu/parallel/mesh.py, the data- and
sample-parallel part. JAX runs one controller over every local device and
lets XLA insert the collectives from shardings; PyTorch runs one process per
card (``torchrun``), so a mesh here is a ``DeviceMesh`` over the ranks of
the process group, and the wrappers that use it (training/train.py's
sharded steps, parallel/inference.py, parallel/covariance.py) call the
collectives themselves. ``BatchSharding`` is the counterpart of
``NamedSharding(mesh, P(axis))`` on the leading axis: rank r of the axis
holds the contiguous block r of rows.

Tensor parallelism (an axis ``tp`` of size > 1, the partition rules)
belongs to the model-sharding slice and raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

TP_SLICE = ('tensor parallelism (tp > 1) is not ported yet: it comes with '
            'the model-sharding slice (ROADMAP.md, queue 1)')


def _device_type() -> str:
    """'cuda' for an NCCL process group, 'cpu' for gloo (which also takes
    CUDA tensors)."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def make_mesh(axis_sizes: Dict[str, int]) -> DeviceMesh:
    """A named mesh over every rank of the process group, ranks laid out
    row-major, e.g. make_mesh({'dp': 4}) or make_mesh({'dp': 2, 'tp': 1}).
    The axis sizes must multiply to the world size (one process per card);
    an axis ``tp`` of size > 1 raises ValueError."""
    if axis_sizes.get('tp', 1) > 1:
        raise ValueError(TP_SLICE)
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
