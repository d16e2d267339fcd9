"""Multi-process runs: the process group, host-major meshes and per-rank
batches. Port of counterfactualworldmodels_tpu/parallel/multihost.py.

PyTorch runs one process per card, launched by ``torchrun``, which sets
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT. A rank feeds its own share of each global batch, as a JAX
process feeds its process-local batch:

    multihost.initialize_distributed()            # a no-op single-process
    mesh = multihost.make_hybrid_mesh({'dp': nodes}, {'dp_local': per_node})
    x_local = multihost.host_local_batch_to_global(mesh, 'dp', x_local,
                                                   device, global_size=B)

Unlike the JAX package, a failed initialisation raises: it is never taken
as a reason to carry on single-process.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size, make_mesh


def _backend_for(device) -> str:
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None, device='cuda',
                           timeout_s: Optional[float] = None) -> bool:
    """Bring up the default process group; returns True when there is one.

    With no arguments it reads the torchrun environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) and is a no-op (False) when nothing indicates
    a run of more than one process, so entry points call it
    unconditionally. Explicit arguments (an ``init_method`` such as
    ``tcp://localhost:29500`` or ``file:///path``, the world size and this
    rank) start a group of any size, one included. The backend follows
    ``device`` ('nccl' for CUDA, 'gloo' for the CPU) unless named. With
    LOCAL_RANK set and a CUDA device, that card becomes the current one.
    Any failure raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and int(env.get('WORLD_SIZE', '1')) <= 1:
        return False
    if init_method is None:
        init_method = 'env://'
    if world_size is None:
        world_size = int(env['WORLD_SIZE'])
    if rank is None:
        rank = int(env['RANK'])
    backend = backend or _backend_for(device)
    if torch.device(device).type == 'cuda' and 'LOCAL_RANK' in env:
        torch.cuda.set_device(int(env['LOCAL_RANK']))
    kw = {}
    if timeout_s is not None:
        kw['timeout'] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def make_hybrid_mesh(dcn_axes: Dict[str, int],
                     ici_axes: Dict[str, int]) -> DeviceMesh:
    """A mesh whose ``dcn_axes`` span hosts and whose ``ici_axes`` stay
    within one host (their collectives then ride NVLink only). torchrun
    numbers ranks host-major (rank = node * LOCAL_WORLD_SIZE + local rank),
    so the ranks laid out row-major over dcn then ici axes are that layout;
    the ici axes must hold LOCAL_WORLD_SIZE ranks. Single-process it is a
    plain mesh over the same names and sizes."""
    sizes = dict(dcn_axes, **ici_axes)
    if len(sizes) != len(dcn_axes) + len(ici_axes):
        raise ValueError(f'axis names repeat: {dcn_axes} / {ici_axes}')
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if world > 1:
        n_ici = 1
        for v in ici_axes.values():
            n_ici *= v
        if n_ici != local:
            raise ValueError(f'the within-host axes {ici_axes} hold {n_ici} '
                             f'ranks; a host runs {local}')
    return make_mesh(sizes)


def host_local_batch_to_global(mesh: DeviceMesh, axis: str, local_batch,
                               device=None,
                               global_size: Optional[int] = None
                               ) -> torch.Tensor:
    """This rank's shard of a batch split over mesh axis ``axis``, placed on
    ``device`` (the counterpart of JAX's global array assembled from
    process-local data: each rank keeps its own rows). ``global_size``,
    when given, is checked against the axis size times the local rows."""
    x = torch.as_tensor(local_batch)
    if device is not None:
        x = x.to(device)
    if global_size is not None:
        n = x.shape[0] * axis_size(mesh, axis)
        if n != global_size:
            raise ValueError(f'{x.shape[0]} local rows over the '
                             f'{axis_size(mesh, axis)} ranks of {axis!r} make '
                             f'{n}, not the global batch of {global_size}')
    return x


def process_local_batch_size(global_batch_size: int) -> int:
    """This process's share of a batch split over every rank; raises
    ValueError when the world size does not divide it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % n:
        raise ValueError(f'a batch of {global_batch_size} does not split '
                         f'over {n} processes')
    return global_batch_size // n
